"""Device ops of the detection main path (PyTorch, NHWC at the boundary)."""
