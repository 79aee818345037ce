"""Detection models of the port (SSD-MobileNetV2 only in this slice)."""
