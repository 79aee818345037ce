# Copy of watsor_tpu/testing/__init__.py; only its imports differ.
from watsor_tpu_torch.testing.shapes import Artist, ShapeDetectorBackend, ShapeCounter, SHAPE_LABELS

__all__ = ["Artist", "ShapeDetectorBackend", "ShapeCounter", "SHAPE_LABELS"]
