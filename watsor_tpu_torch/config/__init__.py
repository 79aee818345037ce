# Copy of watsor_tpu/config/__init__.py; only its imports differ.
from watsor_tpu_torch.config.loader import parse, validate, normalize, SECRETS_YAML
from watsor_tpu_torch.config.coco import COCO_CLASSES, CocoClass, get_coco_class

__all__ = [
    "parse", "validate", "normalize", "SECRETS_YAML",
    "COCO_CLASSES", "CocoClass", "get_coco_class",
]
