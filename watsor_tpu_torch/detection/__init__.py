from watsor_tpu_torch.detection.backend import TorchDetectorBackend
from watsor_tpu_torch.detection.detector import (create_object_detectors,
                                                 resolve_device_pool)

__all__ = ["TorchDetectorBackend", "create_object_detectors",
           "resolve_device_pool"]
