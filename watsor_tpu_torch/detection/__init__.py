from watsor_tpu_torch.detection.backend import (FleetBackend,
                                                TorchDetectorBackend)
from watsor_tpu_torch.detection.detector import (create_object_detectors,
                                                 resolve_device_pool)

__all__ = ["TorchDetectorBackend", "FleetBackend", "create_object_detectors",
           "resolve_device_pool"]
