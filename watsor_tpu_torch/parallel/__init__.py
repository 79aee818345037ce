from watsor_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                            batch_sharding, make_mesh)
from watsor_tpu_torch.parallel.fleet import FleetDetector, replicate

__all__ = ["make_mesh", "batch_sharding", "Mesh", "DATA_AXIS", "MODEL_AXIS",
           "FleetDetector", "replicate"]
