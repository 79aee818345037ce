from watsor_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                            batch_sharding, make_mesh,
                                            param_shardings)
from watsor_tpu_torch.parallel.fleet import (FleetDetector,
                                             make_sharded_train_step,
                                             replicate)

__all__ = ["make_mesh", "param_shardings", "batch_sharding", "Mesh",
           "DATA_AXIS", "MODEL_AXIS", "FleetDetector",
           "make_sharded_train_step", "replicate"]
