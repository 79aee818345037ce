"""The JAX-free host layers of ``watsor_tpu`` that the port reuses as they
are.

Every name the port takes from the JAX package passes through this module,
except the ``Application`` class that ``watsor_tpu_torch.main`` subclasses.
None of these modules imports jax, at import or on the paths the port
calls (tests/test_torch_app.py boots the port and checks ``sys.modules``;
chip_smoke.py checks it again after driving the card).

Sources: watsor_tpu/config/coco.py, watsor_tpu/runtime/{channel,frames,
tasks,logs}.py, watsor_tpu/filters/{mask,track}.py,
watsor_tpu/detection/detector.py (``ObjectDetector``) and the numpy helpers
of watsor_tpu/detection/backend.py.
"""

from watsor_tpu.config.coco import (COCO_CLASSES, DEFAULT_AREA,
                                    DEFAULT_CONFIDENCE, coco_label_index,
                                    iter_detect_entries)
from watsor_tpu.detection.backend import (DetectorBackend, _bucket,
                                          _min_bucket_env, _refine_zones,
                                          _unpack_outputs)
from watsor_tpu.detection.detector import ObjectDetector
from watsor_tpu.filters.mask import ZoneMask, get_alpha_channel
from watsor_tpu.filters.track import TrackFilter
from watsor_tpu.runtime.channel import balanced_queue_group
from watsor_tpu.runtime.frames import MAX_ZONES, FrameBuffer, State
from watsor_tpu.runtime.logs import init_logging
from watsor_tpu.runtime.tasks import Payload

__all__ = ['COCO_CLASSES', 'DEFAULT_AREA', 'DEFAULT_CONFIDENCE',
           'DetectorBackend', 'FrameBuffer', 'MAX_ZONES', 'ObjectDetector',
           'Payload', 'State', 'TrackFilter', 'ZoneMask', '_bucket',
           '_min_bucket_env', '_refine_zones', '_unpack_outputs',
           'balanced_queue_group', 'coco_label_index', 'get_alpha_channel',
           'init_logging', 'iter_detect_entries']
