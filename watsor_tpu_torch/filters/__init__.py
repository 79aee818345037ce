# Copy of watsor_tpu/filters/__init__.py; only its imports differ.
from watsor_tpu_torch.filters.static import ConfidenceFilter, AreaFilter
from watsor_tpu_torch.filters.mask import MaskFilter, ZoneMask, get_alpha_channel
from watsor_tpu_torch.filters.track import TrackFilter
from watsor_tpu_torch.filters.sieve import DetectionSieve

__all__ = ["ConfidenceFilter", "AreaFilter", "MaskFilter", "ZoneMask",
           "get_alpha_channel", "TrackFilter", "DetectionSieve"]
