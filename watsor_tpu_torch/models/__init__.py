"""Detection models of the port: the SSD family (MobileNetV1/V2, SSDLite,
InceptionV2) and EfficientDet-Lite0 to Lite4, their registry
(``zoo.build_from_zoo``), weights, converters, int8 walk and training.
Exports the JAX package's ``watsor_tpu.models`` names."""

from watsor_tpu_torch.models.mobilenet_v2 import MobileNetV2Backbone
from watsor_tpu_torch.models.ssd import SSD, SSDConfig, build_detector

__all__ = ['SSD', 'SSDConfig', 'build_detector', 'MobileNetV2Backbone']
