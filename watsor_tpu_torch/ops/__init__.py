"""Device ops of the detection path (PyTorch, NHWC at the boundary): the
JAX package's ``watsor_tpu.ops`` exports under the port's names. No kernel
builds at import: each wrapper builds its kernel at its first launch."""

from watsor_tpu_torch.ops.anchors import AnchorSpec, ssd_anchors
from watsor_tpu_torch.ops.boxes import (box_area, decode_boxes, encode_boxes,
                                        iou_matrix)
from watsor_tpu_torch.ops.nms import batched_class_aware_nms
# resize_bilinear is the counterpart of the JAX package's
# resize_bilinear_mxu (the same two contractions, not named for the MXU)
from watsor_tpu_torch.ops.preprocess import (normalize_images,
                                             preprocess_batch,
                                             resize_bilinear)

__all__ = [
    'decode_boxes', 'encode_boxes', 'iou_matrix', 'box_area',
    'ssd_anchors', 'AnchorSpec',
    'batched_class_aware_nms',
    'normalize_images', 'resize_bilinear', 'preprocess_batch',
]
