"""Model registry and weight loading (counterpart of
watsor_tpu/models/zoo.py).

Weights come from ``<model_path>/<name>.msgpack`` (flax serialization of
the variables tree, read by models/msgpack.py without flax) or, without
one, ``<model_path>/<name>.npz`` (flat ``path/to/leaf`` arrays); without a
weight file the detector runs on weights initialized from a seed, with the
JAX package's warning. Stored weights decide the head geometry, as in the
JAX package: the class count and predictor kernel (and SSDLite or not) of
an SSD, the class count of its weight-shared predictor;
the FPN width and depth, head depth, fusion method and class count
of an EfficientDet. A TFLite conversion's ``postprocess`` entry carries
the source graph's anchors and box-coder scales. ``save_weights`` writes
the ``.msgpack`` file as the JAX package's does.

"""

import logging
import os

import numpy as np

from watsor_tpu_torch.models.efficientdet import (EfficientDetConfig,
                                                  build_effdet, lite_config)
from watsor_tpu_torch.models.msgpack import load_msgpack, save_msgpack
from watsor_tpu_torch.models.ssd import (SSDConfig, build_detector,
                                         resolve_device)
from watsor_tpu_torch.ops.anchors import (MultiscaleAnchorSpec,
                                          anchors_per_location)
from watsor_tpu_torch.models.weights import load_npz

_LOGGER = logging.getLogger(__name__)

MODEL_REGISTRY = {
    'ssd_mobilenet_v2': SSDConfig(),
    'ssd_mobilenet_v1': SSDConfig(backbone='mobilenet_v1'),
    'ssdlite_mobilenet_v2': SSDConfig(lite=True),
    'ssd_inception_v2': SSDConfig(backbone='inception_v2'),
    'ssd_mobilenet_v2_shapes': SSDConfig(num_classes=3),
    'efficientdet_lite0': lite_config('lite0'),
    'efficientdet_lite1': lite_config('lite1'),
    'efficientdet_lite2': lite_config('lite2'),
    'efficientdet_lite3': lite_config('lite3'),
    'efficientdet_lite4': lite_config('lite4'),
    # TF2 Detection Model Zoo, "SSD ResNet50 V1 FPN 1024x1024 (RetinaNet50)"
    # (research/object_detection/configs/tf2/
    # ssd_resnet50_v1_fpn_1024x1024_coco17_tpu-8.config)
    'ssd_resnet50_v1_fpn_1024': SSDConfig(
        input_size=1024, backbone='resnet50_v1',
        anchor_spec=MultiscaleAnchorSpec(
            min_level=3, max_level=7, anchor_scale=4.0, scales_per_octave=2,
            aspect_ratios=(1.0, 2.0, 0.5)),
        score_threshold=1e-8),
}

DEFAULT_MODEL = 'ssd_mobilenet_v2'


def model_config(name):
    """The registered config of ``name``; an ``efficientdet_<variant>``
    outside the registry goes through ``lite_config``, which raises
    ValueError for an unknown variant, as the JAX package's does."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name.startswith('efficientdet_'):
        return lite_config(name.split('_', 1)[1])
    raise ValueError('unknown model {!r}; available: {}'.format(
        name, ', '.join(sorted(MODEL_REGISTRY))))


def load_weights(model_path, name):
    """A variables tree, or None if no weight file exists; ``.msgpack``
    takes precedence over ``.npz``."""
    if not model_path:
        return None
    msgpack_file = os.path.join(model_path, name + '.msgpack')
    if os.path.exists(msgpack_file):
        return load_msgpack(msgpack_file)
    npz_file = os.path.join(model_path, name + '.npz')
    if os.path.exists(npz_file):
        return load_npz(npz_file)
    return None


def _key_sorted(tree):
    if isinstance(tree, dict):
        return {key: _key_sorted(tree[key]) for key in sorted(tree)}
    return np.asarray(tree)


def save_weights(variables, model_path, name):
    """Write ``variables`` (a flax-layout tree, as
    ``weights.export_variables`` gives it) to ``<model_path>/<name>.msgpack``
    in the bytes of the JAX package's ``save_weights``, which sorts the keys
    (``jax.tree_util.tree_map``) and calls ``flax.serialization.to_bytes``.
    Returns the file's path."""
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path, name + '.msgpack')
    save_msgpack(path, _key_sorted(variables))
    return path


def _stored_effdet_geometry(config, tree):
    """watsor_tpu/models/zoo.py:105-126: the stored EfficientDet weights
    decide the FPN and head shape and the class count."""
    npc = config.anchors_per_cell
    head = tree['cls_head']
    ncls_total = int(np.asarray(head['predict']['pw']['kernel']).shape[-1]) \
        // npc
    return config._replace(
        fpn_channels=int(np.asarray(
            tree['resample_p6']['Conv_0']['kernel']).shape[-1]),
        fpn_repeats=sum(1 for k in tree if k.startswith('bifpn')),
        head_repeats=sum(1 for k in head if k.startswith('sep')),
        fpn_weight_method=('fastattn' if 'WSM' in tree['bifpn0']['fnode0']
                           else 'sum'),
        num_classes=ncls_total - (1 if config.explicit_background else 0))


def _stored_ssd_geometry(config, tree):
    """watsor_tpu/models/zoo.py:127-151: the stored SSD weights decide
    SSDLite or not, the predictor kernel and the class count; of a
    weight-shared predictor, the class count, from its class predictor's
    bias."""
    npl0 = anchors_per_location(config.anchor_spec)[0]
    if 'cls_tower' in tree:
        bias = tree['cls_tower']['predict']['bias']
        return config._replace(
            num_classes=int(np.asarray(bias).size) // npl0 - 1)
    lite = 'box_head0_dw' in tree
    if lite:
        k = int(np.asarray(tree['box_head0_dw']['Conv_0']['kernel']).shape[0])
    else:
        k = int(np.asarray(tree['box_head0']['kernel']).shape[0])
    num_classes = int(np.asarray(tree['cls_head0']['bias']).size) // npl0 - 1
    return config._replace(lite=lite, head_kernel=k, num_classes=num_classes)


def build_from_zoo(name=DEFAULT_MODEL, model_path=None, seed=0,
                   active_labels=None, dtype=None, nms_mode=None,
                   device=None):
    """Build a detector on ``device`` (None: the current CUDA device; pass
    'cpu' for the CPU), adopting stored weights when present.
    ``active_labels`` restricts post-processing to these 1-based labels;
    ``dtype`` overrides the activation dtype; ``nms_mode`` picks the NMS
    mode (fused or per-class). ``WATSOR_FUSED_HEADS=1`` runs an
    EfficientDet's two heads as one twice-wide stack."""
    config = model_config(name)
    device = resolve_device(device)
    if active_labels:
        config = config._replace(active_labels=tuple(sorted(active_labels)))
    if dtype is not None:
        config = config._replace(dtype=dtype)
    if nms_mode is not None:
        config = config._replace(nms_mode=nms_mode)
    effdet = isinstance(config, EfficientDetConfig)
    if effdet and os.environ.get('WATSOR_FUSED_HEADS') == '1':
        config = config._replace(fused_heads=True)
    variables = load_weights(model_path, name)
    anchors = None
    if variables is not None:
        post = variables.pop('postprocess', None)
        if post is not None:
            # TFLite conversions store the source graph's exact anchor grid
            # and box-coder scales beside the weights
            if post.get('anchors') is not None:
                anchors = np.asarray(post['anchors'], np.float32)
            if post.get('box_coder_scales') is not None:
                config = config._replace(box_coder_scales=tuple(
                    float(s) for s in np.asarray(post['box_coder_scales'])))
        tree = variables['params']
        config = _stored_effdet_geometry(config, tree) if effdet else \
            _stored_ssd_geometry(config, tree)
    else:
        _LOGGER.warning(
            "No weights for '%s' under %s — using random initialization "
            "(fine for benchmarks/synthetic shapes, not for real cameras)",
            name, model_path)
    build = build_effdet if effdet else build_detector
    return build(config, variables=variables, seed=seed, anchors=anchors,
                 device=device)
