"""Model registry and weight loading (counterpart of
watsor_tpu/models/zoo.py for the models this slice ports).

Weights come from ``<model_path>/<name>.npz`` (flat ``path/to/leaf``
arrays, the JAX package's layout); without a weight file the detector runs
on weights initialized from a seed, with the JAX package's warning.
"""

import logging
import os

import numpy as np
import torch

from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
from watsor_tpu_torch.models.weights import load_npz

_LOGGER = logging.getLogger(__name__)

MODEL_REGISTRY = {
    'ssd_mobilenet_v2': SSDConfig(),
    'ssd_mobilenet_v2_shapes': SSDConfig(num_classes=3),
}

DEFAULT_MODEL = 'ssd_mobilenet_v2'

_NOT_PORTED = 'is not ported to watsor_tpu_torch yet (ROADMAP.md, queue A)'


def load_weights(model_path, name):
    """A variables tree, or None if no weight file exists."""
    if not model_path:
        return None
    if os.path.exists(os.path.join(model_path, name + '.msgpack')):
        raise NotImplementedError(
            'loading {}.msgpack (flax serialization) {}; convert it to '
            '.npz'.format(name, _NOT_PORTED))
    npz_file = os.path.join(model_path, name + '.npz')
    if os.path.exists(npz_file):
        return load_npz(npz_file)
    return None


def build_from_zoo(name=DEFAULT_MODEL, model_path=None, seed=0,
                   active_labels=None, dtype=None, nms_mode=None,
                   device='cpu'):
    """Build a detector on ``device``, adopting stored weights when
    present. ``active_labels`` restricts post-processing to these 1-based
    labels; ``dtype`` overrides the activation dtype; ``nms_mode`` picks
    the NMS mode (fused or per-class)."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError('model {!r} {}'.format(name, _NOT_PORTED))
    config = MODEL_REGISTRY[name]
    if active_labels:
        config = config._replace(active_labels=tuple(sorted(active_labels)))
    if dtype is not None:
        config = config._replace(dtype=dtype)
    if nms_mode is not None:
        config = config._replace(nms_mode=nms_mode)
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
        if 'box_head0_dw' in tree:
            raise NotImplementedError('SSDLite weights ' + _NOT_PORTED)
        # the stored weights decide the predictor geometry
        config = config._replace(
            head_kernel=int(np.asarray(tree['box_head0']['kernel']).shape[0]))
        npl0 = np.asarray(tree['box_head0']['bias']).size // 4
        config = config._replace(
            num_classes=int(np.asarray(tree['cls_head0']['bias']).size)
            // npl0 - 1)
    else:
        _LOGGER.warning(
            "No weights for '%s' under %s — using random initialization "
            "(fine for benchmarks/synthetic shapes, not for real cameras)",
            name, model_path)
    return build_detector(config, variables=variables, seed=seed,
                          anchors=anchors, device=torch.device(device))
