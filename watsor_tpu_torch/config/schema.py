# Copy of watsor_tpu/config/schema.py: imports and paths adapted.
"""Declarative configuration schema.

Reproduces the reference's config surface bit-for-bit
(upstream watsor/config/schema.py:3-224): http/mqtt endpoints, root
ffmpeg + detect defaults copied into cameras, per-camera width/height/input/
output/mask/ffmpeg/detect with per-class area/confidence/zones.

Expressed in the mini-language of :mod:`watsor_tpu.config.validation`
(our clean-room replacement for cerberus, which isn't a dependency here).
"""

from watsor_tpu_torch.config.coco import COCO_CLASSES

# Per-class detection options (area %, confidence %, zone indices).
_DETECT_OPTIONS = {
    'type': 'dict',
    'default': {},
    'fields': {
        'area': {'type': 'float', 'min': 0, 'max': 100, 'default': 10},
        'confidence': {'type': 'float', 'min': 0, 'max': 100, 'default': 50},
        'zones': {'type': 'list', 'default': [], 'items': {'type': 'integer'}},
    },
}


def _detect_list(allowed_labels=None):
    keys = {'type': 'string', 'coerce': str, 'empty': False}
    if allowed_labels is not None:
        keys = dict(keys, allowed=allowed_labels)
    return {
        'type': 'list',
        'unique_key': True,
        'items': {
            'type': 'dict',
            'max_len': 1,
            'keys': keys,
            'values': _DETECT_OPTIONS,
        },
    }


_FFMPEG_ARGS = {'type': 'list', 'items': {'type': 'string', 'coerce': str}}

# An ffmpeg pipeline spec must read/write raw rgb24 video over pipes so the
# framework can own the pixels (same contract as the reference schema
# upstream watsor/config/schema.py:161).
_RAWVIDEO_ARGS = ['-i', '-f', 'rawvideo', '-pix_fmt', 'rgb24']

schema = {
    'http': {
        'type': 'dict',
        'default': {},
        'fields': {
            'port': {'type': 'integer', 'min': 1, 'max': 65535, 'default': 8080},
            'username': {'type': 'string'},
            'password': {'type': 'string', 'dependencies': 'username'},
        },
    },
    'mqtt': {
        'type': 'dict',
        'fields': {
            'host': {'type': 'string', 'required': True},
            'port': {'type': 'integer', 'min': 1, 'max': 65535, 'default': 1883},
            'username': {'type': 'string'},
            'password': {'type': 'string', 'dependencies': 'username'},
        },
    },
    'ffmpeg': {
        'type': 'dict',
        'default': {},
        'fields': {
            'decoder': dict(_FFMPEG_ARGS, default=[]),
            'encoder': _FFMPEG_ARGS,
        },
    },
    'detect': dict(_detect_list(), default=[]),
    # NMS semantics (watsor_tpu extension; the reference's NMS is baked into
    # its frozen graphs): 'fused' = Fast-NMS suppression (fastest),
    # 'fused_exact' = greedy semantics at fused cost (fixed-point iteration),
    # 'exact' = classic per-class greedy, bit-parity with
    # tf.image.combined_non_max_suppression.
    'nms': {'type': 'string', 'default': 'fused_exact',
            'allowed': ['fused', 'fused_exact', 'exact']},
    # detector selection (watsor_tpu extension; the reference probes the
    # model dir for edgetpu.tflite/gpu.trt/cpu.pb files instead —
    # detection/detector.py:40-50). CLI --model / WATSOR_MODEL override.
    'model': {'type': 'string', 'required': False},
    'cameras': {
        'type': 'list',
        'required': True,
        'empty': False,
        'unique_key': True,
        'items': {
            'type': 'dict',
            'max_len': 1,
            'keys': {'type': 'string', 'coerce': str, 'empty': False},
            'values': {
                'type': 'dict',
                'default': {},
                'fields': {
                    'width': {'type': 'integer', 'required': True, 'min': 1},
                    'height': {'type': 'integer', 'required': True, 'min': 1},
                    'input': {'type': 'string', 'required': True, 'coerce': str},
                    'output': {'type': 'string', 'coerce': str,
                               'dependencies': 'ffmpeg.encoder'},
                    'mask': {'type': 'string', 'coerce': str},
                    'ffmpeg': {
                        'type': 'dict',
                        'default_from_root': 'ffmpeg',
                        'fields': {
                            'decoder': dict(_FFMPEG_ARGS, required=True,
                                            contains=_RAWVIDEO_ARGS),
                            'encoder': dict(_FFMPEG_ARGS,
                                            contains=_RAWVIDEO_ARGS),
                        },
                    },
                    'detect': dict(_detect_list(COCO_CLASSES),
                                   default_from_root='detect',
                                   required=True, empty=False),
                },
            },
        },
    },
}
