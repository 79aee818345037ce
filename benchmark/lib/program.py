"""The system under test, built as the port's application builds it for a
camera deployment (watsor_tpu_torch/main.py ``_detector_factory``,
``_setup_camera`` and the backend factory of ``_setup``): the zoo's model
configuration with the sizes of the benchmark's configuration file, the
weights the benchmark drew, the fused-block walk where the file asks for
it, every camera's device filter tables and, for a camera with a mask, its
exact zone refiner, behind one ``TorchDetectorBackend``.

The program is imported inside ``build`` alone: the rest of the harness
runs without it.
"""

import os

from benchmark.lib.post import HERE


def load():
    """Import the program, so that a checkout without it fails before the
    set-up's work."""
    import watsor_tpu_torch.detection.backend  # noqa: F401


def build(cfg, tree, device, cameras, masked, max_batch, min_batch=1):
    """The backend over ``device`` with weights ``tree`` (nested numpy,
    flax layout), for ``cameras`` (names) of which ``masked`` carry the
    configuration's mask, its batches padded to ``max_batch`` at most and
    to ``min_batch``'s bucket at least (WATSOR_MIN_BUCKET's setting)."""
    import cv2
    import torch

    from watsor_tpu_torch.config.coco import coco_label_index
    from watsor_tpu_torch.detection.backend import TorchDetectorBackend
    from watsor_tpu_torch.filters.mask import ZoneMask, get_alpha_channel
    from watsor_tpu_torch.models.efficientdet import (EfficientDetConfig,
                                                      build_effdet)
    from watsor_tpu_torch.models.ssd import build_detector
    from watsor_tpu_torch.models.zoo import model_config
    from watsor_tpu_torch.ops.filter_device import (ZoneRefiner,
                                                    threshold_tables,
                                                    zone_tables)

    base = model_config(cfg['model'])
    sizes = {key: tuple(value) if isinstance(value, list) else value
             for key, value in cfg.items()
             if key in base._fields and key != 'dtype'}
    config = base._replace(
        **sizes, nms_mode=cfg['nms'], dtype=getattr(torch, cfg['dtype']),
        active_labels=tuple(sorted(coco_label_index(name)
                                   for name in cfg['watched'])))
    effdet = isinstance(config, EfficientDetConfig)
    detector = (build_effdet if effdet else build_detector)(
        config, variables=tree, device=device)
    if len(detector.anchors) != cfg['anchors']:
        raise ValueError('the program builds {} anchors, the configuration '
                         'states {}'.format(len(detector.anchors),
                                            cfg['anchors']))
    if cfg.get('fused_blocks'):
        from watsor_tpu_torch.models.ssd_fused import build_fused_detector
        detector = build_fused_detector(detector)

    mask = None
    if masked:
        image = cv2.imread(os.path.join(HERE, cfg['mask']),
                           cv2.IMREAD_UNCHANGED)
        mask = ZoneMask(get_alpha_channel(image), tuple(cfg['frame_hw']))
    conf, area = threshold_tables(cfg['detect'])
    plain_zones = zone_tables(None, cfg['detect'])
    mask_zones = zone_tables(mask, cfg['detect']) if mask else None
    tables, refiners = {}, {}
    for camera in cameras:
        zones = mask_zones if camera in masked else plain_zones
        tables[camera] = (conf, area) + tuple(zones)
        if camera in masked:
            refiners[camera] = ZoneRefiner(mask, cfg['detect'])
    return TorchDetectorBackend(detector, device, max_batch=max_batch,
                                camera_tables=tables, zone_refiners=refiners,
                                min_batch=min_batch)
