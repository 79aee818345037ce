"""EfficientDet-Lite's step by stage, its forward by section and its
backbone by stage group (counterpart of scripts/profile_lite4.py,
scripts/profile_lite4_sections.py and scripts/profile_backbone_stages.py).

``build_from_zoo('efficientdet_' + VARIANT)`` (``lite4``: 640x640, bf16,
the zoo's ``nms: fused``, seeded weights) at ``BENCH_BATCH`` (32).
``VARIANT`` is a constant: the scripts' ``LITE_VARIANT`` has no caller
that sets another value (``bench models`` covers the other families).
Each part is one of the scripts' selectors, recorded under its script's
key with its script's row name:

- ``full``: the detect step on seeded uint8 frames of the input size
  (``full_step``);
- ``forward``: the device resize and normalize, then the forward
  (``pre+forward``);
- ``post``: the detect step's own decode and NMS (``models/ssd.py``
  ``post_nms``: the late fused form under a fused zoo mode, else decode,
  f32 sigmoid and the per-class entry) on seeded box encodings uniform in
  [-1, 1] and bf16 logits uniform in [-6, 1] (``decode+nms``);
- ``pre``: the resize and normalize alone (``{'ms_per_step'}``);
- ``backbone``: ``model.backbone`` on a seeded bf16 input in [-1, 1]
  (``backbone``);
- ``fpn``: ``model.fpn`` (``resample_p6``, two max pools, the BiFPN cells)
  on the backbone's taps (``bifpn_x{R}``);
- ``heads``: ``model.heads`` on the BiFPN's features, its outputs as f32
  (``heads``);
- ``stages``: ``backbone.stem``, then the blocks of each stage of
  ``backbone.plan``, each on a seeded input of the shape
  profile_backbone_stages.py's walk gives (the stem halves, then each
  block's stride): rows ``stem``, ``stage0`` ... with ``in_shape`` (NHWC)
  and ``n_blocks``.

The sections are the built model's own submodules, in the order its
forward runs them (``EfficientDet.forward`` is ``heads(fpn(*backbone))``):
the JAX scripts re-root the flax tree into ``FPNOnly``, ``HeadsOnly`` and
``StageRun`` only because flax scopes parameters by module.

Every part is timed twice: ``ms_per_step`` by the scripts' protocol (one
warm call, ``BENCH_STEPS`` (10) calls back to back, one synchronise: host
launches included), and ``chained_ms_per_step`` by the chained harness
(``timing.chained_input_runner``: the part captured once as a CUDA graph,
``N_SHORT`` and ``N_LONG`` (2 and 32) steps differenced: device time), so
the gap between the two is the part's host launches. The chain carries
through one element of the input, so a small part's chained time holds
no pass over its input that the part does not make. Each row but
``pre``'s is ``roofline.roofline_row`` over ``roofline.step_cost`` of one
call at the dispatch time; ``flops_source`` says what counted the FLOPs.
The record (``variant``, ``batch``, ``anchors``, the parts, ``device``) is
appended to ``PROFILE_OUT`` where that is set (profile_lite4_sections.py's
variable; the scripts append to the repo's LITE4_PROFILE.jsonl, which this
module never does).
"""

from watsor_tpu_torch.measure import (chained_input_ms, dispatch_ms, env_int,
                                      write_out)

VARIANT = 'lite4'
PARTS = ('full', 'forward', 'post', 'pre', 'backbone', 'fpn', 'heads',
         'stages')
FLOPS_SOURCE = ('torch.utils.flop_counter.FlopCounterMode over one call of '
                'the part (plain PyTorch under the zoo\'s nms fused; it '
                'cannot see a hand-written kernel\'s launch)')
STEM_CHANNELS = 32              # the Lite stem is not width-scaled


def _uniform(shape, lo, hi, dtype, device, g):
    import torch
    return (torch.rand(shape, generator=g, device=device) * (hi - lo) +
            lo).to(dtype)


def _generator(device, seed=0):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def _nchw_maker(batch, shape, dtype, device):
    """Seeded NHWC inputs in [-1, 1] of ``shape`` (H, W, C), as the NCHW
    view the model's modules take."""
    def make(g):
        return _uniform((batch,) + tuple(shape), -1.0, 1.0, dtype, device,
                        g).permute(0, 3, 1, 2)
    return make


def sections(detector):
    """The forward's three sections over ``detector.model``'s submodules:
    ``backbone(x)`` (NHWC input -> the taps C3, C4, C5), ``fpn(taps)`` (->
    P3 .. P7) and ``heads(feats)`` (-> f32 box_enc [B, A, 4] and logits
    [B, A, C]); ``heads(fpn(backbone(x)))`` is ``raw_apply(x)`` op for op."""
    model = detector.model

    def backbone(x):
        return model.backbone(x.permute(0, 3, 1, 2))

    def fpn(taps):
        return model.fpn(*taps)

    def heads(feats):
        box_enc, logits = model.heads(feats)
        return box_enc.float(), logits.float()

    return {'backbone': backbone, 'fpn': fpn, 'heads': heads}


def stage_groups(detector):
    """[(name, run, in_shape, n_blocks, modules)]: the stem, then each stage
    of ``backbone.plan`` as its blocks in turn, with the NHWC input shape
    of profile_backbone_stages.py's walk."""
    backbone = detector.model.backbone
    size = detector.config.input_size
    stages = {}
    for i, (_, features, strides, _, stage) in enumerate(backbone.plan):
        stages.setdefault(stage, []).append((i, features, strides))
    groups = [('stem', backbone.stem, (size, size, 3), 0,
               [backbone.stem])]
    h = w = size // 2
    c = STEM_CHANNELS
    for stage in sorted(stages):
        blocks = [getattr(backbone, 'block{}'.format(i))
                  for i, _, _ in stages[stage]]

        def run(x, blocks=blocks):
            for block in blocks:
                x = block(x)
            return x
        groups.append(('stage{}'.format(stage), run, (h, w, c),
                       len(blocks), blocks))
        for _, features, strides in stages[stage]:
            h //= strides
            w //= strides
            c = features
    return groups


def _params(*modules):
    return [t for m in modules for t in m.state_dict().values()]


def measure(device, parts=None, log=None):
    """The scripts' record for ``parts`` (all of PARTS by default)."""
    import torch

    from watsor_tpu_torch import roofline, timing
    from watsor_tpu_torch.models.efficientdet import normalize_effdet
    from watsor_tpu_torch.models.ssd import post_nms
    from watsor_tpu_torch.models.zoo import build_from_zoo
    from watsor_tpu_torch.ops.preprocess import resize_bilinear
    from watsor_tpu_torch.workload import card_label

    parts = tuple(parts or PARTS)
    variant = VARIANT
    batch = env_int('BENCH_BATCH', 32)
    steps = env_int('BENCH_STEPS', 10)
    n_short = env_int('N_SHORT', 2)
    n_long = env_int('N_LONG', 32)

    detector = build_from_zoo('efficientdet_' + variant, None,
                              device=device)
    cfg, model = detector.config, detector.model
    size = cfg.input_size
    anchors = torch.from_numpy(detector.anchors).to(device)
    A = len(detector.anchors)
    C = len(cfg.active_labels) if cfg.active_labels else cfg.num_classes
    if log:
        log('variant={} anchors={} classes={} size={}'.format(
            variant, A, C, size))
    record = {'variant': variant, 'batch': batch, 'anchors': A}

    def timed(name, step, make_input, params, row=True):
        """The part ``step(x)`` timed on ``make_input``'s seed-0 input by
        the dispatch loop and by the chained harness; its row."""
        x = make_input(_generator(device))
        ms = dispatch_ms(step, [x], steps, device)
        chained, _ = chained_input_ms(step, make_input, device,
                                      n_short=n_short, n_long=n_long)
        if row:
            flops, nbytes = roofline.step_cost(step, x, params=params)
            out = roofline.roofline_row(name, batch, ms, flops, nbytes,
                                        device)
            out['flops_source'] = FLOPS_SOURCE
        else:
            out = {'ms_per_step': round(ms, 3)}
        out['chained_ms_per_step'] = round(chained, 3)
        if log:
            log('{}: {}'.format(name, out))
        return out

    def pre(frames):
        return normalize_effdet(resize_bilinear(frames, size, size), cfg)

    frames = timing.seeded_frames(batch, (size, size), device)
    weights = _params(model)
    section = sections(detector)
    with torch.inference_mode():
        if 'full' in parts:
            record['full'] = timed('full_step', detector.detect_batch,
                                   frames, weights)
        if 'forward' in parts:
            record['forward'] = timed('pre+forward',
                                      lambda f: model(pre(f)), frames,
                                      weights)
        if 'post' in parts:
            g = _generator(device, 1)
            box_enc = _uniform((batch, A, 4), -1.0, 1.0, torch.float32,
                               device, g)
            logits = _uniform((batch, A, C), -6.0, 1.0, torch.bfloat16,
                              device, g)
            record['post'] = timed('decode+nms',
                                   lambda e: post_nms(cfg, anchors, e,
                                                      logits),
                                   lambda g: box_enc, [anchors, logits])
        if 'pre' in parts:
            record['pre'] = timed('pre', pre, frames, (), row=False)
        x_in = _nchw_maker(batch, (size, size, 3), cfg.dtype, device)
        if {'backbone', 'fpn', 'heads'} & set(parts):
            taps = model.backbone(x_in(_generator(device)))
        if 'backbone' in parts:
            record['backbone'] = timed('backbone', model.backbone, x_in,
                                       _params(model.backbone))
        if {'fpn', 'heads'} & set(parts):
            feats = section['fpn'](taps)
        if 'fpn' in parts:
            fpn_modules = [model.resample_p6] + [
                getattr(model, 'bifpn{}'.format(r))
                for r in range(cfg.fpn_repeats)]
            record['fpn'] = timed(
                'bifpn_x{}'.format(cfg.fpn_repeats),
                lambda c3: model.fpn(c3, taps[1], taps[2]),
                lambda g: taps[0], _params(*fpn_modules) + list(taps[1:]))
        if 'heads' in parts:
            head_modules = [model.dual_head] if cfg.fused_heads else \
                [model.cls_head, model.box_head]
            record['heads'] = timed(
                'heads', lambda p3: section['heads']([p3] + feats[1:]),
                lambda g: feats[0], _params(*head_modules) + feats[1:])
        if 'stages' in parts:
            record['stages'] = []
            for name, run, in_shape, n_blocks, modules in \
                    stage_groups(detector):
                row = timed(name, run,
                            _nchw_maker(batch, in_shape, cfg.dtype, device),
                            _params(*modules))
                row['in_shape'] = list(in_shape)
                row['n_blocks'] = n_blocks
                record['stages'].append(row)
    record['device'] = card_label(device)
    write_out('PROFILE_OUT', record, 'a')
    return record
