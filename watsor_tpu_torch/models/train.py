"""The detectors' training step (counterpart of watsor_tpu/models/train.py):
anchor matching, the focal and Huber losses, AdamW, and precise-BN
recalibration, for every family sharing the (box_encodings, logits) head
contract: the SSD on MobileNetV2/V1 or InceptionV2, plain or SSDLite, and
EfficientDet-Lite.

Numerics follow the JAX package's step. Parameters stay f32 and every
convolution casts its weight to the activation dtype where it is applied
(a flax ``Conv(dtype=bf16)``); BatchNorm in train mode takes the batch
moments in f32 and moves its running statistics as flax's does
(models/mobilenet_v2.py ``batch_norm``); the heads' outputs are cast to f32
(an f64 model's stay f64) before the losses. Gradients are autograd's
through the plain modules: the JAX package has no backward kernel, and no
TPU kernel lies on this path.

Ground truth arrives padded to a fixed number of boxes with a validity
mask; matching is a dense [B, A, G] IoU argmax, and the losses are masked
reductions, so a step never waits for the host.
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from watsor_tpu_torch.models.efficientdet import (EfficientDet,
                                                  EfficientDetConfig,
                                                  effdet_anchors,
                                                  normalize_effdet)
from watsor_tpu_torch.models.ssd import (SSD, anchors_for, resolve_device,
                                         ssd_normalizer)
from watsor_tpu_torch.models.weights import (export_variables, init_weights,
                                             load_variables)
from watsor_tpu_torch.ops.boxes import (BOX_CODER_SCALES, encode_boxes,
                                        iou_matrix)
from watsor_tpu_torch.ops.preprocess import resize_bilinear

MATCH_IOU = 0.5


def _is_effdet(config):
    return isinstance(config, EfficientDetConfig)


def _model_for(config):
    """The model a config trains: EfficientDet for an EfficientDet config,
    the SSD for anything else (never an SSD around an EfficientDet
    config)."""
    return EfficientDet(config) if _is_effdet(config) else SSD(config)


def _normalize_for(config):
    """The family's serving normalization into the activation dtype:
    (x - mean) / std for EfficientDet, the SSD's ``ssd_normalizer``."""
    if _is_effdet(config):
        return lambda x: normalize_effdet(x, config)
    return ssd_normalizer(config)


def _ingest_for(config):
    """uint8 [B, H, W, 3] on the device -> the model's input: the f32
    resize to the input size, then the family's normalization."""
    normalize = _normalize_for(config)
    size = config.input_size
    return lambda images: normalize(resize_bilinear(images, size, size))


def _anchors_for(config):
    return effdet_anchors(config) if _is_effdet(config) \
        else anchors_for(config)


@dataclasses.dataclass
class TrainState:
    """The model in train mode on its device, its optimizer, and the number
    of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def variables(self):
        """The flax-layout variables tree of the model, numpy f32."""
        return export_variables(self.model)


def make_optimizer(learning_rate=1e-3, weight_decay=1e-5):
    """``optax.adamw(learning_rate, weight_decay=weight_decay)`` as the JAX
    package configures it (b1 0.9, b2 0.999, eps 1e-8, every parameter
    decayed, BatchNorm scale and bias included; running statistics are
    buffers and do not decay), as a factory: parameters -> optimizer."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(config, init=0, optimizer=None, model=None,
                     device=None) -> TrainState:
    """A TrainState on ``device`` (None: the current CUDA device; pass 'cpu'
    for the CPU). ``init`` is a seed for the weights or a flax-layout
    variables tree; ``optimizer`` a factory of parameters -> optimizer
    (``make_optimizer()`` by default)."""
    device = resolve_device(device)
    if model is None:
        model = _model_for(config)
    if isinstance(init, dict):
        load_variables(model, init)
    else:
        init_weights(model, torch.Generator().manual_seed(int(init)))
    model = model.to(device).to(memory_format=torch.channels_last).train()
    optimizer = (optimizer or make_optimizer())(model.parameters())
    return TrainState(model, optimizer)


def _match_anchors(anchors, coder_scales, gt_boxes, gt_labels, gt_valid):
    """Anchor matching for a batch. anchors [A, 4]; gt_boxes [B, G, 4]
    normalized, gt_labels [B, G] 1-based, gt_valid [B, G] bool ->
    (cls_targets [B, A] int64, box_targets [B, A, 4], positive [B, A]).

    An anchor is positive at IoU >= 0.5 with its best ground truth (the
    first on ties, as ``jnp.argmax``). Then every valid ground truth claims
    its best anchor even below 0.5 (TF-OD's force_match_for_each_row).
    Where valid ground truths claim the same anchor, the one of highest
    index wins: the JAX step scatters the claims in order, and its last
    write stays. A ``scatter_reduce`` 'amax' over the index makes that rule
    deterministic on every device; invalid ground truths scatter to a shed
    row A."""
    B, G = gt_labels.shape
    A = anchors.shape[0]
    iou = iou_matrix(anchors, gt_boxes)                       # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_gt = iou.argmax(dim=2)                               # [B, A]
    positive = iou.amax(dim=2) >= MATCH_IOU
    target = torch.where(gt_valid, iou.argmax(dim=1), A)      # [B, G]
    index = torch.arange(G, device=gt_labels.device).expand(B, G)
    forced_gt = torch.full((B, A + 1), -1, dtype=torch.int64,
                           device=gt_labels.device).scatter_reduce(
        1, target, index, 'amax', include_self=False)[:, :A]
    forced = forced_gt >= 0
    best_gt = torch.where(forced, forced_gt, best_gt)
    positive = positive | forced
    cls_targets = torch.where(
        positive, torch.gather(gt_labels.long(), 1, best_gt), 0)
    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, A, 4))
    box_targets = encode_boxes(matched, anchors, scales=coder_scales)
    return cls_targets, box_targets, positive


def _focal_loss(logits, targets_onehot, alpha=0.25, gamma=2.0):
    """Sigmoid focal loss, elementwise, with optax's sigmoid binary cross
    entropy (-t log s(x) - (1 - t) log s(-x))."""
    p = torch.sigmoid(logits)
    ce = -targets_onehot * F.logsigmoid(logits) - \
        (1.0 - targets_onehot) * F.logsigmoid(-logits)
    p_t = p * targets_onehot + (1.0 - p) * (1.0 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1.0 - alpha) * (1.0 - targets_onehot)
    return alpha_t * ((1.0 - p_t) ** gamma) * ce


def _huber_loss(predictions, targets, delta=1.0):
    """optax.huber_loss, elementwise."""
    abs_errors = (predictions - targets).abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def make_train_step(config):
    """Returns ``step(state, batch) -> metrics``, which updates ``state``
    (the model's parameters and BatchNorm statistics, the optimizer's
    moments, ``state.step``) in place. ``step.loss_fn(model, batch) ->
    (loss, metrics)`` is its forward and loss alone, as the JAX step's
    ``loss_fn`` (profile_step times the step's phases with it).

    Family-aware as the JAX step: an EfficientDet config takes its own
    anchors, box-coder scales, normalization and no background column.
    ``batch`` holds numpy arrays or tensors:

      images    [B, H, W, 3] uint8 (resized on the device to the model
                input, in f32)
      gt_boxes  [B, G, 4] normalized ymin/xmin/ymax/xmax (f32; the box
                targets take their dtype, as in the JAX step)
      gt_labels [B, G] int 1-based
      gt_valid  [B, G] bool

    ``metrics``: 0-d tensors on the device (no host sync), f32 (f64 with
    f64 boxes): ``loss``,
    ``cls_loss``, ``box_loss`` and ``num_positive``, the positive count
    clamped at 1 as the losses divide by it.

    ``step.loss_terms(model, batch, heads=None)`` is the loss before its
    division: (the focal loss's sum, the Huber loss's sum over positives,
    the positive count), which the sharded step (parallel/fleet.py) sums
    over its data shards before ``combine_losses``; ``heads`` as
    ``SSD.forward``'s."""
    anchors = np.asarray(_anchors_for(config), np.float32)
    box_coder_scales = tuple(getattr(config, 'box_coder_scales', None) or
                             BOX_CODER_SCALES)
    # SSD heads carry a background column (one-hot index 0); EfficientDet
    # has none, and label 0 trains toward the all-zero row
    explicit_bg = getattr(config, 'explicit_background', True)
    num_cls = config.num_classes + (1 if explicit_bg else 0)
    ingest = _ingest_for(config)
    on_device = {}

    def loss_terms(model, batch, heads=None):
        device = next(model.parameters()).device
        if device not in on_device:
            on_device.setdefault(device, torch.from_numpy(anchors).to(device))
        anchors_dev = on_device[device]
        images, gt_boxes, gt_labels, gt_valid = (
            torch.as_tensor(batch[k]).to(device)
            for k in ('images', 'gt_boxes', 'gt_labels', 'gt_valid'))
        x = ingest(images)
        box_enc, logits = model(x) if heads is None else model(x, heads)
        # the model may emit bf16: losses sum over every anchor, which an
        # 8-bit mantissa cannot hold, so they are taken in f32 (in f64 for
        # an f64 model, whose sums then do not depend on how the batch is
        # sharded)
        wide = torch.promote_types(logits.dtype, torch.float32)
        box_enc = box_enc.to(wide)
        logits = logits.to(wide)
        cls_t, box_t, positive = _match_anchors(
            anchors_dev, box_coder_scales, gt_boxes, gt_labels,
            gt_valid.bool())
        if explicit_bg:
            onehot = F.one_hot(cls_t, num_cls)
        else:
            # label 0 -> the all-zero row (jax.nn.one_hot of -1)
            onehot = F.one_hot(cls_t, num_cls + 1)[..., 1:]
        cls_loss = _focal_loss(logits, onehot.to(wide)).sum()
        box_loss = torch.where(
            positive, _huber_loss(box_enc, box_t).sum(-1), 0.0).sum()
        return cls_loss, box_loss, positive.sum()

    def loss_fn(model, batch):
        return combine_losses(*loss_terms(model, batch))

    def step(state, batch):
        loss, metrics = loss_fn(state.model, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return metrics

    step.loss_fn = loss_fn
    step.loss_terms = loss_terms
    return step


def combine_losses(cls_loss, box_loss, positives):
    """(loss, metrics) from the loss's sums and its positive count: the
    sums over the positive count clamped at 1."""
    num_pos = positives.float().clamp_min(1.0)
    loss = (cls_loss + box_loss) / num_pos
    return loss, {'loss': loss.detach(),
                  'cls_loss': (cls_loss / num_pos).detach(),
                  'box_loss': (box_loss / num_pos).detach(),
                  'num_positive': num_pos}


def calibrate_batch_stats(config, variables, image_batches, model=None,
                          device=None):
    """Precise BN: a variables tree whose BatchNorm running statistics are
    the arithmetic mean of each layer's exact batch moments over
    ``image_batches`` (iterable of [B, H, W, 3] uint8, ingested as the
    train step does), in place of the lagging 0.997-momentum averages of a
    short training run. Each batch runs one train-mode forward under
    ``torch.no_grad``, in which every BatchNorm folds its batch moment into
    a cumulative mean (``batch_norm`` with momentum None). A tree without
    BatchNorm statistics passes through unchanged. ``model``: the module to
    load ``variables`` into (by default a new one for ``config``);
    ``device`` as in ``init_train_state``."""
    stats = variables.get('batch_stats')
    if not stats:
        return variables
    device = resolve_device(device)
    if model is None:
        model = _model_for(config)
    load_variables(model, variables)
    model = model.to(device).to(memory_format=torch.channels_last).train()
    for bn in model.modules():
        if isinstance(bn, nn.BatchNorm2d):
            bn.reset_running_stats()
            bn.momentum = None
    ingest = _ingest_for(config)
    count = 0
    with torch.no_grad():
        for images in image_batches:
            model(ingest(torch.as_tensor(images).to(device)))
            count += 1
    if count == 0:
        return variables
    return dict(variables, batch_stats=export_variables(model)['batch_stats'])

