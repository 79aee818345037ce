"""Plain PyTorch building blocks of the benchmark's reference models, and
the seeded weight tree that the reference and the program under test both
receive.

Nothing here imports the program. The reference runs NCHW f32 tensors (the
caller turns TF32 off); every convolution pads as TF/flax 'SAME', which is
asymmetric at stride 2 on some sizes. Weights live in a flat dictionary
keyed by the flax path (``params/backbone/stem/Conv_0/kernel``, HWIO
kernels; ``batch_stats/.../mean``), the layout the program's weight bridge
reads.

``Weights`` serves a reference forward in two modes: given a tree it hands
out its tensors; without one it records every leaf the forward asks for
(run on the ``meta`` device), which gives the tree's layout without
computing anything.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3

# How the seeded tree draws each kind of leaf: value = offset + scale * z,
# z standard normal. Kernels scale by GAIN / sqrt(fan_in) (lecun normal).
# ``calibrate`` then sets every BatchNorm's statistics to those of its input
# over the calibration frames, as training's running statistics would hold
# them, so each BatchNorm hands on about scale * unit normal + bias. The
# offset of its bias (BN_BIAS) sets how the seeded network treats its
# input: at 0 a relu6 after it halves each layer's signal and amplifies
# each difference (bf16 rounding alone then moves Lite4's logits by more
# than a different frame does); large, the network is near linear and the
# padding's constant borders drown the frame. At 1.5 a different frame moves
# Lite4's logits some ten times as far as bf16 rounding does.
# The box predictors' kernels draw at BOX_GAIN, so that box encodings
# spread by some tenths, as a trained detector's do, and not by more than
# one (a box's coordinates move by its encoding times its anchor's size).
GAIN = 1.0
BOX_GAIN = 0.15
BN_BIAS = 1.5
DRAW = {'bias': (0.0, 0.1), 'box_bias': (0.0, 0.1), 'cls_bias': (0.0, 0.1),
        'scale': (1.0, 0.1), 'bn_bias': (BN_BIAS, 0.1), 'mean': (0.0, 0.1),
        'var': (1.0, 0.1)}
# a calibrated variance's floor (a channel that is constant over the frames)
VAR_FLOOR = 1e-6
# a calibrated variance's floor as a share of the input's mean square: a
# channel that varies little about a large mean is not scaled up to unit
# spread, nor its rounding with it (bf16 rounding is relative to the value)
SPREAD_FLOOR = 0.3
# the biases of the box and class predictors, which ``calibrate`` centres
PREDICTORS = ('box_bias', 'cls_bias')


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]
    kind: str            # kernel, box_kernel, bias, box_bias, cls_bias,
    #                      scale, bn_bias, mean, var
    fan_in: int


class Weights:
    """A reference forward's view of the weight tree (see module doc)."""

    def __init__(self, tree=None, quantize=None):
        self.tree = tree
        # rounds each convolution's operands and its output
        self.quantize = quantize
        self.leaves = []
        # {bias path: (sum of the output a channel, positions)} of the
        # predictors, while calibrating
        self.outputs = None

    def get(self, path, shape, kind, fan_in=1):
        shape = tuple(int(s) for s in shape)
        if self.tree is None:
            # a module used more than once (a head shared by the levels)
            # is one leaf
            if all(leaf.path != path for leaf in self.leaves):
                self.leaves.append(Leaf(path, shape, kind, fan_in))
            return torch.empty(shape, device='meta')
        value = self.tree[path]
        if tuple(value.shape) != shape:
            raise ValueError('{}: tree has {}, the reference wants {}'.format(
                path, tuple(value.shape), shape))
        return value


def same_padding(size, kernel, stride):
    """TF 'SAME' (before, after) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(w, path, x, cout, k=1, stride=1, groups=1, bias=False,
         bias_kind='bias'):
    """'SAME' convolution of NCHW ``x`` by the HWIO kernel at ``path``;
    a box predictor's bias is of kind 'box_bias'."""
    cin = x.shape[1]
    kernel = w.get('params/{}/kernel'.format(path), (k, k, cin // groups,
                                                     cout),
                   'box_kernel' if bias_kind == 'box_bias' else 'kernel',
                   k * k * cin // groups)
    b = w.get('params/{}/bias'.format(path), (cout,), bias_kind) if bias \
        else None
    if w.quantize is not None:
        x, kernel = w.quantize(x), w.quantize(kernel)
    top, bottom = same_padding(x.shape[2], k, stride)
    left, right = same_padding(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1).to(x.dtype),
                 None if b is None else b.to(x.dtype), stride=stride,
                 groups=groups)
    if w.outputs is not None and bias_kind in PREDICTORS:
        key = 'params/{}/bias'.format(path)
        total, count = w.outputs.get(key, (0.0, 0))
        w.outputs[key] = (total + y.sum((0, 2, 3)),
                          count + y.numel() // y.shape[1])
    return y if w.quantize is None else w.quantize(y)


def batch_norm(w, path, x):
    """Inference BatchNorm with the statistics at ``path``."""
    c = x.shape[1]
    scale = w.get('params/{}/scale'.format(path), (c,), 'scale')
    bias = w.get('params/{}/bias'.format(path), (c,), 'bn_bias')
    mean = w.get('batch_stats/{}/mean'.format(path), (c,), 'mean')
    var = w.get('batch_stats/{}/var'.format(path), (c,), 'var')
    if w.outputs is not None:
        # calibrating: the statistics of this input over the frames, the
        # variance at least SPREAD_FLOOR of the mean square
        mean.copy_(x.mean((0, 2, 3)))
        spread = torch.maximum(x.var((0, 2, 3), unbiased=False),
                               SPREAD_FLOOR * x.square().mean((0, 2, 3)))
        var.copy_((spread - BN_EPS).clamp_min(VAR_FLOOR))
    mul = scale / torch.sqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * mul[:, None, None] + \
        bias[:, None, None]


def relu6(x):
    return x.clamp(0.0, 6.0)


def unit(w, path, x, cout, k=1, stride=1, groups=1, relu=True):
    """Convolution without bias, BatchNorm, relu6 (flax ConvBNRelu6)."""
    x = conv(w, path + '/Conv_0', x, cout, k, stride, groups)
    x = batch_norm(w, path + '/BatchNorm_0', x)
    return relu6(x) if relu else x


def inverted_residual(w, path, x, cout, stride, expand, k=3):
    """MobileNetV2's block and EfficientNet-Lite's MBConv."""
    cin = x.shape[1]
    y = unit(w, path + '/expand', x, cin * expand) if expand != 1 else x
    hidden = y.shape[1]
    y = unit(w, path + '/depthwise', y, hidden, k, stride, groups=hidden)
    y = unit(w, path + '/project', y, cout, relu=False)
    return y + x if stride == 1 and cin == cout else y


def max_pool_same(x, k=3, stride=2):
    """3x3 stride-2 max pool, 'SAME' padding filled with -inf."""
    top, bottom = same_padding(x.shape[2], k, stride)
    left, right = same_padding(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom), value=float('-inf'))
    return F.max_pool2d(x, k, stride)


def upsample_nearest(x, h, w):
    """Nearest resize up to (h, w): output i reads input
    floor((i + 0.5) * in / out), computed in f32."""
    def index(n_in, n_out):
        src = np.floor((np.arange(n_out, dtype=np.float32) + 0.5) * n_in /
                       n_out).astype(np.int64)
        return torch.from_numpy(src).to(x.device)
    x = torch.index_select(x, 2, index(x.shape[2], h))
    return torch.index_select(x, 3, index(x.shape[3], w))


def make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def fp8_e4m3(t):
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), back in ``t``'s dtype: the precision step
    below bf16 that the control computes in."""
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def layout(forward, cfg, size):
    """The leaves ``forward(w, x, cfg)`` asks for, in order, for one
    ``size`` x ``size`` frame (on the meta device: nothing is computed)."""
    w = Weights()
    forward(w, torch.empty((1, size, size, 3), device='meta'), cfg)
    return w.leaves


def seeded_tree(leaves, generator, device):
    """The weight tree drawn from ``generator``: one standard normal draw
    for the whole tree, scaled per leaf (``DRAW``, ``GAIN``, ``BOX_GAIN``) in one pass.
    Returns (flat f32 tensor on ``device``, {path: view of it})."""
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    offsets, scales = [], []
    for leaf in leaves:
        if leaf.kind in ('kernel', 'box_kernel'):
            offsets.append(0.0)
            gain = BOX_GAIN if leaf.kind == 'box_kernel' else GAIN
            scales.append(gain / leaf.fan_in ** 0.5)
        else:
            offset, scale = DRAW[leaf.kind]
            offsets.append(offset)
            scales.append(scale)
    total = sum(sizes)
    z = torch.randn(total, generator=generator, device=device)
    rep = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor(scales, device=device), rep)
    offset = torch.repeat_interleave(torch.tensor(offsets, device=device),
                                     rep)
    flat = torch.addcmul(offset, z, scale)
    return flat, views(flat, leaves)


def views(flat, leaves):
    """{path: view of ``flat``} of each leaf, in order."""
    tree, start = {}, 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape))
        tree[leaf.path] = flat[start:start + size].view(leaf.shape)
        start += size
    return tree


def calibrate(forward, tree, leaves, cfg, frames):
    """Calibrate a drawn ``tree`` on ``frames`` (f32 [n, S, S, 3] on the
    tree's device), in place, in one f32 forward: each BatchNorm's mean and
    variance become those of its input over the frames and positions (the
    layers before it already calibrated); each box and class predictor's
    bias loses the mean its output channel reads over the frames, every
    anchor and level, so that every seed's logits centre on 0 and its boxes
    on their anchors; then the box predictors' height and width encodings
    gain ``box_size_log`` in the box coder's units (the log of the factor
    by which a box outgrows its anchor)."""
    w = Weights(tree)
    w.outputs = {}
    forward(w, frames, cfg)
    scales = cfg['box_coder_scales']
    for leaf in leaves:
        if leaf.kind not in PREDICTORS:
            continue
        total, count = w.outputs[leaf.path]
        bias = tree[leaf.path]
        bias -= total / count
        if leaf.kind == 'box_bias':
            codes = bias.view(-1, 4)
            codes[:, 2] += cfg['box_size_log'] * scales[2]
            codes[:, 3] += cfg['box_size_log'] * scales[3]


def nested_numpy(host, leaves):
    """The tree as the program's builders take it: nested dicts of numpy
    f32 arrays under 'params' and 'batch_stats', views of ``host`` (the
    flat tree on the host)."""
    tree, start = {}, 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape))
        node = tree
        keys = leaf.path.split('/')
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = host[start:start + size].reshape(leaf.shape)
        start += size
    return tree


def forward_flops(forward, cfg):
    """Operations of one frame's forward, as FlopCounterMode counts them
    (convolutions and products, two a multiply-add), on the meta
    device."""
    from torch.utils.flop_counter import FlopCounterMode
    size = cfg['input_size']
    leaves = layout(forward, cfg, size)
    tree = {leaf.path: torch.empty(leaf.shape, device='meta')
            for leaf in leaves}
    counter = FlopCounterMode(display=False)
    with counter:
        forward(Weights(tree), torch.empty((1, size, size, 3),
                                           device='meta'), cfg)
    return counter.get_total_flops()
