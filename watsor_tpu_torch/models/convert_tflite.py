# Copy of watsor_tpu/models/convert_tflite.py: imports and paths adapted.
"""TFLite flatbuffer conversion: the reference's actual model files ->
the flax-layout variables tree of the port's SSD.

The reference's model directory holds ``edgetpu.tflite`` / ``cpu.tflite``
SSD-MobileNet detection graphs, which it executes as opaque flatbuffers.
This module lets a user point the converter at THOSE SAME FILES: the op
graph is walked structurally (tensor names are mangled by the TFLite
exporters, so nothing is matched by name), weights are extracted
(int8/uint8 tensors are dequantized per-channel) and mapped onto the SSD
of models/ssd.py.

Supported graphs: TF-OD-API SSD-MobileNet v1 / v2 / SSDLite exports
(``export_tflite_ssd_graph`` and friends), float or quantized, with the
``TFLite_Detection_PostProcess`` custom op (the standard detect.tflite
layout) or the raw two-concatenation form. The custom op is a bonus: its
constant input carries the EXACT anchor grid the checkpoint was trained
with, and its flexbuffer options carry the box-coder scales; both are
adopted (``build_detector(anchors=...)`` takes the grid as it is), so
decode parity does not depend on re-deriving the anchor generator
configuration.

BatchNorm is folded into conv weights in every TFLite export; the folded
kernel/bias pairs are loaded as identity-BN ConvBN units (scale=1,
bias=b, mean=0, var=1-eps) so the modules reproduce the conv+bias
computation. The flatbuffer schema comes from TensorFlow, imported only
when a graph is read.
"""

import logging
from collections import defaultdict

import numpy as np


class UnsupportedGraph(ValueError):
    """The flatbuffer does not look like a supported SSD-MobileNet."""


# ops that pass activations through unchanged for the purpose of locating
# the producing conv (dequant pairs, shape plumbing, the score sigmoid)
_PASS = {'RESHAPE', 'LOGISTIC', 'DEQUANTIZE', 'QUANTIZE', 'SQUEEZE',
         'EXPAND_DIMS', 'PAD'}
_CONVS = {'CONV_2D', 'DEPTHWISE_CONV_2D'}


class _Graph:
    """Minimal structural view of a .tflite flatbuffer (first subgraph)."""

    def __init__(self, data):
        from tensorflow.lite.python import schema_py_generated as schema_fb
        self._schema = schema_fb
        model = schema_fb.ModelT.InitFromPackedBuf(bytearray(data), 0)
        self.model = model
        sub = model.subgraphs[0]
        self.tensors = sub.tensors
        self.buffers = model.buffers
        self.ops = list(sub.operators)
        self.graph_inputs = list(sub.inputs)
        self.graph_outputs = list(sub.outputs)

        builtin_names = {value: key for key, value in
                         vars(schema_fb.BuiltinOperator).items()
                         if isinstance(value, int)}
        self._op_kind = []
        for op in self.ops:
            oc = model.operatorCodes[op.opcodeIndex]
            code = max(oc.builtinCode,
                       getattr(oc, 'deprecatedBuiltinCode', 0) or 0)
            if code == schema_fb.BuiltinOperator.CUSTOM:
                name = oc.customCode
                kind = (name.decode() if isinstance(name, (bytes, bytearray))
                        else str(name))
            else:
                kind = builtin_names.get(code, 'OP_{}'.format(code))
            self._op_kind.append(kind)

        self.producer = {}
        self.consumers = defaultdict(list)
        for i, op in enumerate(self.ops):
            for t in op.outputs:
                self.producer[int(t)] = i
            for t in op.inputs:
                if t >= 0:
                    self.consumers[int(t)].append(i)

    def kind(self, op_index):
        return self._op_kind[op_index]

    def tensor_value(self, tensor_index):
        """Constant tensor -> float32 numpy (dequantized); None if the
        tensor is an activation (empty buffer)."""
        schema_fb = self._schema
        t = self.tensors[tensor_index]
        buf = self.buffers[t.buffer].data
        if buf is None or len(buf) == 0:
            return None
        tt = schema_fb.TensorType
        dtypes = {tt.FLOAT32: np.float32, tt.FLOAT16: np.float16,
                  tt.INT32: np.int32, tt.INT64: np.int64,
                  tt.UINT8: np.uint8, tt.INT8: np.int8}
        if t.type not in dtypes:
            raise UnsupportedGraph(
                'unsupported tensor type {} for a weight tensor'.format(
                    t.type))
        arr = np.frombuffer(bytes(bytearray(buf)),
                            dtype=dtypes[t.type]).reshape(list(t.shape))
        q = t.quantization
        if (t.type in (tt.UINT8, tt.INT8, tt.INT32) and q is not None
                and q.scale is not None and len(q.scale)):
            scale = np.asarray(q.scale, np.float32)
            zero = (np.asarray(q.zeroPoint, np.int64)
                    if q.zeroPoint is not None and len(q.zeroPoint)
                    else np.zeros(1, np.int64))
            axis = q.quantizedDimension or 0
            if scale.size > 1:     # per-channel
                shape = [1] * arr.ndim
                shape[axis] = scale.size
                scale = scale.reshape(shape)
                zero = zero.reshape(shape) if zero.size > 1 else zero
            arr = (arr.astype(np.float32) - zero.astype(np.float32)) * scale
        return np.asarray(arr, np.float32)

    def back_to(self, tensor_index, kinds):
        """Walk producers through pass-through ops until an op of one of
        ``kinds`` produces the tensor; returns (op_index, seen_kinds)."""
        seen = []
        t = int(tensor_index)
        for _ in range(32):
            op = self.producer.get(t)
            if op is None:
                return None, seen
            k = self.kind(op)
            if k in kinds:
                return op, seen
            if k not in _PASS:
                return None, seen
            seen.append(k)
            t = int(self.ops[op].inputs[0])
        return None, seen


def _conv_weights(graph, op_index):
    """(kernel HWIO, bias) for a CONV_2D / DEPTHWISE_CONV_2D op."""
    op = graph.ops[op_index]
    w = graph.tensor_value(int(op.inputs[1]))
    b = None
    if len(op.inputs) > 2 and op.inputs[2] >= 0:
        b = graph.tensor_value(int(op.inputs[2]))
    if w is None:
        raise UnsupportedGraph('conv weights are not constant')
    if graph.kind(op_index) == 'DEPTHWISE_CONV_2D':
        # TFLite [1, kh, kw, ch] -> flax grouped-conv [kh, kw, 1, ch]
        kernel = np.transpose(w, (1, 2, 0, 3))
    else:
        # TFLite OHWI -> flax HWIO
        kernel = np.transpose(w, (1, 2, 3, 0))
    if b is None:
        b = np.zeros(kernel.shape[-1], np.float32)
    return kernel, np.asarray(b, np.float32)


_BN_EPS = 1e-3


def _conv_bn(graph, op_index):
    """Folded conv+bias -> identity-BN ConvBN subtree (bias rides in the
    BatchNorm shift; var = 1-eps makes the BN a no-op)."""
    kernel, bias = _conv_weights(graph, op_index)
    ch = kernel.shape[-1]
    return ({'Conv_0': {'kernel': kernel},
             'BatchNorm_0': {'scale': np.ones(ch, np.float32),
                             'bias': bias}},
            {'BatchNorm_0': {'mean': np.zeros(ch, np.float32),
                             'var': np.full(ch, 1.0 - _BN_EPS,
                                            np.float32)}})


def _head(graph, op_index):
    kernel, bias = _conv_weights(graph, op_index)
    return {'kernel': kernel, 'bias': bias}


def _find_postprocess(graph):
    for i in range(len(graph.ops)):
        if 'Detection_PostProcess' in graph.kind(i):
            return i
    return None


def _parse_post_options(graph, op_index):
    """Flexbuffer custom options of TFLite_Detection_PostProcess."""
    data = graph.ops[op_index].customOptions
    if data is None:
        return {}
    try:
        from flatbuffers import flexbuffers
    except ImportError:
        logging.getLogger(__name__).warning(
            'flatbuffers.flexbuffers unavailable — postprocess options '
            '(box-coder scales, class count) not parsed; falling back to '
            'default SSD scales')
        return {}
    try:
        return flexbuffers.Loads(bytes(bytearray(data)))
    except (ValueError, TypeError, IndexError) as exc:
        logging.getLogger(__name__).warning(
            'could not parse TFLite_Detection_PostProcess options (%s) — '
            'falling back to default SSD box-coder scales', exc)
        return {}


def _head_convs(graph, concat_tensor):
    """CONCATENATION feeding ``concat_tensor`` -> per-level conv op
    indices, in level order (= the concat's input order)."""
    op, _ = graph.back_to(concat_tensor, {'CONCATENATION'})
    if op is None:
        raise UnsupportedGraph('no concatenation feeding the head output')
    convs = []
    for t in graph.ops[op].inputs:
        conv, _ = graph.back_to(int(t), {'CONV_2D'})
        if conv is None:
            raise UnsupportedGraph('head level not produced by a conv')
        convs.append(conv)
    return convs


def _tap_of_head(graph, conv_op):
    """Input feature tensor of a predictor; for SSDLite the private
    depthwise stage is returned too."""
    t = int(graph.ops[conv_op].inputs[0])
    producer = graph.producer.get(t)
    if (producer is not None
            and graph.kind(producer) == 'DEPTHWISE_CONV_2D'
            and len(graph.consumers[t]) == 1):
        # SSDLite predictor: depthwise stage feeding only this 1x1 conv
        return int(graph.ops[producer].inputs[0]), producer
    return t, None


def _through_input(graph, add_op):
    """Residual ADD disambiguation: the through-path input is the conv
    whose short chain (project<-dw<-expand) reaches the other input."""
    inputs = [int(t) for t in graph.ops[add_op].inputs[:2]]
    for idx, cand in enumerate(inputs):
        other = inputs[1 - idx]
        t = cand
        for _ in range(8):
            op = graph.producer.get(t)
            if op is None:
                break
            kind = graph.kind(op)
            if kind not in _CONVS and kind not in _PASS:
                break
            t = int(graph.ops[op].inputs[0])
            if t == other:
                return cand, other
    raise UnsupportedGraph('cannot resolve residual add inputs')


def _chain_back(graph, tensor, stop_tensor=None):
    """Conv ops from ``stop_tensor`` (exclusive; graph input if None) up to
    ``tensor``, in forward order. Residual ADDs follow the through path."""
    ops = []
    t = int(tensor)
    for _ in range(1000):
        if stop_tensor is not None and t == stop_tensor:
            return list(reversed(ops))
        op = graph.producer.get(t)
        if op is None:
            if stop_tensor is None:
                return list(reversed(ops))
            raise UnsupportedGraph('chain ended before the expected tap')
        k = graph.kind(op)
        if k in _CONVS:
            ops.append(op)
            t = int(graph.ops[op].inputs[0])
        elif k == 'ADD':
            t, _ = _through_input(graph, op)
        elif k in _PASS:
            t = int(graph.ops[op].inputs[0])
        else:
            raise UnsupportedGraph(
                'unexpected {} op on the feature chain'.format(k))
    raise UnsupportedGraph('feature chain too long')


def _expect(graph, chain, pos, kind, what):
    if pos >= len(chain) or graph.kind(chain[pos]) != kind:
        got = graph.kind(chain[pos]) if pos < len(chain) else 'end of chain'
        raise UnsupportedGraph(
            'expected {} ({}), found {}'.format(kind, what, got))
    return chain[pos]


def _map_backbone_v2(graph, chain, params, stats):
    """chain: conv ops from graph input to the Conv_1 output (tap1)."""
    bb_p, bb_s = {}, {}

    def unit(name, op):
        bb_p[name], bb_s[name] = _conv_bn(graph, op)

    def unit_sub(block, sub, op):
        p, s = _conv_bn(graph, op)
        bb_p.setdefault(block, {})[sub] = p
        bb_s.setdefault(block, {})[sub] = s

    pos = 0
    unit('stem', _expect(graph, chain, pos, 'CONV_2D', 'stem'))
    pos += 1
    # block 0: no expansion
    unit_sub('block0', 'depthwise',
             _expect(graph, chain, pos, 'DEPTHWISE_CONV_2D', 'block0 dw'))
    unit_sub('block0', 'project',
             _expect(graph, chain, pos + 1, 'CONV_2D', 'block0 project'))
    pos += 2
    for n in range(1, 17):
        expand = _expect(graph, chain, pos, 'CONV_2D',
                         'block{} expand'.format(n))
        dw = _expect(graph, chain, pos + 1, 'DEPTHWISE_CONV_2D',
                     'block{} dw'.format(n))
        project = _expect(graph, chain, pos + 2, 'CONV_2D',
                          'block{} project'.format(n))
        pos += 3
        if n == 13:
            unit('block13_expand', expand)
            unit('block13_depthwise', dw)
            unit('block13_project', project)
        else:
            block = 'block{}'.format(n)
            unit_sub(block, 'expand', expand)
            unit_sub(block, 'depthwise', dw)
            unit_sub(block, 'project', project)
    unit('head', _expect(graph, chain, pos, 'CONV_2D', 'Conv_1'))
    pos += 1
    if pos != len(chain):
        raise UnsupportedGraph(
            '{} extra backbone convs after Conv_1'.format(len(chain) - pos))
    params['backbone'] = bb_p
    stats['backbone'] = bb_s


def _map_backbone_v1(graph, chain, params, stats):
    bb_p, bb_s = {}, {}
    pos = 0
    bb_p['stem'], bb_s['stem'] = _conv_bn(
        graph, _expect(graph, chain, pos, 'CONV_2D', 'stem'))
    pos += 1
    for n in range(1, 14):
        dw = _expect(graph, chain, pos, 'DEPTHWISE_CONV_2D',
                     'unit{} dw'.format(n))
        pw = _expect(graph, chain, pos + 1, 'CONV_2D',
                     'unit{} pw'.format(n))
        pos += 2
        bb_p['unit{}_depthwise'.format(n)], \
            bb_s['unit{}_depthwise'.format(n)] = _conv_bn(graph, dw)
        bb_p['unit{}_pointwise'.format(n)], \
            bb_s['unit{}_pointwise'.format(n)] = _conv_bn(graph, pw)
    if pos != len(chain):
        raise UnsupportedGraph('unexpected v1 backbone depth')
    params['backbone'] = bb_p
    stats['backbone'] = bb_s


def _map_extras(graph, taps, lite, params, stats):
    """taps: feature tensors per predictor level (0..5)."""
    for i in range(4):
        chain = _chain_back(graph, taps[2 + i], stop_tensor=taps[1 + i])
        expected = 3 if lite else 2
        if len(chain) != expected:
            raise UnsupportedGraph(
                'extra {} has {} convs (expected {})'.format(
                    i, len(chain), expected))
        params['extra{}_pw'.format(i)], stats['extra{}_pw'.format(i)] = \
            _conv_bn(graph, _expect(graph, chain, 0, 'CONV_2D',
                                    'extra pw'))
        if lite:
            params['extra{}_dw'.format(i)], \
                stats['extra{}_dw'.format(i)] = _conv_bn(
                    graph, _expect(graph, chain, 1, 'DEPTHWISE_CONV_2D',
                                   'extra dw'))
            last = _expect(graph, chain, 2, 'CONV_2D', 'extra out')
        else:
            last = _expect(graph, chain, 1, 'CONV_2D', 'extra out')
        params['extra{}'.format(i)], stats['extra{}'.format(i)] = \
            _conv_bn(graph, last)


def _center_to_corners(anchors_cwh):
    cy, cx, h, w = [anchors_cwh[:, i] for i in range(4)]
    return np.stack([cy - 0.5 * h, cx - 0.5 * w,
                     cy + 0.5 * h, cx + 0.5 * w], axis=-1).astype(np.float32)


def convert_tflite_ssd(model_content=None, model_path=None, config=None):
    """.tflite detection graph -> (flax variables, SSDConfig, anchors).

    ``anchors`` is the exact [A, 4] corner-form anchor grid stored in the
    graph's TFLite_Detection_PostProcess op, or None for raw exports (the
    generated grid of ops/anchors.py applies then)."""
    from watsor_tpu_torch.models.ssd import SSDConfig
    from watsor_tpu_torch.ops.anchors import anchors_per_location
    if model_content is None:
        with open(model_path, 'rb') as f:
            model_content = f.read()
    graph = _Graph(model_content)

    anchors = None
    coder_scales = None
    num_classes_opt = None
    post = _find_postprocess(graph)
    if post is not None:
        box_t, cls_t, anchors_t = [int(t) for t in
                                   graph.ops[post].inputs[:3]]
        anchors_cwh = graph.tensor_value(anchors_t)
        if anchors_cwh is None or anchors_cwh.shape[-1] != 4:
            raise UnsupportedGraph('postprocess anchors are not constant')
        anchors = _center_to_corners(anchors_cwh.reshape(-1, 4))
        opts = _parse_post_options(graph, post)
        if all(k in opts for k in ('y_scale', 'x_scale', 'h_scale',
                                   'w_scale')):
            coder_scales = (float(opts['y_scale']), float(opts['x_scale']),
                            float(opts['h_scale']), float(opts['w_scale']))
        if 'num_classes' in opts:
            num_classes_opt = int(opts['num_classes'])
    else:
        # raw export: two concatenated outputs, box by trailing dim 4
        outs = [t for t in graph.graph_outputs]
        if len(outs) != 2:
            raise UnsupportedGraph(
                'no detection postprocess op and {} outputs (expected the '
                'raw box/class pair)'.format(len(outs)))
        shapes = [list(graph.tensors[t].shape) for t in outs]
        if shapes[0][-1] == 4:
            box_t, cls_t = outs
        elif shapes[1][-1] == 4:
            cls_t, box_t = outs
        else:
            raise UnsupportedGraph('cannot identify the box output')

    box_convs = _head_convs(graph, box_t)
    cls_convs = _head_convs(graph, cls_t)
    if len(box_convs) != len(cls_convs):
        raise UnsupportedGraph('box/class level counts differ')
    n_layers = len(box_convs)

    taps = []
    lite = False
    head_dw = []
    for b_op, c_op in zip(box_convs, cls_convs):
        b_tap, b_dw = _tap_of_head(graph, b_op)
        c_tap, c_dw = _tap_of_head(graph, c_op)
        if b_tap != c_tap:
            raise UnsupportedGraph('box/class heads read different taps')
        taps.append(b_tap)
        head_dw.append((b_dw, c_dw))
        lite = lite or (b_dw is not None)

    backbone_chain = _chain_back(graph, taps[1])
    # v2: stem + block0(2) + 16 blocks x3 + Conv_1 = 52 convs;
    # v1: stem + 13 x (dw, pw) = 27 convs
    if len(backbone_chain) == 52:
        is_v2 = True
    elif len(backbone_chain) == 27:
        is_v2 = False
    else:
        raise UnsupportedGraph(
            'backbone has {} convs — not an SSD-MobileNet v1/v2 at width '
            '1.0'.format(len(backbone_chain)))

    params, stats = {}, {}
    if is_v2:
        _map_backbone_v2(graph, backbone_chain, params, stats)
    else:
        _map_backbone_v1(graph, backbone_chain, params, stats)
    _map_extras(graph, taps, lite, params, stats)

    for i, ((b_dw, c_dw), b_op, c_op) in enumerate(
            zip(head_dw, box_convs, cls_convs)):
        if lite:
            if b_dw is None or c_dw is None:
                raise UnsupportedGraph(
                    'mixed dense/separable predictors')
            params['box_head{}_dw'.format(i)], \
                stats['box_head{}_dw'.format(i)] = _conv_bn(graph, b_dw)
            params['cls_head{}_dw'.format(i)], \
                stats['cls_head{}_dw'.format(i)] = _conv_bn(graph, c_dw)
        params['box_head{}'.format(i)] = _head(graph, b_op)
        params['cls_head{}'.format(i)] = _head(graph, c_op)

    # geometry from the harvested weights
    cfg = config if config is not None else SSDConfig()
    npl = anchors_per_location(cfg.anchor_spec)
    if n_layers != cfg.anchor_spec.num_layers:
        raise UnsupportedGraph(
            '{} predictor levels (expected {})'.format(
                n_layers, cfg.anchor_spec.num_layers))
    cls_ch = params['cls_head0']['kernel'].shape[-1]
    num_classes = cls_ch // npl[0] - 1
    if num_classes_opt is not None and num_classes_opt != num_classes:
        raise UnsupportedGraph(
            'postprocess num_classes={} disagrees with the class head '
            '({})'.format(num_classes_opt, num_classes))
    if lite:
        head_kernel = params['box_head0_dw']['Conv_0']['kernel'].shape[0]
    else:
        head_kernel = params['box_head0']['kernel'].shape[0]
    extras = tuple(params['extra{}'.format(i)]['Conv_0']['kernel'].shape[-1]
                   for i in range(4))
    if config is None:
        cfg = cfg._replace(
            num_classes=num_classes, head_kernel=head_kernel, lite=lite,
            backbone='mobilenet_v2' if is_v2 else 'mobilenet_v1',
            extra_features=extras)
        if coder_scales is not None:
            cfg = cfg._replace(box_coder_scales=coder_scales)

    variables = {'params': params, 'batch_stats': stats}
    return variables, cfg, anchors
