"""The fleet detector and the sharded train step over a (data, model) mesh
(counterpart of watsor_tpu/parallel/fleet.py).

Where the JAX package shards one jitted program with GSPMD, the port runs
the same detect step once per data shard: each shard is copied to its row's
first device and stepped there on a stream of its own, under that device,
so the hand-written kernels launch where their tensors live. Every row
holds one replica of the adopted detector, rebuilt from its weights bit
for bit. Over a model axis of more than one device, the replica's SSD head
kernels split on their output channels over the row's model group
(parallel/heads.py), as ``param_shardings`` places them.

The sharded train step (``make_sharded_train_step``) runs one controller
too: a thread a data row runs that row's forward under its device and
stream, a barrier inside every train-mode BatchNorm exchanges the shards'
partial sums (``MomentExchange``), the global loss sums the shards' terms,
and one ``backward()`` carries the gradients across the devices. The
gradients of every parameter, and of every head-kernel slice, are then
summed over the devices that hold a copy, in mesh order, before each
device's AdamW: every replica stays equal bit for bit.
"""

import contextlib
import copy
import threading

import numpy as np
import torch
import torch.nn as nn

from watsor_tpu_torch.detection.backend import recorded
from watsor_tpu_torch.models.mobilenet_v2 import (exchanging_moments,
                                                  update_running)
from watsor_tpu_torch.models.train import (_model_for, combine_losses,
                                           make_optimizer, make_train_step)
from watsor_tpu_torch.models.weights import (export_variables, hwio_to_oihw,
                                             init_weights, leaves,
                                             load_variables)
from watsor_tpu_torch.parallel.heads import SplitHead
from watsor_tpu_torch.parallel.mesh import batch_sharding, split_kernels
from watsor_tpu_torch.runtime import spans


def replicate(detector, device, heads=None):
    """``detector`` on ``device``: itself where it already lives, else
    rebuilt from its own weights by ``detector.rebuild``; with ``heads``
    (split heads of parallel/heads.py), always rebuilt to run them."""
    device = torch.device(device)
    if device == detector.device and not heads:
        return detector
    if detector.rebuild is None:
        raise ValueError('this detector cannot be rebuilt on {}'
                         .format(device))
    if heads:
        return detector.rebuild(device, heads=heads)
    return detector.rebuild(device)


def split_heads(detector, mesh, row, model_parallel=True):
    """{head name: SplitHead} of ``detector``'s head kernels that
    ``param_shardings`` splits over the model axis, their slices on the
    devices of ``row``, in the detector's dtype, the bias on ``row[0]``.
    Only a 4-d kernel array splits, as only a 4-d ``kernel`` leaf does in
    the JAX package: a weight-only int8 detector keeps its kernels as
    QuantizedLeaf values and scales, so nothing of it splits and it runs
    data-parallel; the int8_full walk keeps float head kernels, which
    split."""
    if mesh.model_parallel == 1 or not model_parallel:
        return {}
    params = detector.variables['params']
    kernels = {'{}.weight'.format(name): hwio_to_oihw(np.asarray(
        value['kernel'], np.float32)) for name, value in params.items()
        if isinstance(value, dict) and
        getattr(value.get('kernel'), 'ndim', 0) == 4}
    dtype = detector.config.dtype
    heads = {}
    for key in split_kernels(mesh, kernels, model_parallel):
        name = key.rpartition('.')[0]
        weight = torch.from_numpy(np.ascontiguousarray(kernels[key])).to(
            dtype).contiguous(memory_format=torch.channels_last)
        bias = torch.from_numpy(np.array(params[name]['bias'],
                                         np.float32)).to(row[0], dtype)
        heads[name] = SplitHead.over(weight, bias, row)
    return heads


class FleetDetector:
    """A detector whose batch spans every device of a mesh.

    ``detect(frames_u8)`` takes [B, H, W, 3] uint8 (numpy or a CPU tensor)
    with B divisible by the data-axis size and returns each shard's
    DetectionsBatch, on its device, in mesh order. With
    ``model_parallel`` (the JAX default) and a model axis of more than one
    device, each row's replica runs its split head kernels over the row's
    model group; the service's mesh has a model axis of one."""

    def __init__(self, mesh, detector, model_parallel=True):
        self.mesh = mesh
        self.detector = detector
        self.config = detector.config
        self.devices = mesh.data_devices
        replicas = {}
        for row in mesh.rows:
            if row not in replicas:
                replicas[row] = replicate(
                    detector, row[0],
                    split_heads(detector, mesh, row, model_parallel))
        # per shard: its row's replica and a stream of its own
        self.replicas = [replicas[row] for row in mesh.rows]
        self.streams = [torch.cuda.Stream(d) if d.type == 'cuda' else None
                        for d in self.devices]

    @contextlib.contextmanager
    def on_shard(self, i):
        """Shard ``i``'s device and stream as the current ones, in
        inference mode."""
        device, stream = self.devices[i], self.streams[i]
        with contextlib.ExitStack() as stack:
            if stream is not None:
                stack.enter_context(torch.cuda.device(device))
                stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.inference_mode())
            yield

    def shard_batch(self, frames_u8):
        return batch_sharding(self.mesh, frames_u8)

    def shard_steps(self, batch, step, copies=None, rows=None):
        """``step(i, x)`` once a shard of the host batch ``batch``, in mesh
        order: ``x`` is shard ``i`` copied to its device, and the step is
        queued on the shard's device and stream in inference mode. With
        ``rows`` (a host tensor of one entry a frame of ``batch``),
        ``step(i, x, r)``, ``r`` shard ``i``'s part of ``rows`` copied
        beside ``x``. The copies do not wait for the device where the
        host tensors are pinned. With ``copies``, each shard's event after
        its copies is appended to it. Returns [(the step's result, its done
        event or None on the CPU)]."""
        outs = []
        row_shards = self.shard_batch(rows) if rows is not None else None
        for i, shard in enumerate(self.shard_batch(batch)):
            stream = self.streams[i]
            with self.on_shard(i):
                with spans.span('backend.h2d'):
                    args = [torch.as_tensor(shard).to(self.devices[i],
                                                      non_blocking=True)]
                    if row_shards is not None:
                        args.append(row_shards[i].to(self.devices[i],
                                                     non_blocking=True))
                    if stream is not None and copies is not None:
                        copies.append(recorded(stream))
                out = step(i, *args)
                outs.append((out, recorded(stream) if stream is not None
                             else None))
        return outs

    def detect(self, frames_u8):
        outs = self.shard_steps(
            frames_u8, lambda i, x: self.replicas[i].detect_batch(x))
        for _, done in outs:
            if done is not None:
                done.synchronize()
        return [out for out, _ in outs]


def _fetch(tensor, made, device):
    """``tensor`` on ``device`` for this thread's current streams. ``made``
    is (the stream it was made on, an event recorded there after it), or
    None on the CPU: a stream other than that one which reads it (the
    copy's source stream) first waits for the event."""
    if made is not None:
        stream = torch.cuda.current_stream(tensor.device)
        if stream != made[0]:
            stream.wait_event(made[1])
            tensor.record_stream(stream)
    return tensor.to(device)


def _made(stream):
    """(``stream``, an event recorded on it now), or None without one."""
    return None if stream is None else (stream, recorded(stream))


def _ordered_sum(tensors, device):
    """The sum of ``tensors`` on ``device``, added in list order: every
    device that sums the same tensors gets the same bits."""
    total = None
    for tensor in tensors:
        tensor = tensor.to(device)
        total = tensor if total is None else total + tensor
    return total


class MomentExchange:
    """The batch moments of the global batch, for every train-mode
    BatchNorm of one sharded step (``models/mobilenet_v2.py batch_norm``
    calls ``moments`` inside ``exchanging_moments``).

    Each data shard's thread brings its f32 (or wider) sums of x and x^2
    over N, H, W and its element count, waits at a barrier for every
    shard's, and adds them on its own device in shard order, so every
    device takes the same moments bit for bit: the mean and the biased
    variance E[x^2] - E[x]^2 clipped at 0, as the unsharded step takes
    them over the whole batch. The sums are plain tensor operations, so
    the one backward of the global loss carries the moments' gradients
    back to every shard. Each distinct replica's running statistics move
    once: the first shard of a replica moves its own, shard 0 also those
    of replicas that run no shard."""

    def __init__(self, shards, replicas):
        """``shards``: [(device, stream or None)] a data shard, in mesh
        order; ``replicas``: {device: module}, every distinct one."""
        self._shards = shards
        # one stream for every shard (one device): each shard's sums are
        # read on the stream that made them, with no event
        self._events = len({stream for _, stream in shards}) > 1
        self._barrier = threading.Barrier(len(shards))
        self._lock = threading.Lock()
        self._slots = {}
        self._calls = [0] * len(shards)
        first = {}
        for i, (device, _) in enumerate(shards):
            first.setdefault(device, i)
        self._leaders = set(first.values())
        self._names = {id(module): name for device in first
                       for name, module in replicas[device].named_modules()}
        self._idle = [dict(model.named_modules())
                      for device, model in replicas.items()
                      if device not in first]

    def abort(self):
        """Release every shard waiting at the barrier (one shard failed)."""
        self._barrier.abort()

    def moments(self, shard, bn, xf):
        device, stream = self._shards[shard]
        sums = (torch.stack([xf.sum(dim=(0, 2, 3)),
                             (xf * xf).sum(dim=(0, 2, 3))]),
                xf.numel() // xf.shape[1],
                _made(stream) if self._events else None)
        with self._lock:
            call = self._calls[shard]
            self._calls[shard] += 1
            slot = self._slots.setdefault(call, [None] * len(self._shards))
            slot[shard] = sums
        self._barrier.wait()
        mean, var = self._global(slot, device)
        if shard in self._leaders:
            update_running(bn, mean, var)
            if shard == 0:
                for modules in self._idle:
                    idle = modules[self._names[id(bn)]]
                    with torch.no_grad():
                        update_running(idle, *self._global(
                            slot, idle.running_mean.device))
        return mean, var

    @staticmethod
    def _global(slot, device):
        count = sum(n for _, n, _ in slot)
        total = _ordered_sum([_fetch(sums, made, device)
                              for sums, _, made in slot], device) / count
        mean = total[0]
        return mean, (total[1] - mean * mean).clamp_min(0.0)


class ShardedTrainState:
    """The train state of a sharded step over a (data, model) mesh.

    Every distinct device of the mesh holds a replica of the model in train
    mode (its replicated parameters and BatchNorm statistics) and its own
    optimizer; a head kernel that splits over the model axis lives instead
    as slices, slice j a parameter on every device of model column j, and
    enters its device's optimizer, so the AdamW moments take the same
    layout, as in the JAX step (watsor_tpu/parallel/fleet.py:68-75)."""

    def __init__(self, mesh, template, split, optimizer):
        self.mesh = mesh
        self.step = 0
        devices = list(dict.fromkeys(mesh.devices))
        self.replicas = {d: copy.deepcopy(template).to(d).to(
            memory_format=torch.channels_last).train() for d in devices}
        # name -> [{device: slice j's parameter}] a model column j
        self.slices = {}
        for name in split:
            chunks = getattr(template, name).weight.detach().chunk(
                mesh.model_parallel, 0)
            self.slices[name] = [
                {d: nn.Parameter(chunk.to(d).contiguous(
                    memory_format=torch.channels_last))
                 for d in dict.fromkeys(row[j] for row in mesh.rows)}
                for j, chunk in enumerate(chunks)]
        skip = {'{}.weight'.format(name) for name in split}
        held = {d: [p for n, p in model.named_parameters() if n not in skip]
                for d, model in self.replicas.items()}
        for columns in self.slices.values():
            for column in columns:
                for d, param in column.items():
                    held[d].append(param)
        self.optimizers = {d: optimizer(params) for d, params in held.items()}
        # the copies of each parameter whose gradients sum across devices:
        # [(contributing copies, every copy)], each in mesh order
        running = set(mesh.data_devices)
        self._groups = []
        named = [dict(m.named_parameters()) for m in self.replicas.values()]
        for name, _ in template.named_parameters():
            if name in skip:
                continue
            copies = [params[name] for params in named]
            self._groups.append(([p for d, p in zip(devices, copies)
                                  if d in running], copies))
        for columns in self.slices.values():
            for column in columns:
                self._groups.append((list(column.values()),
                                     list(column.values())))

    def heads(self, row):
        """{head name: SplitHead} of data row ``row``'s forward."""
        model = self.replicas[row[0]]
        return {name: SplitHead([columns[j][d] for j, d in enumerate(row)],
                                getattr(model, name).bias)
                for name, columns in self.slices.items()}

    def sum_gradients(self):
        """Each copy's gradient set to the sum of the contributing copies'
        gradients, on its own device, added in mesh order."""
        for contributing, copies in self._groups:
            if len(copies) == 1:
                continue
            grads = [p.grad for p in contributing if p.grad is not None]
            if not grads:
                continue
            totals = [_ordered_sum(grads, p.device) for p in copies]
            for param, total in zip(copies, totals):
                param.grad = total

    def _synchronize(self):
        for device in self.replicas:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

    def replica_variables(self, dtype=np.float32):
        """{device: the flax-layout variables tree of that device's
        replica, each split kernel's leaf replaced by the slices the device
        holds, {'slice<j>': slice j in HWIO}}."""
        self._synchronize()
        out = {}
        for device, model in self.replicas.items():
            tree = export_variables(model, dtype)
            for name, columns in self.slices.items():
                tree['params'][name]['kernel'] = {
                    'slice{}'.format(j): _hwio(column[device], dtype)
                    for j, column in enumerate(columns) if device in column}
            out[device] = tree
        return out

    def variables(self, dtype=np.float32):
        """The gathered flax-layout variables tree, as the unsharded
        ``TrainState.variables`` gives it: the first replica's parameters
        and statistics, each split kernel its slices concatenated."""
        self._synchronize()
        model = self.replicas[self.mesh.devices[0]]
        tree = export_variables(model, dtype)
        paths = {name: path for path, name, _ in leaves(model)}
        for name, columns in self.slices.items():
            kernel = torch.cat([next(iter(column.values())).detach().cpu()
                                for column in columns], dim=0)
            node = tree['params']
            for key in paths[name]:
                node = node[key]
            node['kernel'] = _hwio(kernel, dtype)
        return tree


def _global_loss(terms):
    """(loss, metrics) of the global batch from each shard's loss terms
    (``make_train_step``'s ``loss_terms``, on one device): the shards'
    summed losses over their summed positive count."""
    device = terms[0][0].device
    return combine_losses(*(_ordered_sum(column, device)
                            for column in zip(*terms)))


def _hwio(weight, dtype):
    to = {np.float32: torch.float32, np.float64: torch.float64}[
        np.dtype(dtype).type]
    return np.transpose(weight.detach().to('cpu', to).numpy(),
                        (2, 3, 1, 0)).copy()


def make_sharded_train_step(mesh, config, init=0, learning_rate=1e-3,
                            model_parallel=True, optimizer=None, model=None):
    """Build ``(state, step, shard_batch)``: the training step of
    ``models/train.py`` (device resize, forward, anchor matching, focal
    and Huber losses, AdamW) over ``mesh``, as
    watsor_tpu/parallel/fleet.py:54-83 builds it: the batch split over the
    data axis, the SSD head kernels that ``param_shardings`` splits over
    the model axis held as slices, everything else replicated. Family-aware
    as the unsharded step: an EfficientDet config splits nothing and trains
    data-parallel.

    ``init``: a seed for the weights or a flax-layout variables tree;
    ``optimizer``: a factory of parameters -> optimizer
    (``make_optimizer(learning_rate)`` by default); ``model``: the module
    to train (by default a new one for ``config``; pass one in f64 to train
    in f64). The devices are the mesh's.

    ``shard_batch(batch)`` puts a batch (``make_train_step``'s dict) on the
    mesh: one dict a data row, on the row's device. ``step(state,
    sharded)`` updates ``state`` in place and returns the metrics of the
    global batch, on the first device: the sums of the shards' loss terms
    over their summed positive count."""
    if model is None:
        model = _model_for(config)
    if isinstance(init, dict):
        load_variables(model, init)
    else:
        init_weights(model, torch.Generator().manual_seed(int(init)))
    split = [name.rpartition('.')[0] for name in
             split_kernels(mesh, model, model_parallel)]
    state = ShardedTrainState(mesh, model, split,
                              optimizer or make_optimizer(learning_rate))
    loss_terms = make_train_step(config).loss_terms
    rows = mesh.rows
    # one stream a device, shared by its shards: their host work is
    # serialized anyway, and a shared stream orders them with no event
    streams = {d: torch.cuda.Stream(d) for d in mesh.data_devices
               if d.type == 'cuda'}
    shard_streams = [streams.get(d) for d in mesh.data_devices]

    def shard_batch(batch):
        shards = [{} for _ in rows]
        for key, value in batch.items():
            for i, part in enumerate(batch_sharding(
                    mesh, torch.as_tensor(value))):
                shards[i][key] = part.to(rows[i][0])
        return shards

    def run_shard(i, exchange, ready, out):
        device, stream = rows[i][0], shard_streams[i]
        try:
            with contextlib.ExitStack() as stack:
                if stream is not None:
                    stack.enter_context(torch.cuda.device(device))
                    stack.enter_context(torch.cuda.stream(stream))
                    stream.wait_event(ready[device])
                stack.enter_context(exchanging_moments(exchange, i))
                terms = loss_terms(state.replicas[device], out['batch'][i],
                                   state.heads(rows[i]) or None)
                out['terms'][i] = terms, _made(stream)
        except BaseException as exc:
            exchange.abort()
            out['errors'].append(exc)

    def forward(state, sharded):
        """Every shard's forward and loss terms, each in a thread of its
        own: (the global loss, its metrics)."""
        if isinstance(sharded, dict):
            sharded = shard_batch(sharded)
        exchange = MomentExchange(
            list(zip(mesh.data_devices, shard_streams)), state.replicas)
        ready = {d: recorded(torch.cuda.current_stream(d))
                 for d in state.replicas if d.type == 'cuda'}
        out = {'batch': sharded, 'terms': [None] * len(rows), 'errors': []}
        threads = [threading.Thread(target=run_shard,
                                    args=(i, exchange, ready, out),
                                    name='train-shard-{}'.format(i))
                   for i in range(len(rows))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        errors = [e for e in out['errors']
                  if not isinstance(e, threading.BrokenBarrierError)]
        if errors or out['errors']:
            raise (errors or out['errors'])[0]
        first = rows[0][0]
        return _global_loss([[_fetch(t, made, first) for t in shard]
                             for shard, made in out['terms']])

    def backward(state, loss):
        """The gradients of the global loss, summed across the devices."""
        for optimizer_ in state.optimizers.values():
            optimizer_.zero_grad(set_to_none=True)
        loss.backward()
        state.sum_gradients()

    def update(state):
        for optimizer_ in state.optimizers.values():
            optimizer_.step()
        state.step += 1

    def step(state, sharded):
        loss, metrics = forward(state, sharded)
        backward(state, loss)
        update(state)
        return metrics

    # the step's phases, for profile_step's breakdown
    step.forward, step.backward, step.update = forward, backward, update
    return state, step, shard_batch
