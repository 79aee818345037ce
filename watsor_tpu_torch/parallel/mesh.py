"""The device mesh of the fleet and of the sharded train step (counterpart
of watsor_tpu/parallel/mesh.py).

The JAX package lays a (data, model) mesh over the chips and lets GSPMD
shard one program. The port keeps the same grid as an ordered list of
devices read row-major: row i is data shard i, and its ``model_parallel``
devices are that row's model group, over which the SSD head kernels split
on their output channels (``param_shardings``). A device may repeat: its
shards then share its replica, each on a stream of its own.
"""

import re
from typing import Mapping, NamedTuple, Tuple

import torch

from watsor_tpu_torch.detection.detector import resolve_device_pool

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# the module names whose kernels split over the model axis (the SSD head
# convolutions), as watsor_tpu/parallel/mesh.py:24 matches the flax path
MODEL_SHARDED_KERNEL = re.compile(r'(box_head|cls_head)\d+$')


class Mesh(NamedTuple):
    """Devices of a (data, model) grid, row-major: ``rows[i]`` is data
    shard i's model group, ``rows[i][0]`` the device that runs the shard."""

    devices: Tuple[torch.device, ...]
    model_parallel: int = 1

    @property
    def shape(self):
        return {DATA_AXIS: len(self.devices) // self.model_parallel,
                MODEL_AXIS: self.model_parallel}

    @property
    def rows(self):
        m = self.model_parallel
        return tuple(self.devices[i:i + m]
                     for i in range(0, len(self.devices), m))

    @property
    def data_devices(self):
        """Each data shard's device: the first of its row."""
        return self.devices[::self.model_parallel]


def make_mesh(n_devices=None, model_parallel=1, devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices`` or,
    without them, of the device pool (every CUDA device; the CPU only where
    WATSOR_DEVICE_POOL names it): ``n // model_parallel`` data rows of
    ``model_parallel`` devices each."""
    if devices is None:
        devices = resolve_device_pool()
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError('a mesh needs at least one device')
    if model_parallel < 1 or len(devices) % model_parallel:
        raise ValueError('{} devices not divisible by model_parallel={}'
                         .format(len(devices), model_parallel))
    return Mesh(tuple(devices), int(model_parallel))


def param_shardings(mesh: Mesh, model, model_parallel=True):
    """For each parameter of ``model`` (a module, or a mapping of PyTorch
    parameter names to tensors or arrays), the axis its dim 0 splits over:
    ``MODEL_AXIS`` for the 4-d kernel of a ``box_head{i}`` / ``cls_head{i}``
    convolution whose output channels (OIHW dim 0) the model size divides,
    else None (replicated). The rule of watsor_tpu/parallel/mesh.py:57-73:
    the production 90-class ``cls_head0`` (273 channels) stays replicated
    at model 2 while ``box_head0``'s 12 split; biases, BatchNorm
    parameters, the SSDLite ``_dw`` convolutions and every EfficientDet
    parameter stay replicated."""
    params = model.named_parameters() if isinstance(model, torch.nn.Module) \
        else model.items()
    size = mesh.shape[MODEL_AXIS]
    out = {}
    for name, value in params:
        parent, _, leaf = name.rpartition('.')
        split = (model_parallel and leaf == 'weight' and
                 len(value.shape) == 4 and
                 MODEL_SHARDED_KERNEL.search(parent.rpartition('.')[2]) and
                 value.shape[0] % size == 0)
        out[name] = MODEL_AXIS if split else None
    return out


def split_kernels(mesh: Mesh, params: Mapping, model_parallel=True):
    """The names of the kernels ``param_shardings`` splits, in order, where
    the model axis has more than one device (none otherwise)."""
    if mesh.shape[MODEL_AXIS] == 1:
        return []
    return [name for name, axis in
            param_shardings(mesh, params, model_parallel).items() if axis]


def batch_sharding(mesh: Mesh, batch):
    """``batch`` split along its leading axis into one equal contiguous
    shard per data row of the mesh (views, in mesh order)."""
    n = mesh.shape[DATA_AXIS]
    if len(batch) % n:
        raise ValueError('batch of {} does not split over {} devices'
                         .format(len(batch), n))
    size = len(batch) // n
    return [batch[i * size:(i + 1) * size] for i in range(n)]
