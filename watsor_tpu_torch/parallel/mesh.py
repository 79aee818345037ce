"""The device mesh of the fleet (counterpart of
watsor_tpu/parallel/mesh.py:27-40,76-78).

The JAX package lays a (data, model) mesh over the chips and lets GSPMD
shard one program. The port keeps the data axis only: an ordered list of
devices, each stepping an equal contiguous shard of the camera batch.
``model_parallel > 1`` (the SSD head kernels split over a model axis,
watsor_tpu/parallel/mesh.py:43-73) waits for training (ROADMAP.md, A10);
the service never asks for it.
"""

from typing import NamedTuple, Tuple

import torch

from watsor_tpu_torch.detection.detector import resolve_device_pool

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


class Mesh(NamedTuple):
    """Devices along the data axis, in shard order (a device may repeat:
    its shards then share its replica, each on a stream of its own)."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self):
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}


def make_mesh(model_parallel=1, devices=None) -> Mesh:
    """A data-axis mesh over ``devices`` or, without them, the device pool
    (every CUDA device; the CPU only where WATSOR_DEVICE_POOL names it)."""
    if model_parallel != 1:
        raise NotImplementedError(
            'model_parallel={} is not ported: the port shards the batch '
            'only (ROADMAP.md, A10)'.format(model_parallel))
    if devices is None:
        devices = resolve_device_pool()
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError('a mesh needs at least one device')
    return Mesh(tuple(devices))


def batch_sharding(mesh: Mesh, batch):
    """``batch`` split along its leading axis into one equal contiguous
    shard per device of the mesh (views, in mesh order)."""
    n = mesh.shape[DATA_AXIS]
    if len(batch) % n:
        raise ValueError('batch of {} does not split over {} devices'
                         .format(len(batch), n))
    size = len(batch) // n
    return [batch[i * size:(i + 1) * size] for i in range(n)]
