"""The fleet detector: the camera batch split over the devices of a mesh
(counterpart of watsor_tpu/parallel/fleet.py:20-51).

Where the JAX package shards one jitted program with GSPMD, the port runs
the same detect step once per shard: each shard is copied to its device
and stepped there on a stream of its own, under that device, so the
hand-written kernels launch where their tensors live. Every distinct
device holds one replica of the adopted detector, rebuilt from its
weights bit for bit. The sharded training step
(watsor_tpu/parallel/fleet.py:54-83) waits for training (ROADMAP.md, A10).
"""

import contextlib

import torch

from watsor_tpu_torch.detection.backend import recorded
from watsor_tpu_torch.parallel.mesh import batch_sharding


def replicate(detector, device):
    """``detector`` on ``device``: itself where it already lives, else
    rebuilt from its own weights by ``detector.rebuild``."""
    device = torch.device(device)
    if device == detector.device:
        return detector
    if detector.rebuild is None:
        raise ValueError('this detector cannot be rebuilt on {}'
                         .format(device))
    return detector.rebuild(device)


class FleetDetector:
    """A detector whose batch spans every device of a mesh.

    ``detect(frames_u8)`` takes [B, H, W, 3] uint8 (numpy or a CPU tensor)
    with B divisible by the data-axis size and returns each shard's
    DetectionsBatch, on its device, in mesh order."""

    def __init__(self, mesh, detector):
        self.mesh = mesh
        self.detector = detector
        self.config = detector.config
        replicas = {}
        for device in mesh.devices:
            if device not in replicas:
                replicas[device] = replicate(detector, device)
        # per shard: its device's replica and a stream of its own
        self.replicas = [replicas[d] for d in mesh.devices]
        self.streams = [torch.cuda.Stream(d) if d.type == 'cuda' else None
                        for d in mesh.devices]

    @contextlib.contextmanager
    def on_shard(self, i):
        """Shard ``i``'s device and stream as the current ones, in
        inference mode."""
        device, stream = self.mesh.devices[i], self.streams[i]
        with contextlib.ExitStack() as stack:
            if stream is not None:
                stack.enter_context(torch.cuda.device(device))
                stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.inference_mode())
            yield

    def shard_batch(self, frames_u8):
        return batch_sharding(self.mesh, frames_u8)

    def shard_steps(self, batch, step, copies=None):
        """``step(i, x)`` once a shard of the host batch ``batch``, in mesh
        order: ``x`` is shard ``i`` copied to its device, and the step is
        queued on the shard's device and stream in inference mode. With
        ``copies``, each shard's copy event is appended to it. Returns
        [(the step's result, its done event or None on the CPU)]."""
        outs = []
        for i, shard in enumerate(self.shard_batch(batch)):
            stream = self.streams[i]
            with self.on_shard(i):
                x = torch.as_tensor(shard).to(self.mesh.devices[i],
                                              non_blocking=True)
                if stream is not None and copies is not None:
                    copies.append(recorded(stream))
                out = step(i, x)
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
