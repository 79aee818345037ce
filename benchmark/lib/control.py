"""The control of the comparison, and the readings its limits are set from.

The control is the reference put in the program's place, computed in
float8 e4m3 (one scale a tensor), the precision step below the
configuration's bf16: every convolution's input, weight and output
rounded to it, as the program rounds them to bf16, the heads' outputs
included. Its served detections go through the same comparison as the
program's and have to fail it. ``readings``
runs, in one process, the cell's timed path on several seeds (a short
window at the cell's own load: the lower readings), the control on
several seeds (the upper readings), and with ``faults`` each planted fault
on the timed path.
"""

import time

import numpy as np
import torch

from benchmark.lib import cell as runner
from benchmark.lib import check, faults as planted, plain, post


def control_numbers(cell, seed, device):
    """The comparison's numbers for the control on ``seed``: the run's
    weights and frames, a sample of as many frames as a run compares,
    each from a camera drawn as the run's cameras are."""
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference()
    leaves, host, pool = runner.weights_and_frames(cell, seed, device)
    tree = plain.views(torch.from_numpy(host).to(device), leaves)
    rng = np.random.default_rng(seed)
    cameras = runner.camera_names(traffic['cameras'])
    masked = set(cameras[::traffic['masked_every']])
    n = traffic['check_frames']
    rows = rng.integers(0, traffic['pool_frames'], n)
    senders = [cameras[i] for i in rng.integers(0, len(cameras), n)]
    filters = post.camera_filters(cfg, cameras, masked)
    labels = post.watched_labels(cfg)
    columns = ref.label_columns(cfg, labels)
    anchors = torch.from_numpy(ref.anchors(cfg)).to(device)
    low = plain.Weights(tree, quantize=plain.fp8_e4m3)
    frames = []
    with torch.no_grad():
        for start in range(0, n, 16):
            x = torch.from_numpy(pool[rows[start:start + 16]]).to(
                device).float()
            box_enc, logits = ref.forward(low, x, cfg)
            _, (db, ds, dl), _ = post.detect(box_enc, logits, anchors, cfg,
                                             columns, labels)
            db, ds, dl = db.cpu().numpy(), ds.cpu().numpy(), dl.cpu().numpy()
            for i in range(len(x)):
                camera = filters[senders[start + i]]
                keep = ds[i] > 0
                ok, hits = camera.admits(db[i], ds[i], dl[i])
                keep &= ok
                zbits = np.zeros((len(keep), 10), bool)
                zbits[:, :hits.shape[1]] = hits
                frames.append((db[i, keep].astype(np.float32),
                               ds[i, keep].astype(np.float32),
                               dl[i, keep].astype(np.int64), zbits[keep],
                               int(keep.sum())))
    weights = plain.Weights(tree)
    with runner.no_tf32(), torch.no_grad():
        return check.compare(frames, senders, pool[rows],
                             (lambda x: ref.forward(weights, x, cfg),
                              anchors, columns, device), cfg, filters)


def readings(cell, seeds, control_seeds, seconds, device, faults=(),
             fault_seeds=()):
    """Yield one row a reading: {'kind': 'program' | 'control' | fault
    name, 'seed', name: value of each compared number}."""

    def row(kind, seed, numbers, extra):
        out = {'kind': kind, 'seed': seed}
        out.update({k: v['value'] for k, v in numbers.items()})
        out.update(extra)
        return out

    def program(seed):
        result, _, rec = runner.run(cell, seed, seconds, False, device,
                                    time.perf_counter())
        return result['compared'], rec['readings']

    for seed in seeds:
        yield row('program', seed, *program(seed))
    for seed in control_seeds:
        yield row('control', seed, *control_numbers(cell, seed, device))
    for name in faults:
        for seed in fault_seeds:
            with planted.FAULTS[name]():
                yield row(name, seed, *program(seed))
