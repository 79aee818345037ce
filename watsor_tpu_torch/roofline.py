"""Roofline / MFU accounting for a detection step (counterpart of
watsor_tpu/roofline.py).

Combines a step's counted FLOPs and bytes with its measured time into
achieved TFLOP/s, GB/s and percent-of-peak on the card, plus the
arithmetic-intensity verdict (which wall the step is against).

The JAX package reads both counts from XLA's cost analysis of the compiled
program. PyTorch has none: ``step_cost`` counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` over one call, and bytes as a
stated floor (below). The card's peaks come from one table,
``workload.PEAK_OPS_S`` and ``workload.HBM_BYTES_S``.
"""

import os

import torch

from watsor_tpu_torch.workload import HBM_BYTES_S, PEAK_OPS_S

# (peak bf16 dense TFLOP/s, peak HBM GB/s) by CUDA device name: only the
# H100 SXM, whose data-sheet figures workload.py holds. Another part (an
# H100 PCIe or NVL has lower clocks and slower memory) is unknown until its
# figures are added; WATSOR_PEAK_TFLOPS / WATSOR_PEAK_GBPS override.
_PEAKS = {
    'NVIDIA H100 80GB HBM3': (PEAK_OPS_S['bf16'] / 1e12, HBM_BYTES_S / 1e9),
}


def device_peaks(device):
    """(peak_tflops, peak_hbm_gbps) of a torch device, env-overridable;
    (None, None) when unknown (the CPU, or a card not in the table)."""
    tflops = os.environ.get('WATSOR_PEAK_TFLOPS')
    gbps = os.environ.get('WATSOR_PEAK_GBPS')
    if tflops and gbps:
        return float(tflops), float(gbps)
    device = torch.device(device)
    if device.type != 'cuda':
        return None, None
    return _PEAKS.get(torch.cuda.get_device_name(device), (None, None))


def _tensors(tree):
    """The tensors of a nested tuple / list / dict / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _tensors(item)]
    return []


def step_cost(fn, *args, params=()):
    """(flops, bytes) of one call ``fn(*args)``, each None where nothing
    was counted.

    FLOPs are what ``FlopCounterMode`` counts: the matrix products and
    convolutions that PyTorch dispatches (two a multiply-add). It sees
    nothing inside a kernel launched through ctypes (the port's CUDA
    kernels), so count a step on its plain walk, or add those kernels'
    work (``workload``) to the count.

    Bytes are a floor, not XLA's fusion-boundary estimate: the step's
    input tensors (``args``), its output tensors and ``params`` (the
    tensors it reads besides its arguments: weights, buffers), each read
    or written once. Intermediates that a real step writes and reads back
    are not counted."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    flops = float(counter.get_total_flops())
    nbytes = float(sum(t.nbytes for t in
                       _tensors(args) + _tensors(out) + list(params)))
    return (flops or None), (nbytes or None)


# copied from watsor_tpu/roofline.py:62-98
def roofline_row(model, batch, ms_per_step, flops, hbm_bytes, device):
    """One BENCHMARKS.md roofline row. All rates from measured wall time;
    percent-of-peak only when the device's peaks are known."""
    seconds = ms_per_step / 1000.0
    row = {
        'model': model,
        'batch': batch,
        'ms_per_step': round(ms_per_step, 2),
        'frames_per_s': round(batch / seconds, 1),
    }
    if flops:
        row['gflops_per_frame'] = round(flops / batch / 1e9, 2)
        row['achieved_tflops'] = round(flops / seconds / 1e12, 2)
    if hbm_bytes:
        row['hbm_mb_per_frame'] = round(hbm_bytes / batch / 1e6, 1)
        row['achieved_gbps'] = round(hbm_bytes / seconds / 1e9, 1)
    if flops and hbm_bytes:
        row['arithmetic_intensity'] = round(flops / hbm_bytes, 1)
    peak_tflops, peak_gbps = device_peaks(device)
    if peak_tflops and flops:
        row['pct_peak_flops'] = round(
            100.0 * flops / seconds / 1e12 / peak_tflops, 1)
    if peak_gbps and hbm_bytes:
        row['pct_peak_bw'] = round(
            100.0 * hbm_bytes / seconds / 1e9 / peak_gbps, 1)
    if peak_tflops and peak_gbps and flops and hbm_bytes:
        # the wall the model is against at this intensity: the machine's
        # ridge point is peak_flops/peak_bw
        ridge = peak_tflops * 1e12 / (peak_gbps * 1e9)
        row['bound'] = 'compute' if flops / hbm_bytes >= ridge else 'memory'
        # headroom: how much faster the step could run at 100% of the
        # binding resource (dispatch floors and serial stages eat the gap)
        limit_s = max(flops / (peak_tflops * 1e12),
                      hbm_bytes / (peak_gbps * 1e9))
        row['speed_of_light_ms'] = round(limit_s * 1000.0, 3)
        row['pct_speed_of_light'] = round(100.0 * limit_s / seconds, 1)
    return row
