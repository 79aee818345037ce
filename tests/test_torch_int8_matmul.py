"""The port's int8 matrix product with its requantizing epilogue
(ops/int8_matmul.py) against the JAX package's Pallas kernel, interpreted
on the CPU as tests/test_int8_matmul.py runs it, on the same seeded
inputs; and, on the card, the CUDA kernel against its plain version.

Bars: int8 outputs within one quantum and at least 99.9% equal (the two
can round an exact .5 differently, the bar of tests/test_int8_matmul.py);
f32 outputs within rtol 1e-5; the kernel equal to its plain version bit
for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import watsor_tpu.ops.int8_matmul as j_mm
from watsor_tpu_torch import workload
from watsor_tpu_torch.ops import int8_matmul as t_mm

F32_RTOL = 1e-5


def _int8_close(got, want):
    """Every element within one quantum, at least 99.9% equal."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize('shape', [(256, 96, 24), (96, 64, 384),
                                   (160, 1280, 512), (200, 24, 144)])
@pytest.mark.parametrize('out_scale', [0.047, None])
@pytest.mark.parametrize('relu6', [True, False])
def test_int8_matmul_plain_matches_jax_kernel(shape, out_scale, relu6):
    """Against the Pallas kernel (interpret mode): int8 outputs within one
    quantum and >= 99.9% equal, f32 outputs within rtol 1e-5."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-3, N).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(j_mm.int8_matmul_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), out_scale=out_scale, relu6=relu6,
        interpret=True))
    got = t_mm.int8_matmul_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), out_scale=out_scale, relu6=relu6).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if out_scale is None:
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-5)
    else:
        _int8_close(got, want)
        assert np.unique(got).size > 50           # not all clipped


def test_int8_matmul_wrapper_on_cpu_runs_plain():
    """A CPU tensor takes the plain version and counts no launch."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, (40, 24)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (24, 16)).astype(np.int8))
    scale = torch.full((16,), 1e-3)
    bias = torch.zeros(16)
    before = t_mm.int8_matmul_requant.launches
    got = t_mm.int8_matmul_requant(x, w, scale, bias, out_scale=0.05)
    assert torch.equal(got, t_mm.int8_matmul_requant_plain(
        x, w, scale, bias, out_scale=0.05))
    assert t_mm.int8_matmul_requant.launches == before


def test_int8_matmul_sums_past_f32_exactness():
    """K = 1280 of +-127 products: sums beyond 2^24 stay exact before the
    one rounding to f32 (int32 -> f32, as XLA converts them)."""
    x = torch.full((2, 1280), 127, dtype=torch.int8)
    w = torch.full((1280, 1), 127, dtype=torch.int8)
    w[0, 0] = 126                                  # 20,644,993: odd
    got = t_mm.exact_matmul(x, w)
    assert got[0, 0].item() == np.float32(np.int32(1280 * 127 * 127 - 127))


# ragged shapes: one row, odd K and N, N not a multiple of 4
RAGGED = [(1, 24, 16), (130, 17, 70), (129, 1280, 65)]
# every distinct shape of one int8 forward at batch 8, and the ragged ones
PLAN_SHAPES = sorted({(M, K, N) for M, K, N, _, _ in
                      workload.int8_pointwise_calls(8)}) + RAGGED


@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_int8_launch_plan(shape):
    """The launch plan covers the shape, fits in shared memory, splits K
    over at most 8 blocks in slices of at least 64, uses narrow tiles for
    narrow N, gives at least two thirds of the SMs a block wherever K
    allows it, and is cached."""
    M, K, N = shape
    plan = t_mm.plan_launch(M, K, N)
    assert plan is t_mm.plan_launch(M, K, N)
    assert plan.bm in (64, 128) and plan.bn % 16 == 0
    assert plan.bn >= N or plan.bn == 128
    assert plan.bn == next((b for b in t_mm.WIDTHS if b >= N), 128)
    assert 1 <= plan.splits <= t_mm.MAX_CLUSTER
    assert plan.kslice % 32 == 0
    assert plan.splits == 1 or plan.kslice >= t_mm.MIN_SLICE
    assert (plan.splits - 1) * plan.kslice < K <= plan.splits * plan.kslice
    assert plan.tiles >= 1 and (plan.splits == 1 or plan.tiles == 1)
    row_tiles = -(-M // plan.bm)
    assert plan.blocks == (-(-row_tiles // plan.tiles) * -(-N // plan.bn) *
                           plan.splits)
    assert plan.smem == t_mm._layout_bytes(plan.bm, plan.bn, plan.kslice,
                                           plan.splits, plan.tiles)
    assert plan.smem <= t_mm.SMEM_LIMIT
    best = max(p.blocks for p in t_mm.candidate_plans(M, K, N))
    if best >= t_mm.MIN_BLOCKS:
        assert plan.blocks >= t_mm.MIN_BLOCKS


def test_int8_launch_plans_all_fit():
    """Every plan the kernel takes for the path's shapes fits in shared
    memory, and the wrapper's plan is one of them."""
    for M, K, N in PLAN_SHAPES:
        plans = t_mm.candidate_plans(M, K, N)
        assert t_mm.plan_launch(M, K, N) in plans
        assert all(p.smem <= t_mm.SMEM_LIMIT for p in plans)


def test_int8_bound_of_one_forward():
    """The bound of the 38 calls at batch 8 that chip_smoke.py and
    profile_step report: bytes-bound, 113.7 MB over 3.35 TB/s."""
    calls = workload.int8_pointwise_calls(8)
    roof = workload.Bound()
    for M, K, N, quantize, _ in calls:
        nbytes, ops = workload.int8_call_work(M, K, N, quantize)
        roof.add(nbytes, int8=ops)
    entry = {}
    roof.update(entry)
    assert len(calls) == 38 and entry['bound_by'] == 'bytes'
    assert round(roof.bytes_ms * 3.35e12 / 1e9, 1) == 113.7
    assert abs(entry['bound_ms'] - 0.0339) < 5e-5


def test_int8_launch_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        t_mm.plan_launch(0, 16, 16)


@pytest.mark.cuda
def test_int8_matmul_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version, bit for bit, at the int8
    path's distinct shapes at batch 2 and 8, at ragged ones and at a split
    of K that leaves a short last slice (run on the card: pytest -m
    cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    device = torch.device('cuda', 0)
    rng = np.random.default_rng(6)
    cases = sorted(set(workload.int8_pointwise_calls(2)) |
                   set(workload.int8_pointwise_calls(8))) + [
        (1, 24, 16, True, True), (130, 17, 70, True, False),
        (129, 1280, 65, False, True), (800, 1000, 160, True, True),
        (800, 1000, 160, False, False)]
    for M, K, N, quantize, relu6 in cases:
        x = torch.tensor(rng.integers(-127, 128, (M, K)), dtype=torch.int8,
                         device=device)
        w = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8,
                         device=device)
        scale = torch.tensor(rng.uniform(1e-5, 1e-4, N), dtype=torch.float32,
                             device=device)
        bias = torch.tensor(rng.normal(0, 1, N), dtype=torch.float32,
                            device=device)
        out_scale = 0.047 if quantize else None
        got = t_mm.int8_matmul_requant(x, w, scale, bias, out_scale, relu6)
        want = t_mm.int8_matmul_requant_plain(x, w, scale, bias, out_scale,
                                              relu6)
        assert torch.equal(got, want), (M, K, N, quantize, relu6)


@pytest.mark.cuda
def test_int8_walk_runs_at_batch_one_on_the_card():
    """At batch 1 a convolution's NCHW output permuted to NHWC can reshape
    into a strided [M, K] view; the walk hands the kernel contiguous rows
    (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
    from watsor_tpu_torch.models.ssd_int8 import build_int8_detector
    device = torch.device('cuda', 0)
    detector = build_detector(SSDConfig(num_classes=3, input_size=96),
                              device=device)
    calib = np.random.default_rng(7).integers(0, 256, (2, 96, 96, 3),
                                              np.uint8)
    int8 = build_int8_detector(detector, calib, pointwise='pallas')
    before = t_mm.int8_matmul_requant.launches
    for batch in (1, 2):
        out = int8.detect_batch(torch.from_numpy(calib[:batch]).to(device))
        assert bool(torch.isfinite(out.boxes).all())
    assert t_mm.int8_matmul_requant.launches - before == 2 * 38
