"""The port's fused inverted-residual block against the JAX package's
Pallas kernel (interpreted on the CPU) on the same seeded inputs.

Both round to bf16 at the same points (input, after expand, after
depthwise) and sum in f32, so they differ only in f32 summation order:
that can flip the last bit of a bf16 intermediate, which moves an output
by well under 1e-2. The mean bound catches any systematic difference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from watsor_tpu.ops.fused_block import fused_inverted_residual as j_block
from watsor_tpu_torch.ops import fused_block as t_block
from watsor_tpu_torch.workload import FUSED_SHAPES

ATOL = 1e-2
MEAN_ATOL = 1e-4


def _operands(seed, B, H, W, C_in, E, C_out, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, C_in)).astype(dtype)
    weights = (rng.normal(0, C_in ** -0.5, (C_in, E)),
               rng.normal(0, 0.1, E),
               rng.normal(0, 1 / 3, (3, 3, E)),
               rng.normal(0, 0.1, E),
               rng.normal(0, E ** -0.5, (E, C_out)),
               rng.normal(0, 0.1, C_out))
    return x, [w.astype(np.float32) for w in weights]


@pytest.mark.parametrize('H,W,C_out,residual', [
    (8, 8, 16, True),          # whole map in one tile, with residual
    (8, 8, 24, False),         # projection to a wider output
    (26, 8, 16, True),         # two 16-row tiles and their halo in JAX
])
def test_plain_block_matches_jax_kernel(H, W, C_out, residual):
    x, weights = _operands(H * 100 + C_out, 2, H, W, 16, 96, C_out)
    want = np.asarray(j_block(jnp.asarray(x),
                              *(jnp.asarray(w) for w in weights),
                              residual=residual, interpret=True))
    got = t_block.fused_inverted_residual_plain(
        torch.from_numpy(x), *(torch.from_numpy(w) for w in weights),
        residual=residual).numpy()
    assert got.shape == want.shape == (2, H, W, C_out)
    diff = np.abs(got - want)
    assert diff.max() < ATOL, diff.max()
    assert diff.mean() < MEAN_ATOL, diff.mean()


def test_wrapper_on_cpu_runs_plain_in_x_dtype():
    x, weights = _operands(1, 1, 6, 5, 8, 48, 8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = [torch.from_numpy(w) for w in weights]
    before = t_block.fused_inverted_residual.launches
    got = t_block.fused_inverted_residual(xt, *wt, residual=True)
    want = t_block.fused_inverted_residual_plain(xt, *wt, residual=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert t_block.fused_inverted_residual.launches == before


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 4, 4, 8), device='meta')
    w = [torch.empty(s, device='meta') for s in
         ((8, 16), (16,), (3, 3, 16), (16,), (16, 8), (8,))]
    with pytest.raises(ValueError, match='unsupported device'):
        t_block.fused_inverted_residual(x, *w)


# (H, C_in, E, C_out): the main path's distinct shapes, and two odd H
PLAN_SHAPES = sorted(set(FUSED_SHAPES)) + [(9, 160, 960, 320),
                                           (13, 64, 384, 64)]


@pytest.mark.parametrize('B', [1, 8, 32])
@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_launch_plan_fits_and_covers_the_block(shape, B):
    """Every plan fits in shared memory and in a portable cluster, its tiles
    cover every output row once and its slices every expanded channel once,
    and at the main path's batch it fills the 132 SMs of an H100."""
    H, C_in, E, C_out = shape
    plan = t_block.plan_launch(B, H, H, C_in, E, C_out)
    assert plan.smem <= 227 * 1024 and 1 <= plan.cluster <= 8
    assert plan.smem == t_block._layout_bytes(plan.rows, H, H, C_in, E,
                                              C_out, plan.cluster)
    tiles = plan.tiles(H)
    rows = [r for r0, r1 in tiles for r in range(r0, r1)]
    assert rows == list(range(H))
    slices = plan.slices(E)
    assert len(slices) == plan.cluster
    channels = [c for e0, e1 in slices for c in range(e0, e1)]
    assert channels == list(range(E))
    assert all(e1 > e0 and (e1 - e0) % 16 == 0 for e0, e1 in slices)
    assert plan.blocks == B * len(tiles) * plan.cluster
    if B == 8:
        assert plan.blocks >= 132


def test_launch_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match='no launch plan fits'):
        t_block.plan_launch(1, 4, 4000, 160, 960, 320)
    with pytest.raises(ValueError, match='multiples'):
        t_block.plan_launch(8, 10, 10, 20, 960, 320)


# the tolerances of chip_smoke.py: bf16 outputs, two ulps relative
KERNEL_RTOL, KERNEL_ATOL, KERNEL_MEAN_ATOL = 2.0 ** -6, 1e-2, 1e-3


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version at the main path's shapes
    and two odd H, batch 1, 8 and 32, with and without the residual, bf16
    and f32 input (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    device = torch.device('cuda', 0)
    for H, C_in, E, C_out in PLAN_SHAPES:
        for B in (1, 8, 32):
            x, weights = _operands(H + B, B, H, H, C_in, E, C_out)
            wt = [torch.from_numpy(w).to(device) for w in weights]
            for i in (0, 2, 4):
                wt[i] = wt[i].to(torch.bfloat16)
            for dtype in (torch.bfloat16, torch.float32):
                xt = torch.from_numpy(x).to(device, dtype)
                for residual in {False, C_in == C_out}:
                    got = t_block.fused_inverted_residual(
                        xt, *wt, residual=residual)
                    want = t_block.fused_inverted_residual_plain(
                        xt, *wt, residual=residual)
                    assert got.dtype == dtype
                    diff = (got.float() - want.float()).abs()
                    bound = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
                    where = (H, C_in, E, C_out, B, dtype, residual)
                    assert bool((diff <= bound).all()), where
                    assert float(diff.mean()) < KERNEL_MEAN_ATOL, where


def test_cudnn_yardstick_computes_the_block():
    """workload.cudnn_block, which chip_smoke.py times beside the kernel,
    computes the fused block: three bf16 convolutions with the clamps."""
    from watsor_tpu_torch.workload import cudnn_block
    x, weights = _operands(3, 2, 7, 7, 16, 96, 16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = [torch.from_numpy(w) for w in weights]
    for i in (0, 2, 4):
        wt[i] = wt[i].to(torch.bfloat16)
    for residual in (False, True):
        got = cudnn_block(xt, *wt, residual)().permute(0, 2, 3, 1).float()
        want = t_block.fused_inverted_residual_plain(
            xt, *wt, residual=residual).float()
        # bf16 convolution outputs and bf16 biases: a few bf16 ulps
        assert float((got - want).abs().max()) < 0.1
        assert float((got - want).abs().mean()) < 1e-2
