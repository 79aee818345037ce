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


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version, bf16, at three of the
    main path's shapes (run on the card: pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    device = torch.device('cuda', 0)
    for shape in ((75, 75, 24, 144, 24), (19, 19, 64, 384, 96),
                  (10, 10, 160, 960, 320)):
        H, W, C_in, E, C_out = shape
        x, weights = _operands(2, 4, H, W, C_in, E, C_out)
        xt = torch.from_numpy(x).to(device, torch.bfloat16)
        wt = [torch.from_numpy(w).to(device) for w in weights]
        for i in (0, 2, 4):
            wt[i] = wt[i].to(torch.bfloat16)
        residual = C_in == C_out
        got = t_block.fused_inverted_residual(xt, *wt, residual=residual)
        want = t_block.fused_inverted_residual_plain(xt, *wt,
                                                     residual=residual)
        diff = (got.float() - want.float()).abs()
        # bf16 outputs: two ulps relative on top of the plain bound
        assert bool((diff <= ATOL + 2 ** -6 * want.float().abs()).all())
        assert float(diff.mean()) < 1e-3
