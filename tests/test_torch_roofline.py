"""The port's roofline accounting (watsor_tpu_torch/roofline.py) against
the JAX package's (watsor_tpu/roofline.py): the same rows for the same
inputs and peaks, the card's peaks from one table, and ``step_cost``'s
FLOPs (FlopCounterMode) and byte floor."""

import pytest
import torch

from watsor_tpu import roofline as jax_roofline
from watsor_tpu_torch import workload
from watsor_tpu_torch.roofline import device_peaks, roofline_row, step_cost

H100_SXM = 'NVIDIA H100 80GB HBM3'


class _FakeDevice:
    device_kind = 'cpu'


@pytest.fixture
def no_override(monkeypatch):
    monkeypatch.delenv('WATSOR_PEAK_TFLOPS', raising=False)
    monkeypatch.delenv('WATSOR_PEAK_GBPS', raising=False)


@pytest.fixture
def card_named(monkeypatch):
    """torch.cuda.get_device_name answering ``name`` for any device."""
    def named(name):
        monkeypatch.setattr(torch.cuda, 'get_device_name',
                            lambda device=None: name)
    return named


def test_device_peaks_h100_sxm(no_override, card_named):
    card_named(H100_SXM)
    assert device_peaks(torch.device('cuda', 0)) == (989.0, 3350.0)
    assert device_peaks('cuda') == (workload.PEAK_OPS_S['bf16'] / 1e12,
                                    workload.HBM_BYTES_S / 1e9)


@pytest.mark.parametrize('name', ['NVIDIA H100 PCIe', 'NVIDIA H100 NVL',
                                  'NVIDIA A100-SXM4-80GB'])
def test_device_peaks_unknown_cards_and_the_cpu(no_override, card_named,
                                                name):
    """Another part, even another H100, is unknown, and so is the CPU."""
    card_named(name)
    assert device_peaks(torch.device('cuda', 0)) == (None, None)
    assert device_peaks('cpu') == (None, None)


def test_device_peaks_env_override(monkeypatch):
    monkeypatch.setenv('WATSOR_PEAK_TFLOPS', '100')
    monkeypatch.setenv('WATSOR_PEAK_GBPS', '500')
    assert device_peaks('cpu') == (100.0, 500.0)


@pytest.mark.parametrize('case', [
    ('m', 32, 10.0, 1e9, 1e9),          # memory bound
    ('m', 1, 1.0, 1e12, 1e9),           # compute bound
    ('ssd', 8, 2.345678, 3.1e10, None),  # no byte count
    ('ssd', 8, 2.0, None, 1e8)])        # no FLOP count
def test_roofline_row_equals_the_jax_package(monkeypatch, case):
    """With the peaks set through the override, the same keys, values and
    rounding as watsor_tpu.roofline.roofline_row."""
    monkeypatch.setenv('WATSOR_PEAK_TFLOPS', '989')
    monkeypatch.setenv('WATSOR_PEAK_GBPS', '3350')
    got = roofline_row(*case, 'cpu')
    assert got == jax_roofline.roofline_row(*case, _FakeDevice())
    if case[3] and case[4]:
        assert got['bound'] == ('memory' if case[2] == 10.0 else 'compute')


def test_roofline_row_on_the_h100_sxm(no_override, card_named):
    """1 GFLOP and 1 GB in 10 ms on the card: memory bound, the speed of
    light 1 GB over 3.35 TB/s."""
    card_named(H100_SXM)
    row = roofline_row('m', 32, 10.0, 1e9, 1e9, torch.device('cuda', 0))
    assert row['bound'] == 'memory'
    assert row['speed_of_light_ms'] == pytest.approx(1000.0 / 3350.0,
                                                     abs=5e-4)
    assert row['pct_peak_bw'] == pytest.approx(100.0 / 3350.0 * 100,
                                               abs=0.05)


def test_roofline_row_unknown_device_omits_peaks(no_override):
    row = roofline_row('m', 8, 2.0, 1e9, 1e8, 'cpu')
    assert 'bound' not in row and 'pct_peak_bw' not in row
    assert row['achieved_tflops'] == 0.5
    assert row['gflops_per_frame'] == 0.12        # 0.125 at 2-dp rounding


def test_step_cost_counts_a_matmul():
    """[M, K] x [K, N]: 2 M N K FLOPs; bytes the two inputs and the output,
    each once, plus the parameters named."""
    M, K, N = 64, 96, 80
    a, b = torch.ones(M, K), torch.ones(K, N)
    bias = torch.ones(N)
    flops, nbytes = step_cost(lambda x, y: x @ y + bias, a, b,
                              params=[bias])
    assert flops == 2 * M * N * K
    assert nbytes == 4 * (M * K + K * N + M * N + N)


def test_step_cost_counts_convolutions_in_a_nested_output():
    x = torch.ones(2, 8, 16, 16)
    w = torch.ones(12, 8, 3, 3)

    def fn(x):
        y = torch.nn.functional.conv2d(x, w, padding=1)
        return {'y': y, 'pair': (y.sum(), None)}

    flops, nbytes = step_cost(fn, x)
    assert flops == 2 * 2 * 12 * 16 * 16 * 8 * 9
    assert nbytes == 4 * (x.numel() + 2 * 12 * 16 * 16 + 1)


def test_step_cost_returns_none_where_nothing_is_counted():
    assert step_cost(lambda x: x * 2, torch.ones(3))[0] is None
    assert step_cost(lambda: None) == (None, None)
