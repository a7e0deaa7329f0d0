"""repro_torch's int8 egress quantizer against repro's on the CPU.

The same numpy float32 vectors go through the reference's public, jitted
``repro.kernels.quantize_egress`` and the port's ``quantize_egress`` (its
plain PyTorch version on a CPU tensor): int8 codes and the bits of the
float32 scales must be equal, including the zero, subnormal, half-way tie
and ±127 clamp blocks.  The kernel is held against the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
import repro_torch.kernels as tk
from chip_smoke import quantizer_edge_cases
from repro_torch import obs
from repro_torch.kernels.quantize import FLT_MIN, INV_127, quantize_egress_plain
from torch_groups import torch_threads  # noqa: F401


def _lognormal(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=m) * rng.lognormal(0, 2, size=m)).astype(np.float32)


def _both(x: np.ndarray, block: int = 256):
    ref = rk.quantize_egress(jnp.asarray(x), block=block)
    got = tk.quantize_egress(torch.from_numpy(x), block=block)
    return ref, got


def _same(ref, got):
    q, s, mp = ref
    np.testing.assert_array_equal(np.asarray(q), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(s).view(np.uint32), got[1].numpy().view(np.uint32))
    assert got[2] == int(mp) and isinstance(got[2], int)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32


@pytest.mark.parametrize("block", [256, 64, 100])
@pytest.mark.parametrize("m", [256, 300, 8192, 100_000, 1 << 20])
def test_plain_matches_jitted_reference_bit_for_bit(m, block):
    _same(*_both(_lognormal(m, m + block), block))


@pytest.mark.parametrize("block", [256, 64])
def test_edge_blocks_match_reference(block):
    """All-zero and -0.0, subnormal (amax 1e-37 and ±1e-40), a subnormal
    beside the smallest normal scale, ties under scale 1, ±127 clamps."""
    x = quantizer_edge_cases()
    (q, s, _), got = _both(x, block)
    _same((q, s, _), got)
    if block == 256:
        s = np.asarray(s)
        q = np.asarray(q).reshape(-1, 256)
        assert s[0] == s[1] == s[2] == 0.0 and not q[:3].any()  # flushed
        assert 0 < s[3] < 1.2e-38 and q[3, 1] == 0  # the subnormal element counts as 0
        assert s[4] == 1.0
        ties = np.arange(254) - 126.5
        np.testing.assert_array_equal(q[4, :254], np.round(ties))  # half to even
        assert (q[4, 254], q[4, 255]) == (-127, 127)
        assert q[5].min() == -127 and q[5].max() <= 127


def test_ties_at_the_references_own_scale():
    """Half-way codes built from the scale the reference itself computes."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    _, s, _ = rk.quantize_egress(jnp.asarray(x.reshape(-1)))
    s = np.asarray(s)
    n = rng.integers(-120, 120, size=(64, 200)) + np.float32(0.5)
    ties = (n * s[:, None]).astype(np.float32)
    exact = (ties / s[:, None]).astype(np.float32) == n  # x / scale is exactly .5
    x[:, 1:201] = np.where(exact, ties, x[:, 1:201])
    x[:, 0] = np.abs(x).max(axis=1)  # keep each block's amax (so its scale)
    assert exact.sum() > 1000
    _same(*_both(x.reshape(-1)))


def test_scale_is_amax_times_float32_reciprocal_not_ieee_division():
    """The jitted reference's scale is amax * float32(1/127), which differs
    from amax / 127 by one ulp in some blocks; the port follows it."""
    x = _lognormal(1 << 20, 0).reshape(-1, 256)
    (_, s, _), (_, ts, _) = _both(x.reshape(-1))
    amax = np.abs(x).max(axis=1)
    ieee = amax / np.float32(127)
    mult = amax * np.float32(INV_127)
    assert (ieee != np.asarray(s)).sum() > 0
    np.testing.assert_array_equal(mult.view(np.uint32), np.asarray(s).view(np.uint32))
    np.testing.assert_array_equal(mult.view(np.uint32), ts.numpy().view(np.uint32))
    assert np.float32(INV_127) == np.float32(1) / np.float32(127)


def test_roundtrip_error_bound():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4096,)).astype(np.float32)
    q, s, _ = tk.quantize_egress(torch.from_numpy(x))
    deq = (q.to(torch.float32).reshape(-1, 256) * s[:, None]).reshape(-1)[:4096].numpy()
    amax_per_block = np.abs(x).reshape(-1, 256).max(1)
    err = np.abs(deq - x).reshape(-1, 256).max(1)
    assert (err <= amax_per_block / 127.0 * 0.5 + 1e-7).all()


@pytest.mark.parametrize("m,block", [(0, 256), (1, 256), (255, 256), (256, 256), (257, 64),
                                     (1001, 100)])
def test_padded_size_is_an_int_and_pads_with_zeros(m, block):
    ref, got = _both(_lognormal(m, 11), block)
    _same(ref, got)
    assert got[2] == -(-m // block) * block
    assert got[0].shape == (got[2],) and got[1].shape == (got[2] // block,)
    assert not got[0][m:].any()


def test_dispatch_contract():
    x = torch.from_numpy(_lognormal(1000, 2))
    with obs.collect() as reg:
        q, s, mp = tk.quantize_egress(x, block=64)
    assert reg.value("kernel.dispatch.calls", entry="quantize_egress", backend="torch") == 1
    assert torch.equal(q, tk.quantize_egress(x, block=64, backend="torch")[0])
    # the plain version takes any float dtype, as the reference's astype
    q64 = tk.quantize_egress(x.to(torch.float64), block=64)
    assert torch.equal(q64[0], q) and torch.equal(q64[1], s)
    with pytest.raises(ValueError, match="flat"):
        tk.quantize_egress(x.reshape(10, 100))
    with pytest.raises(ValueError, match="block"):
        tk.quantize_egress(x, block=0)
    with pytest.raises(ValueError, match="backend"):
        tk.quantize_egress(x, backend="cuda")
    assert FLT_MIN == np.finfo(np.float32).tiny
    # the plain twin alone: the same codes as the entry point
    assert torch.equal(quantize_egress_plain(x, block=64)[0], q)
