"""repro_torch.core against repro.core on the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX
function and its PyTorch counterpart.  Integer outputs are compared
bit-exact; the area model is pure Python in both packages and compared
exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import coding as rcoding
from repro_torch.core import coding as tcoding
from torch_groups import torch_threads  # noqa: F401


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _eq(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    assert tx.dtype == torch.int32 or str(np.asarray(jx).dtype) != "int32"


EDGE_BYTES = np.array([0, 1, 2, 3, 15, 16, 127, 128, 129, 254, 255], np.uint8)


@pytest.mark.parametrize("width", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int8])
def test_popcount_and_lut4_match_reference(width, dtype):
    rng = np.random.default_rng(width * 7 + np.dtype(dtype).itemsize)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, (37, 11), endpoint=True).astype(dtype)
    a[0, : len(EDGE_BYTES)] = EDGE_BYTES.astype(dtype)
    ja, ta = _both(a)
    want = np.asarray(rc.popcount(ja, width))
    for fn in (tc.popcount, tc.popcount_lut4):
        got = fn(ta, width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(rc.popcount_lut4(ja, width)), want)


def test_popcount_rejects_bad_width():
    for w in (0, 33):
        with pytest.raises(ValueError):
            tc.popcount(torch.zeros(3, dtype=torch.int32), w)


@pytest.mark.parametrize("width,k", [(8, 4), (8, 2), (8, 9), (4, 2), (4, 5), (16, 8)])
def test_bucket_map_and_boundaries(width, k):
    p = np.arange(width + 1, dtype=np.int32)
    jp, tp = _both(p)
    _eq(rc.bucket_map(jp, width, k), tc.bucket_map(tp, width, k))
    assert tc.bucket_boundaries(width, k) == rc.bucket_boundaries(width, k)
    assert tc.num_bucket_bits(k) == rc.num_bucket_bits(k)
    with pytest.raises(ValueError):
        tc.bucket_map(tp, width, width + 2)


@pytest.mark.parametrize("n", [8, 25, 49, 64])
@pytest.mark.parametrize("width", [4, 8])
def test_counting_sort_and_orders(n, width):
    rng = np.random.default_rng(n * 10 + width)
    a = rng.integers(0, 256, (19, n), dtype=np.uint8)
    ja, ta = _both(a)
    keys = np.asarray(rc.popcount(ja, width))
    jk, tk = _both(keys)
    _eq(rc.counting_sort_ranks(jk, width + 1), tc.counting_sort_ranks(tk, width + 1))
    _eq(rc.counting_sort_indices(jk, width + 1), tc.counting_sort_indices(tk, width + 1))
    for desc in (False, True):
        _eq(rc.acc_sort_indices(ja, width, desc), tc.acc_sort_indices(ta, width, desc))
    for k, desc in ((2, False), (4, False), (4, True), (8, False)):
        if k <= width + 1:
            _eq(rc.app_sort_indices(ja, width, k, desc), tc.app_sort_indices(ta, width, k, desc))
    order = rc.acc_sort_indices(ja, width)
    got = tc.apply_order(ta, torch.from_numpy(np.array(order)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rc.apply_order(ja, order)))


def test_invert_permutation_matches_reference():
    rng = np.random.default_rng(3)
    perm = np.stack([rng.permutation(25) for _ in range(9)]).astype(np.int32)
    jp, tp = _both(perm)
    _eq(rc.invert_permutation(jp), tc.invert_permutation(tp))


@pytest.mark.parametrize("shape", [(1, 16), (2, 8), (300, 16), (257, 5)])
@pytest.mark.parametrize("width", [4, 8])
def test_bit_transitions_and_report(shape, width):
    rng = np.random.default_rng(shape[0] + width)
    s = rng.integers(0, 256, shape, dtype=np.uint8)
    js, ts = _both(s)
    got = tc.bit_transitions(ts, width)
    assert got.dtype == torch.int32
    assert int(got) == int(rc.bit_transitions(js, width))
    assert float(tc.bt_per_flit(ts, width)) == float(rc.bt_per_flit(js, width))
    lanes = shape[1] // 2
    jr, tr = rc.bt_report(js, lanes, width), tc.bt_report(ts, lanes, width)
    for a, b in zip(jr, tr):
        assert float(a) == float(b)
    base_t = tc.bt_report(torch.roll(ts, 1, 0), lanes, width)
    base_j = rc.bt_report(jnp.roll(js, 1, 0), lanes, width)
    np.testing.assert_array_equal(  # NaN on both sides for a 1-flit stream
        float(tr.reduction_vs(base_t)), float(jr.reduction_vs(base_j))
    )


def test_bit_transitions_wraps_like_int32():
    big = np.full(3, 2**31 - 1, dtype=np.int32)
    want = int(big.sum(dtype=np.int32))  # numpy's int32 sum wraps
    assert int(tc.bt.wrap_int32(torch.from_numpy(big).sum(dtype=torch.int64))) == want


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_byte_codings_match_reference(dtype):
    a = np.arange(256).astype(np.uint8).astype(dtype).reshape(16, 16)
    ja, ta = _both(a)
    for name in (
        "gray_encode_bytes",
        "gray_decode_bytes",
        "sign_magnitude_encode_bytes",
        "sign_magnitude_decode_bytes",
    ):
        got = getattr(tcoding, name)(ta)
        assert got.dtype == ta.dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(rcoding, name)(ja)))
    for enc, dec in (("gray_encode_bytes", "gray_decode_bytes"),
                     ("sign_magnitude_encode_bytes", "sign_magnitude_decode_bytes")):
        back = getattr(tcoding, dec)(getattr(tcoding, enc)(ta))
        assert torch.equal(back, ta)


@pytest.mark.parametrize("lanes,partition", [(16, None), (16, 4), (8, 8), (8, 2)])
def test_bus_invert_partitions(lanes, partition):
    assert tcoding.bus_invert_partitions(lanes, partition) == rcoding.bus_invert_partitions(
        lanes, partition
    )
    with pytest.raises(ValueError):
        tcoding.bus_invert_partitions(lanes, 3)


@pytest.mark.parametrize("n", [8, 25, 49, 64, 100])
@pytest.mark.parametrize("width", [4, 8, 16])
def test_area_and_timing_models_equal(n, width):
    def same(a, b):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)

    for k in (None, 2, 4):
        same(tc.psu_area(n, width, k), rc.psu_area(n, width, k))
        same(tc.psu_timing(n, width, k), rc.psu_timing(n, width, k))
    same(tc.bitonic_area(n, width), rc.bitonic_area(n, width))
    same(tc.csn_area(n, width), rc.csn_area(n, width))
    same(tc.bitonic_timing(n), rc.bitonic_timing(n))
    assert tc.psu_timing(n, width).sort_time_ns(n) == rc.psu_timing(n, width).sort_time_ns(n)


def test_codec_area_and_anchors_equal():
    assert tc.AREA_ANCHORS == rc.AREA_ANCHORS
    for scheme in ("none", "gray", "sign_magnitude", "transition"):
        assert tc.codec_area(scheme, 16) == rc.codec_area(scheme, 16)
    for part in (None, 4, 8):
        assert tc.codec_area("bus_invert", 16, part) == rc.codec_area("bus_invert", 16, part)
    with pytest.raises(ValueError):
        tc.codec_area("bogus", 16)
    acc, app = tc.psu_area(25), tc.psu_area(25, k=4)
    assert round(100 * (1 - app.total / acc.total), 1) == 35.4
