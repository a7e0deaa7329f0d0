"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Needs a CUDA device and ``nvcc``; without a device every test
here skips.  On the GPU machine, which has no JAX, this file runs alone:

    python -m pytest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.psu import MAX_N, psu_sort_cuda
from torch_groups import torch_threads  # noqa: F401


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only there)")
    return torch.device("cuda")


def _packets(dev, shape, seed, dtype=np.uint8, hi=256):
    a = np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("n", [1, 2, 8, 16, 25, 31, 32, 33, 49, 64, 128, 1024])
def test_psu_sort_kernel_matches_plain(dev, n):
    x = _packets(dev, (1003, n), n)
    x32 = _packets(dev, (1003, n), n + 1, np.int32, 1 << 16)
    tk.reset_launch_counts()
    for width, k, desc in ((8, None, False), (8, 4, True), (4, 2, False), (16, 17, True)):
        for v in (x, x32):
            got = tk.psu_sort(v, width=width, k=k, descending=desc)
            ref = tk.psu_sort(v, width=width, k=k, descending=desc, backend="torch")
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tk.launch_counts()["psu_sort"] == 8
    with pytest.raises(ValueError, match=f"N <= {MAX_N}"):
        psu_sort_cuda(_packets(dev, (2, MAX_N + 1), 0))


# P against the kernel's tiles (16 KB of input: 1,024 packets of 16 bytes,
# 256 of 64, 16 of 1,024 or 1,023, 15 of 33 int32) and its persistent grid
# (a few blocks per SM, 132 SMs: about 1,000 tiles in flight, so 300,001
# packets of 64 bytes walk several tiles per block)
@pytest.mark.parametrize("n,p", [(16, 1), (16, 7 * 1024 + 3), (64, 255), (64, 300_001),
                                 (33, 4099), (1023, 33), (1024, 17)])
def test_psu_sort_kernel_tiles_and_grid(dev, n, p):
    tk.reset_launch_counts()
    for dtype, hi in ((np.uint8, 256), (np.int32, 1 << 16)):
        flat = _packets(dev, (p * n + 1,), n + p, dtype, hi)
        # a contiguous view one element past an aligned base: the kernel's
        # unaligned (element-wise) load path
        for x in (flat[: p * n].view(p, n), flat[1:].view(p, n)):
            for k, desc in ((None, False), (4, True)):
                got = tk.psu_sort(x, k=k, descending=desc)
                ref = tk.psu_sort(x, k=k, descending=desc, backend="torch")
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), (dtype, k, desc)
    assert tk.launch_counts()["psu_sort"] == 8


@pytest.mark.parametrize("n,lanes,paired", [(32, 8, True), (64, 16, False), (25, 5, True)])
@pytest.mark.parametrize("pack", ["lane", "row"])
def test_psu_stream_kernel_matches_plain(dev, n, lanes, paired, pack):
    x = _packets(dev, (1003, n), n)
    w = _packets(dev, (1003, n), n + 1) if paired else None
    for k, desc in ((None, False), (4, True), (8, False)):
        kw = dict(k=k, descending=desc, input_lanes=lanes, pack=pack)
        got, ref = tk.psu_stream(x, w, **kw), tk.psu_stream(x, w, backend="torch", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        # the stream's BT is what bt_count measures on each side of it
        assert torch.equal(got.bt_input, tk.bt_count(got.stream[:, :lanes]))


def _stream_tile(n, isz, paired):
    """Packets in a full psu_stream tile (csrc/plan.h stream_plan: at most
    8 KB of x, a multiple of the 16-byte alignment quantum)."""
    q = 16 // math.gcd(16, n * min(isz, 2 if paired else 1))
    return max(q, 8192 // (n * isz) // q * q)


# P against the kernel's tiles and its persistent grid: one packet; a full
# tile - 1 and + 1 (small batches, cut to the smallest aligned tiles so
# that they spread over every SM: many one- or few-packet tiles,
# each with a tile boundary before it); 300,001 packets (full tiles,
# several a block, a ragged last one); 2,001 packets of 1,024 — uint8 and
# int32, aligned and one element past an aligned base (the element-wise
# load path), paired, zero weight lanes and input-only, both packs
@pytest.mark.parametrize("n,il", [(16, 8), (25, 5), (32, 8), (64, 16), (1024, 32)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_psu_stream_kernel_tiles_and_grid(dev, n, il, dtype):
    isz, hi = (1, 256) if dtype == np.uint8 else (4, 1 << 16)
    tile = _stream_tile(n, isz, True)
    tk.reset_launch_counts()
    calls = 0
    for p in (1, max(tile - 1, 1), tile + 1, 300_001 if n <= 64 else 2_001):
        fx = _packets(dev, (p * n + 1,), n + p, dtype, hi)
        fw = _packets(dev, (p * n + 1,), n + p + 1, dtype, hi)
        for off in (0, 1):
            x, w = fx[off: off + p * n].view(p, n), fw[off: off + p * n].view(p, n)
            for weights, wl in ((w, il), (None, il), (None, 0)):
                for pack in ("lane", "row"):
                    for width, k, desc in ((8, None, False), (16, 4, True)):
                        kw = dict(width=width, k=k, descending=desc, input_lanes=il,
                                  weight_lanes=wl, pack=pack)
                        got = tk.psu_stream(x, weights, **kw)
                        calls += 1
                        ref = tk.psu_stream(x, weights, backend="torch", **kw)
                        what = (p, off, wl, weights is None, pack, width, k, desc)
                        assert all(torch.equal(a, b) for a, b in zip(got, ref)), what
                        # each side's BT is what bt_count measures on it
                        bt_w = tk.bt_count(got.stream[:, il:]) if wl else torch.tensor(0)
                        assert torch.equal(got.bt_input, tk.bt_count(got.stream[:, :il])), what
                        assert int(got.bt_weight) == int(bt_w), what
    assert tk.launch_counts()["psu_stream"] == calls


@pytest.mark.parametrize("shape", [(2, 8), (4099, 16), (1000, 5), (777, 24)])
def test_bt_count_kernel_matches_plain(dev, shape):
    s8 = _packets(dev, shape, shape[0])
    s32 = _packets(dev, shape, shape[0] + 1, np.int32, 1 << 20)
    half = shape[1] // 2
    for width in (4, 8, 16):
        for v in (s8, s8[:, :half], s8[:, half:], s32, s32[:, half:]):
            ref = tk.bt_count(v, width=width, backend="torch")
            assert torch.equal(tk.bt_count(v, width=width), ref)


# the contiguous (flat) path: lane counts whose rows are and are not whole
# 16-byte words, streams one element past an aligned base (unaligned head
# and tail), uint8 and int32 at every width class; and T = 2, 3
@pytest.mark.parametrize("lanes", [1, 3, 8, 15, 16, 17, 24])
@pytest.mark.parametrize("t", [2, 3, 4099])
def test_bt_count_flat_layouts_match_plain(dev, lanes, t):
    tk.reset_launch_counts()
    calls = 0
    for dtype, hi in ((np.uint8, 256), (np.int32, 1 << 20)):
        flat = _packets(dev, (t * lanes + 1,), lanes + t, dtype, hi)
        for v in (flat[: t * lanes].view(t, lanes), flat[1:].view(t, lanes)):
            for width in (1, 7, 8, 12, 16):
                ref = tk.bt_count(v, width=width, backend="torch")
                assert torch.equal(tk.bt_count(v, width=width), ref), (dtype, v.storage_offset(),
                                                                       width)
                calls += 1
    assert tk.launch_counts()["bt_count"] == calls


# the row-strided path: column slices of both halves (at even and odd
# offsets), one-element rows, and short wide streams whose rows spread over
# a group of threads
@pytest.mark.parametrize("shape", [(4099, 16), (4099, 24), (3, 40), (2, 100_003), (4099, 2)])
def test_bt_count_strided_layouts_match_plain(dev, shape):
    s8 = _packets(dev, shape, shape[1])
    s32 = _packets(dev, shape, shape[1] + 1, np.int32, 1 << 20)
    half = shape[1] // 2
    for src in (s8, s32):
        for v in (src[:, :half], src[:, half:], src[:, 1:], src[:, 1: half + 1], src[:, :1]):
            for width in (1, 8, 16):
                ref = tk.bt_count(v, width=width, backend="torch")
                assert torch.equal(tk.bt_count(v, width=width), ref), (src.dtype, v.stride(),
                                                                       v.storage_offset(), width)


def test_bt_count_wraps_past_2_32(dev):
    """16 toggling bits in each of 256 lanes of 2**20 + 2**10 rows: the BT
    passes 2**32, and the int32 total wraps as the reference's does."""
    t = (1 << 20) + (1 << 10)
    s = torch.zeros((t, 256), dtype=torch.int32, device=dev)
    s[1::2] = 0xFFFF
    want = ((t - 1) * 256 * 16 + 2**31) % 2**32 - 2**31
    assert int(tk.bt_count(s, width=16)) == want == int(tk.bt_count(s, width=16, backend="torch"))
    s8 = s.to(torch.uint8)  # 8 bits a lane: the same total halved, contiguous and strided
    for v in (s8, s8[:, 1:]):
        assert torch.equal(tk.bt_count(v, width=16), tk.bt_count(v, width=16, backend="torch"))


def _axes_configs(lanes, width=8):
    """Every ordering (ACC / APP k in {2, 4, 8} x direction, none,
    column_major) crossed with every codec, bus-invert partitions None / 4 / 2
    (APP k past width + 1 left out)."""
    orderings = [("none", None, False), ("column_major", None, False), ("acc", None, False),
                 ("acc", None, True), ("app", 2, False), ("app", 4, True), ("app", 8, False)]
    codecs = [("none", None), ("gray", None), ("sign_magnitude", None), ("transition", None),
              ("bus_invert", None), ("bus_invert", 4), ("bus_invert", 2)]
    return tuple(tk.CodecVariant(*o, c, part) for o in orderings for c, part in codecs
                 if (part is None or lanes % part == 0) and (o[1] or 0) <= width + 1)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n,lanes,paired,pack", [(32, 8, True, "lane"), (64, 16, False, "row"),
                                                 (32, 8, False, "lane"), (32, 4, True, "row")])
def test_bt_axes_kernel_matches_plain(dev, width, n, lanes, paired, pack):
    links, p = 5, 301  # P is no multiple of the kernel's packets per block
    x = _packets(dev, (links, p, n), n + width)
    w = _packets(dev, (links, p, n), n + width + 1) if paired else None
    valid = torch.tensor([0, p, 1, 150, p + 40], device=dev)
    configs = _axes_configs(2 * lanes if paired else lanes, width)
    for chunk in (None, 1, 7):
        kw = dict(configs=configs, width=width, input_lanes=lanes, pack=pack, chunk_packets=chunk)
        tk.reset_launch_counts()
        got = tk.bt_count_axes(x, w, valid, **kw)
        assert tk.launch_counts()["bt_axes"] == (1 if chunk is None else -(-p // chunk))
        ref = tk.bt_count_axes(x, w, valid, backend="torch", **kw)
        assert torch.equal(got, ref), (chunk, (got != ref).nonzero()[:5].tolist())


def test_bt_axes_codec_path_shape(dev):
    """One link of 1,838 packets of 64 bytes on 16 input lanes, the codec
    path's shape: the wrapper splits it into small blocks to fill the card."""
    x = _packets(dev, (1, 1838, 64), 11)
    valid = torch.tensor([1838], device=dev)
    configs = _axes_configs(16) + (tk.CodecVariant("acc", None, False, "bus_invert", 1),)
    for chunk in (None, 1, 7):
        kw = dict(configs=configs, input_lanes=16, chunk_packets=chunk)
        got = tk.bt_count_axes(x, None, valid, **kw)
        ref = tk.bt_count_axes(x, None, valid, backend="torch", **kw)
        assert torch.equal(got, ref), (chunk, (got != ref).nonzero()[:5].tolist())


@pytest.mark.parametrize("p", [1, 3, 20])
def test_bt_axes_batches_below_one_block(dev, p):
    x = _packets(dev, (2, p, 32), p)
    w = _packets(dev, (2, p, 32), p + 1)
    valid = torch.tensor([p, p - 1], device=dev)
    # 16-lane flits: partitions of 1 lane give 16 invert lines, more than
    # the block's 8 warps
    configs = _axes_configs(16) + (tk.CodecVariant("app", 4, True, "bus_invert", 1),)
    for chunk in (None, 1, 7):
        kw = dict(configs=configs, input_lanes=8, chunk_packets=chunk)
        got = tk.bt_count_axes(x, w, valid, **kw)
        ref = tk.bt_count_axes(x, w, valid, backend="torch", **kw)
        assert torch.equal(got, ref), (chunk, (got != ref).nonzero()[:5].tolist())


def test_bt_axes_bus_invert_ties_across_segments_and_blocks(dev):
    """Flit rows whose data distance to the previous row is exactly half of
    every partition (XOR 0x0f per lane), beside rows that flip (0x1f) or
    keep (0x01): ties force state 0 wherever warp segments and blocks meet.
    32 links of 1,024 packets keep 128 packets (512 rows) per block."""
    rng = np.random.default_rng(5)
    links, p, lanes, flits = 32, 1024, 16, 4
    steps = rng.choice(np.array([0x0F, 0x0F, 0x0F, 0x1F, 0x01, 0x00], np.uint8),
                       size=(links, p * flits, 1))
    start = rng.integers(0, 256, (links, 1, lanes), dtype=np.uint8)
    rows = np.bitwise_xor.accumulate(
        np.concatenate([start, np.broadcast_to(steps, (links, p * flits, lanes))], axis=1),
        axis=1)[:, 1:]
    x = torch.from_numpy(np.ascontiguousarray(rows).reshape(links, p, flits * lanes)).to(dev)
    valid = torch.from_numpy(rng.integers(0, p + 1, links)).to(dev)
    valid[:2] = p
    configs = tuple(tk.CodecVariant(key, None, False, codec, part)
                    for key in ("none", "column_major")
                    for codec, part in (("none", None), ("bus_invert", None), ("bus_invert", 8),
                                        ("bus_invert", 4), ("bus_invert", 2),
                                        ("bus_invert", 1)))
    for chunk in (None, 1, 7):
        kw = dict(configs=configs, input_lanes=lanes, pack="row", chunk_packets=chunk)
        got = tk.bt_count_axes(x, None, valid, **kw)
        ref = tk.bt_count_axes(x, None, valid, backend="torch", **kw)
        assert torch.equal(got, ref), (chunk, (got != ref).nonzero()[:5].tolist())
    assert int(got[:, 1::6, 2].sum()) > 0  # the invert lines did toggle


@pytest.mark.parametrize("n,lanes", [(24, 12), (20, 4), (40, 8)])
def test_bt_axes_paired_packets_of_odd_16_byte_blocks(dev, n, lanes):
    """Paired byte packets whose block of packets is no whole number of
    16-byte words (vp * N % 16 != 0): the weights' shared-memory copy must
    still take only aligned 16-byte stores."""
    x = _packets(dev, (4, 203, n), n)
    w = _packets(dev, (4, 203, n), n + 1)
    valid = torch.tensor([203, 7, 1, 150], device=dev)
    configs = _axes_configs(2 * lanes)
    for chunk in (None, 3):
        kw = dict(configs=configs, input_lanes=lanes, chunk_packets=chunk)
        got = tk.bt_count_axes(x, w, valid, **kw)
        assert torch.equal(got, tk.bt_count_axes(x, w, valid, backend="torch", **kw))


def test_bt_axes_entry_points_and_int32_payloads(dev):
    streams = _packets(dev, (6, 999, 16), 3)
    lengths = torch.tensor([999, 0, 2, 500, 1, 2000], device=dev)
    got = tk.bt_count_links(streams, 10, lengths)
    assert torch.equal(got, tk.bt_count_links(streams, 10, lengths, backend="torch"))
    x32 = _packets(dev, (700, 32), 4, np.int32, 1 << 16)
    w32 = _packets(dev, (700, 32), 5, np.int32, 1 << 16)
    for width in (8, 12, 16):
        kw = dict(configs=_axes_configs(16, width), width=width)
        got = tk.bt_count_codecs(x32, w32, **kw)
        assert torch.equal(got, tk.bt_count_codecs(x32, w32, backend="torch", **kw))
    variants = (tk.Variant("acc"), tk.Variant("app", 4, True), tk.Variant("none"))
    got = tk.bt_count_variants(x32, w32, variants, chunk_packets=64)
    assert torch.equal(got, tk.bt_count_variants(x32, w32, variants, backend="torch"))


@pytest.mark.parametrize("window", [1, 7, 64])
@pytest.mark.parametrize("width,n,lanes,paired,pack", [(8, 32, 8, True, "lane"),
                                                       (4, 64, 16, False, "row"),
                                                       (8, 32, 4, True, "row")])
def test_bt_axes_activity_kernel_matches_plain(dev, window, width, n, lanes, paired, pack):
    links, p = 5, 301  # P is no multiple of the kernel's packets per block
    x = _packets(dev, (links, p, n), n + width + window)
    w = _packets(dev, (links, p, n), n + width + 1) if paired else None
    valid = torch.tensor([0, p, 1, 150, p + 40], device=dev)
    configs = _axes_configs(2 * lanes if paired else lanes, width)
    kw = dict(configs=configs, width=width, input_lanes=lanes, pack=pack,
              activity_windows=window)
    ref = tk.bt_count_axes(x, w, valid, backend="torch", **kw)
    for chunk in (None, 1, 7):
        tk.reset_launch_counts()
        got = tk.bt_count_axes(x, w, valid, chunk_packets=chunk, **kw)
        counts = tk.launch_counts()
        assert counts["bt_axes_activity"] == (1 if chunk is None else -(-p // chunk))
        assert counts["bt_axes"] == 0
        for field, a, b in zip(ref._fields, ref, got):
            assert torch.equal(a, b), (chunk, field, (a != b).nonzero()[:5].tolist())


@pytest.mark.parametrize("window", [512, 1, 33])
def test_bt_axes_activity_windows_across_blocks(dev, window):
    """The codec path's shape (16 packets = 64 flit rows a block): windows
    longer than a block, one-row windows at every block edge, and chunks of
    7 packets, whose first rows (28 k) are no multiple of the window."""
    x = _packets(dev, (1, 1838, 64), 11 + window)
    valid = torch.tensor([1838], device=dev)
    configs = _axes_configs(16) + (tk.CodecVariant("acc", None, False, "bus_invert", 1),)
    kw = dict(configs=configs, input_lanes=16, activity_windows=window)
    ref = tk.bt_count_axes(x, None, valid, backend="torch", **kw)
    for chunk in (None, 7):
        got = tk.bt_count_axes(x, None, valid, chunk_packets=chunk, **kw)
        for field, a, b in zip(ref._fields, ref, got):
            assert torch.equal(a, b), (chunk, field, (a != b).nonzero()[:5].tolist())


def test_bt_axes_activity_bus_invert_ties_across_segments_and_blocks(dev):
    """test_bt_axes_bus_invert_ties_across_segments_and_blocks's rows (data
    distances of exactly half a partition beside flips and keeps) in the
    activity mode: the invert states at every 32-row step and block edge."""
    rng = np.random.default_rng(5)
    links, p, lanes, flits = 32, 1024, 16, 4
    steps = rng.choice(np.array([0x0F, 0x0F, 0x0F, 0x1F, 0x01, 0x00], np.uint8),
                       size=(links, p * flits, 1))
    start = rng.integers(0, 256, (links, 1, lanes), dtype=np.uint8)
    rows = np.bitwise_xor.accumulate(
        np.concatenate([start, np.broadcast_to(steps, (links, p * flits, lanes))], axis=1),
        axis=1)[:, 1:]
    x = torch.from_numpy(np.ascontiguousarray(rows).reshape(links, p, flits * lanes)).to(dev)
    valid = torch.from_numpy(rng.integers(0, p + 1, links)).to(dev)
    valid[:2] = p
    configs = tuple(tk.CodecVariant(key, None, False, codec, part)
                    for key in ("none", "column_major")
                    for codec, part in (("none", None), ("bus_invert", None), ("bus_invert", 8),
                                        ("bus_invert", 4), ("bus_invert", 2),
                                        ("bus_invert", 1)))
    for window in (32, 5):
        kw = dict(configs=configs, input_lanes=lanes, pack="row", activity_windows=window)
        ref = tk.bt_count_axes(x, None, valid, backend="torch", **kw)
        for chunk in (None, 7):
            got = tk.bt_count_axes(x, None, valid, chunk_packets=chunk, **kw)
            for field, a, b in zip(ref._fields, ref, got):
                assert torch.equal(a, b), (window, chunk, field, (a != b).nonzero()[:5].tolist())
    assert int(ref.toggles[:, 1::6, :, lanes * 8:].sum()) > 0  # the invert lines did toggle


# every partition count of a 24-lane paired flit (partitions that straddle
# 32-bit words among them) and of a 40-lane one (two words of invert lines)
@pytest.mark.parametrize("n,il,paired,parts", [
    (24, 12, True, (None, 12, 8, 6, 4, 3, 2, 1)),
    (80, 40, False, (None, 20, 10, 8, 5, 4, 2, 1)),
])
def test_bt_axes_activity_every_partition_count(dev, n, il, paired, parts):
    x = _packets(dev, (3, 301, n), n)
    w = _packets(dev, (3, 301, n), n + 1) if paired else None
    valid = torch.tensor([301, 13, 0], device=dev)
    configs = tuple(tk.CodecVariant(*o, "bus_invert", part)
                    for o in (("none", None, False), ("app", 4, True)) for part in parts)
    kw = dict(configs=configs, input_lanes=il, activity_windows=9)
    ref = tk.bt_count_axes(x, w, valid, backend="torch", **kw)
    for chunk in (None, 7):
        got = tk.bt_count_axes(x, w, valid, chunk_packets=chunk, **kw)
        for field, a, b in zip(ref._fields, ref, got):
            assert torch.equal(a, b), (chunk, field, (a != b).nonzero()[:5].tolist())


def test_bt_axes_activity_entry_points_and_int32_payloads(dev):
    streams = _packets(dev, (6, 999, 16), 3)
    lengths = torch.tensor([999, 0, 2, 500, 1, 2000], device=dev)
    for chunk in (None, 100):
        got = tk.bt_count_links(streams, 10, lengths, chunk_rows=chunk, activity_windows=32)
        ref = tk.bt_count_links(streams, 10, lengths, backend="torch", activity_windows=32)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    x32 = _packets(dev, (700, 32), 4, np.int32, 1 << 16)
    w32 = _packets(dev, (700, 32), 5, np.int32, 1 << 16)
    for width in (8, 12):
        kw = dict(configs=_axes_configs(16, width), width=width, activity_windows=50)
        got = tk.bt_count_codecs(x32, w32, **kw)
        ref = tk.bt_count_codecs(x32, w32, backend="torch", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        # every wire's toggles sum to the config's gross BT
        assert torch.equal(got.toggles.sum((1, 2)), got.bt.sum(-1))


@pytest.mark.parametrize("block", [256, 64, 100])
@pytest.mark.parametrize("m", [1, 255, 256, 300, 100_003])
def test_quantize_egress_kernel_matches_plain(dev, m, block):
    from chip_smoke import quantizer_edge_cases

    rng = np.random.default_rng(m + block)
    x = (rng.normal(size=m + 1) * rng.lognormal(0, 2, size=m + 1)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    edges = torch.from_numpy(quantizer_edge_cases()).to(dev)
    tk.reset_launch_counts()
    for v in (xt[:m], xt[1:], edges):  # xt[1:] is not 16-byte aligned
        q, s, mp = tk.quantize_egress(v, block=block)
        rq, rs, rmp = tk.quantize_egress(v, block=block, backend="torch")
        assert mp == rmp == -(-v.shape[0] // block) * block
        assert torch.equal(q, rq)
        assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    assert tk.launch_counts()["quantize_egress"] == 3


def test_egress_permutation_on_cuda_matches_plain(dev):
    from repro_torch.traffic import egress_permutation

    w = _packets(dev, (64 * 1000 + 37,), 9).view(torch.int8)
    for strategy, k in (("app", 4), ("acc", 4), ("none", 2), ("app", 9)):
        for packet in (64, 48, 1024):
            tk.reset_launch_counts()
            perm, inv = egress_permutation(w, packet=packet, strategy=strategy, k=k)
            assert tk.launch_counts()["psu_sort"] == 1
            rp, ri = egress_permutation(w, packet=packet, strategy=strategy, k=k,
                                        backend="torch")
            assert perm.device.type == "cuda" and perm.dtype == torch.int32
            assert torch.equal(perm, rp) and torch.equal(inv, ri)
    with pytest.raises(ValueError, match="packet"):
        egress_permutation(w, packet=1025)


# ------------------------------------------------------------ NoC and DSE


def _fabric_flows(dev, topo, spec, seed=0):
    """Unicasts and multicasts with shared prefixes, paired when the spec
    has weight lanes."""
    from repro_torch.noc import TrafficFlow

    far, mid = topo.num_routers - 1, topo.num_routers // 2
    ends = [(0, (far,)), (0, (mid, far)), (1, (far,)), (mid, (0, 1, far))]
    return [
        TrafficFlow(f"f{i}", src, dsts,
                    _packets(dev, (30 + 17 * i, spec.elems_per_packet), seed + 2 * i),
                    _packets(dev, (30 + 17 * i, spec.weight_elems_per_packet), seed + 2 * i + 1)
                    if spec.weight_lanes else None)
        for i, (src, dsts) in enumerate(ends)
    ]


@pytest.mark.parametrize("key,sort_at,codec,windows", [
    ("none", "source", "none", None), ("acc", "source", "none", None),
    ("app", "hop", "bus_invert4", None), ("acc", "hop", "transition", 5),
    ("app", "source", "bus_invert", 32), ("column_major", "source", "gray", None),
])
def test_simulate_noc_on_card_matches_plain(dev, key, sort_at, codec, windows):
    import dataclasses

    from repro_torch import noc
    from repro_torch.link import LinkSpec

    topo, spec = noc.mesh(3, 3), LinkSpec(key=key, codec=codec)
    flows = _fabric_flows(dev, topo, spec)
    tk.reset_launch_counts()
    got = noc.simulate_noc(topo, flows, spec, sort_at=sort_at, activity_windows=windows)
    counts = tk.launch_counts()
    ref = noc.simulate_noc(topo, flows, spec, sort_at=sort_at, activity_windows=windows,
                           backend="torch")
    assert [dataclasses.astuple(s) for s in got.links] == [
        dataclasses.astuple(s) for s in ref.links]
    for a, b in zip(got.wire_toggles + got.wire_ones, ref.wire_toggles + ref.wire_ones):
        assert np.array_equal(a, b)
    want = {k: 0 for k in counts} | {"bt_axes_activity" if windows else "bt_axes": 1}
    want["psu_sort"] = int(key in ("acc", "app"))
    assert counts == want


def test_expand_fabric_on_card_matches_plain(dev):
    """Queued and identity (one flow a queue) fabrics: the streams, aux
    counts and invert lines of the CUDA source sort equal the plain ones."""
    from repro_torch import noc
    from repro_torch.link import LinkSpec

    for topo, spec, flows in (
        (noc.torus(3, 3), LinkSpec(key="app", codec="bus_invert4"), None),
        (noc.ring(8), LinkSpec(input_lanes=16, weight_lanes=0, key="acc"), "ring"),
    ):
        if flows is None:
            flows = _fabric_flows(dev, topo, spec, seed=7)
        else:
            flows = noc.ring_allreduce_flows(_packets(dev, (8 * 64 * 1001,), 3).view(torch.int8),
                                             topo, spec=spec)
        plan = noc.compile_fabric(topo, [(f.src, f.dsts) for f in flows])
        batch = noc.FlowBatch.from_flows(flows, spec)
        got = noc.expand_fabric(plan, batch, spec, sort_at="hop")
        ref = noc.expand_fabric(plan, batch, spec, sort_at="hop", backend="torch")
        assert got.lengths == ref.lengths and torch.equal(got.streams, ref.streams)
        for a, b in ((got.aux_bt, ref.aux_bt), (got.inverts, ref.inverts)):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


def test_evaluate_grid_on_card_matches_plain(dev):
    """Two key widths, codecs, a topology and wire-resolved activity: the
    evaluations equal the plain version's, one bt_axes launch per width."""
    import dataclasses

    from repro_torch import dse

    streams = (_packets(dev, (700, 64), 1), _packets(dev, (333, 64), 2))
    workload = dse.Workload("w", streams, lanes=16)
    points = dse.k_sweep(n=25, ks=(2, 4)) + (
        dse.DesignPoint(ordering="acc", k=None, codec="bus_invert4", topology="mesh4x4"),
        dse.DesignPoint(ordering="app", k=3, width=4, codec="transition"),
    )
    for windows in (None, 16):
        tk.reset_launch_counts()
        got = dse.evaluate_grid(points, workload, activity_windows=windows)
        counts = tk.launch_counts()
        ref = dse.evaluate_grid(points, workload, activity_windows=windows, backend="torch")
        assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in ref]
        assert counts["bt_axes_activity" if windows else "bt_axes"] == 2
    assert dse.grid_launch_count(points, workload) == 2
    assert dse.grid_launch_count(points[:-1], workload) == 1


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-1.2b"])
def test_serving_capture_on_card_holds_the_pins(dev, arch):
    """The serving path on the card: greedy tokens, stream names and the
    weight stream's bytes equal phase 3f's pins (the JAX package's), the
    captured bytes stay on the card, and the grid over them is one
    bt_axes launch equal to the plain version."""
    import dataclasses
    import hashlib

    from chip_smoke import SERVE, serve_grid, serve_smoke

    pin = SERVE["pins"][arch]
    _, _, sess, res = serve_smoke(arch, dev)
    (w,) = sess.get("serve_decode", "weights")
    assert w.data.device.type == "cuda"
    assert res.tokens.tolist() == pin["tokens"]
    assert [s.name for s in sess.streams] == pin["names"]
    assert hashlib.sha256(w.data.cpu().numpy().tobytes()).hexdigest() == pin["weights_sha256"]
    tk.reset_launch_counts()
    got = serve_grid(sess)
    assert tk.launch_counts()["bt_axes"] == 1
    ref = serve_grid(sess, backend="torch")
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in ref]
    assert {e.label: [e.total_bt, e.aux_bt] for e in got} == pin["grid"]


def test_capture_moe_dispatch_on_card(dev):
    """The MoE dispatch tap records on the card; a serving capture of the
    same config does not record it."""
    from repro_torch import obs
    from repro_torch.configs import smoke_config

    cfg = smoke_config("qwen3-moe-30b-a3b")
    (e,) = obs.capture_moe_dispatch(cfg, batch=2, seq=8, device=dev).get("moe_dispatch")
    assert e.data.device.type == "cuda" and len(e.source_shape) == 4
    sess = obs.capture_serve_decode(cfg, batch=2, prompt=8, new_tokens=2, device=dev)
    assert [s.name for s in sess.streams] == ["weights", "kv", "kv"]
