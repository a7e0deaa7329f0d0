"""The port's per-wire activity windows against repro.kernels on the CPU.

``bt_count_axes`` / ``bt_count_links`` / ``bt_count_codecs`` with
``activity_windows=`` take the same seeded numpy packets as the
reference's: the reference runs its compiled backend (the block math its
Pallas kernel runs), the port its plain PyTorch version, a whole-stream
formulation independent of the kernel's block + fold + rerun split.
``bt``, ``toggles`` and ``ones`` are int32 and compared bit-exact, for
every chunk size and across calls threading a warm carry.  The CUDA
kernels are held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
import repro.obs as robs
import repro_torch.kernels as tk
import repro_torch.obs as tobs
from repro_torch.kernels.axes import ActivityOut, axes_carry, bt_axes_plain
from torch_groups import torch_threads  # noqa: F401

ORDERINGS = [("none", None, False), ("column_major", None, False), ("acc", None, False),
             ("acc", None, True), ("app", 2, False), ("app", 4, True), ("app", 8, False),
             ("app", 8, True)]
CODECS = [("none", None), ("gray", None), ("sign_magnitude", None), ("transition", None),
          ("bus_invert", None), ("bus_invert", 4), ("bus_invert", 2)]


def _grid(width):
    """Every ordering (both directions) x every codec (bus-invert
    partitions None / 4 / 2), APP k past width + 1 left out."""
    return [(*o, c, part) for o in ORDERINGS for c, part in CODECS if (o[1] or 0) <= width + 1]


def _pair(shape, seed, dtype=np.uint8, hi=256):
    a = np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


def _same(ref, got):
    """Every field of an activity result bit-exact (int32 on both sides)."""
    assert type(got).__name__ == type(ref).__name__
    for field, a, b in zip(ref._fields, ref, got):
        assert b.dtype == torch.int32, field
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=field)


# (width, N, input_lanes, paired, pack): widths 4 and 8 crossed with the
# paired and input-only framings in 'lane' and 'row' packing
FRAMINGS = [(8, 32, 8, True, "lane"), (4, 32, 8, True, "row"),
            (8, 64, 16, False, "row"), (4, 64, 16, False, "lane")]


@pytest.mark.parametrize("width,n,lanes,paired,pack", FRAMINGS)
def test_activity_matches_reference_over_the_grid(width, n, lanes, paired, pack):
    p = 21  # no multiple of the reference's 8-packet blocks
    jx, tx = _pair((4, p, n), width * n + 3, np.int32, 1 << width)
    jw, tw = _pair((4, p, n), width * n + 4) if paired else (None, None)
    valid = [0, p, 5, p + 9]  # an empty link, a full one, a short one, one past P
    grid = _grid(width)
    ref = rk.bt_count_axes(
        jx, jw, jnp.asarray(valid), configs=tuple(rk.CodecVariant(*c) for c in grid),
        width=width, input_lanes=lanes, pack=pack, block_packets=8, backend="compiled",
        activity_windows=5,
    )
    for chunk in (None, 1, 7):
        got = tk.bt_count_axes(
            tx, tw, torch.tensor(valid), configs=tuple(tk.CodecVariant(*c) for c in grid),
            width=width, input_lanes=lanes, pack=pack, chunk_packets=chunk,
            activity_windows=5,
        )
        _same(ref, got)
    # the bt plane is the measurement without activity
    plain = tk.bt_count_axes(tx, tw, torch.tensor(valid),
                             configs=tuple(tk.CodecVariant(*c) for c in grid), width=width,
                             input_lanes=lanes, pack=pack)
    assert torch.equal(got.bt, plain)


# windows of one row, of a few rows, and one window longer than the stream
@pytest.mark.parametrize("window", [1, 5, 1000])
def test_activity_windows_and_chunks_match_reference(window):
    jx, tx = _pair((3, 19, 16), window)
    grid = [("none", None, False, "none", None), ("acc", None, True, "transition", None),
            ("app", 4, False, "bus_invert", 4), ("column_major", None, False, "gray", None),
            ("acc", None, False, "bus_invert", None)]
    valid = [19, 11, 0]
    kw = dict(width=8, input_lanes=8, pack="lane", activity_windows=window)
    ref = rk.bt_count_axes(jx, None, jnp.asarray(valid),
                           configs=tuple(rk.CodecVariant(*c) for c in grid), block_packets=4,
                           backend="compiled", **kw)
    assert ref.toggles.shape == (3, len(grid), -(-19 * 2 // window), 8 * 8 + 2)
    for chunk in (None, 1, 7):
        got = tk.bt_count_axes(tx, None, valid, configs=tuple(tk.CodecVariant(*c) for c in grid),
                               chunk_packets=chunk, **kw)
        _same(ref, got)


def test_warm_carry_across_calls_matches_one_shot():
    """Two calls of the plain version threading the carry (started, wire
    flits, invert states, wire parities) land every toggle where one call
    does, and equal the reference's one-shot result."""
    jx, tx = _pair((3, 30, 32), 21)
    jw, tw = _pair((3, 30, 32), 22)
    grid = [("app", 4, False, "transition", None), ("acc", None, False, "bus_invert", 4),
            ("none", None, False, "sign_magnitude", None), ("acc", None, True, "bus_invert", 2)]
    valid = [30, 17, 12]
    ref = rk.bt_count_axes(jx, jw, jnp.asarray(valid),
                           configs=tuple(rk.CodecVariant(*c) for c in grid), block_packets=8,
                           backend="compiled", activity_windows=6)
    configs = tuple(tk.CodecVariant(*c) for c in grid)
    kw = dict(configs=configs, width=8, input_lanes=8, weight_lanes=8, split_lanes=None,
              pack="lane")
    nwires = 16 * 8 + 8  # bus-invert over 2-lane partitions: 8 invert lines
    tog = torch.zeros((3, len(grid), -(-30 * 4 // 6), nwires), dtype=torch.int32)
    ones = torch.zeros((3, len(grid), nwires), dtype=torch.int32)
    carry = axes_carry(3, configs, 16, "cpu", activity=True)
    bts = []
    for p0, p1 in ((0, 13), (13, 30)):
        v = (torch.tensor(valid) - p0).clamp(0, p1 - p0)
        bt, carry = bt_axes_plain(tx[:, p0:p1], tw[:, p0:p1], v, carry=carry,
                                  activity=ActivityOut(tog, ones, 6, p0 * 4), **kw)
        bts.append(bt)
    assert carry["parity"].shape == (len(grid), 3, 128)
    assert carry["parity"][1:3].eq(0).all() and carry["parity"][0].any()
    _same(ref, tk.AxesActivity(bts[0] + bts[1], tog, ones))


def test_codecs_and_links_match_reference():
    jx, tx = _pair((45, 32), 8)
    jw, tw = _pair((45, 32), 9)
    configs = [("app", 2, False, "bus_invert", None), ("acc", None, False, "transition", None),
               ("none", None, False, "sign_magnitude", None)]
    for weights, lanes, chunk in ((jw, 8, None), (None, 16, 10)):
        ref = rk.bt_count_codecs(jx, weights, tuple(rk.CodecVariant(*c) for c in configs),
                                 input_lanes=lanes, backend="compiled", activity_windows=7)
        got = tk.bt_count_codecs(tx, None if weights is None else tw,
                                 tuple(tk.CodecVariant(*c) for c in configs), input_lanes=lanes,
                                 chunk_packets=chunk, activity_windows=7)
        _same(ref, got)
        assert got.toggles.shape[0] == len(configs)
    js, ts = _pair((5, 60, 16), 7)
    lengths = [60, 0, 1, 33, 80]  # jagged: empty, one row, short, past T
    for input_lanes, chunk, window in ((None, None, 8), (10, 7, 1), (16, 1, 100)):
        ref = rk.bt_count_links(js, input_lanes, jnp.asarray(lengths), backend="compiled",
                                chunk_rows=chunk, activity_windows=window)
        got = tk.bt_count_links(ts, input_lanes, torch.tensor(lengths), chunk_rows=chunk,
                                activity_windows=window)
        _same(ref, got)
        assert got.toggles.shape == (5, -(-60 // window), 128)


def test_empty_and_single_row_shapes():
    configs = (tk.CodecVariant(), tk.CodecVariant("none", codec="bus_invert", partition=4))
    for shape in ((0, 5, 16), (3, 0, 16), (2, 1, 16)):
        got = tk.bt_count_axes(torch.zeros(shape, dtype=torch.uint8), configs=configs,
                               activity_windows=3)
        ref = rk.bt_count_axes(jnp.zeros(shape, jnp.uint8),
                               configs=tuple(rk.CodecVariant(*c) for c in configs),
                               backend="compiled", activity_windows=3)
        _same(ref, got)
    for shape in ((0, 9, 8), (4, 1, 8), (4, 0, 8)):
        x = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
        _same(rk.bt_count_links(jnp.asarray(x), backend="compiled", activity_windows=2),
              tk.bt_count_links(torch.from_numpy(x), activity_windows=2))


@pytest.mark.parametrize("width", [4, 8])
def test_profiles_sum_to_gross_bt_and_match_reference(width):
    """The per-wire-sum == gross-BT invariant through the port's
    ``ActivityProfile.check``, for every config of the grid, and every
    profile number equal to the reference's profile of the same stream."""
    p, n, lanes = 23, 32, 8
    jx, tx = _pair((p, n), 40 + width)
    grid = _grid(width)
    window = 9
    ref = rk.bt_count_codecs(jx, None, tuple(rk.CodecVariant(*c) for c in grid),
                             width=width, input_lanes=lanes, backend="compiled",
                             activity_windows=window)
    got = tk.bt_count_codecs(tx, None, tuple(tk.CodecVariant(*c) for c in grid), width=width,
                             input_lanes=lanes, activity_windows=window)
    duration = p * n // lanes
    for ci in range(len(grid)):
        kw = dict(window_flits=window, duration_flits=duration, data_lanes=lanes)
        prof = tobs.profile_from_arrays(f"c{ci}", got.toggles[ci], got.ones[ci], **kw)
        prof.check(int(got.bt[ci].sum()))
        rprof = robs.profile_from_arrays(f"c{ci}", ref.toggles[ci], ref.ones[ci], **kw)
        np.testing.assert_array_equal(prof.toggles, rprof.toggles)
        np.testing.assert_array_equal(prof.ones, rprof.ones)
        assert prof.hottest_wires(3) == rprof.hottest_wires(3)
    # a profile whose wire sum disagrees with the scalar BT is refused
    with pytest.raises(ValueError, match="gross BT"):
        prof.check(int(got.bt[-1].sum()) + 1)


def test_activity_validation_and_no_launch_on_cpu():
    x = torch.zeros((2, 4, 16), dtype=torch.uint8)
    for fn, args in ((tk.bt_count_axes, (x,)), (tk.bt_count_links, (x,)),
                     (tk.bt_count_codecs, (x[0],))):
        with pytest.raises(ValueError, match="activity_windows must be >= 1"):
            fn(*args, activity_windows=0)
    tk.reset_launch_counts()
    out = tk.bt_count_axes(x, activity_windows=4)
    assert isinstance(out, tk.AxesActivity) and out.toggles.shape == (2, 1, 2, 8 * 8 + 1)
    assert isinstance(tk.bt_count_links(x, activity_windows=4), tk.LinkActivity)
    assert tk.launch_counts()["bt_axes_activity"] == 0
    # the CUDA wrapper refuses an activity buffer that cannot hold the rows
    # before it would touch the device
    from repro_torch.kernels.axes import bt_axes_activity_cuda

    kw = dict(configs=(tk.CodecVariant(),), width=8, input_lanes=8, weight_lanes=0,
              split_lanes=None, pack="lane")
    small = ActivityOut(torch.zeros((2, 1, 1, 65), dtype=torch.int32),
                        torch.zeros((2, 1, 65), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="do not hold rows"):
        bt_axes_activity_cuda(x, None, torch.tensor([4, 4]), activity=small, **kw)
    with pytest.raises(ValueError, match="activity ones"):
        bt_axes_activity_cuda(x, None, torch.tensor([4, 4]), activity=small._replace(
            toggles=torch.zeros((2, 1, 2, 65), dtype=torch.int32), ones=small.ones[:1]), **kw)


def test_both_packages_reproduce_chip_smoke_activity_pins():
    """The digests chip_smoke.py holds the card to, at its full size: the
    conv input stream of benchmarks/codec_bt.py --activity under the 12
    codec-path configs, windows of 32 rows, through both packages."""
    import hashlib

    import repro.codec as rcodec
    import repro_torch.codec as tcodec
    from benchmarks.datagen import conv_streams
    from chip_smoke import CODEC_ACTIVITY, CODEC_COMPARE, _codec_configs

    ca, cc = CODEC_ACTIVITY, CODEC_COMPARE
    inp, wgt = conv_streams(n_images=cc["conv_images"])
    configs = _codec_configs()
    kw = dict(input_lanes=cc["lanes"], activity_windows=ca["window"])
    ref = rk.bt_count_codecs(jnp.asarray(inp), None,
                             tuple(rk.CodecVariant(*c) for c in configs), **kw)
    got = tk.bt_count_codecs(torch.from_numpy(inp), None, configs, **kw)
    _same(ref, got)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()

    duration = inp.shape[0] * inp.shape[1] // cc["lanes"]
    profiles = {"t": [], "r": []}
    for ci, cfg in enumerate(configs):
        label = f"{cfg.key}+{cfg.codec}" + (f"{cfg.partition}" if cfg.partition else "")
        tog, ones = got.toggles[ci].numpy(), got.ones[ci].numpy()
        assert (sha(tog), sha(ones), int(tog.sum()), int(ones.sum())) == ca["configs"][label]
        pkw = dict(window_flits=ca["window"], duration_flits=duration, data_lanes=cc["lanes"])
        profiles["t"].append(tobs.profile_from_arrays(label, got.toggles[ci], got.ones[ci], **pkw))
        profiles["r"].append(robs.profile_from_arrays(label, ref.toggles[ci], ref.ones[ci], **pkw))
        profiles["t"][-1].check(int(got.bt[ci].sum()))
    assert tog.shape == (ca["windows"], ca["wires"])
    texts = {
        "t": tobs.write_saif("/dev/null", profiles["t"], design="codec_bt"),
        "r": robs.write_saif("/dev/null", profiles["r"], design="codec_bt"),
    }
    assert texts["t"] == texts["r"]
    assert hashlib.sha256(texts["t"].encode()).hexdigest() == ca["saif_sha256"]
    # the codec.stream.bt series of phase 3b's streams, both packages
    rdemo = rcodec.demo_workloads(images=cc["demo_images"])
    tdemo = tcodec.demo_workloads(images=cc["demo_images"], device="cpu")
    ref_orderings = tuple(o.key if o.key == "none" else o for o in cc["orderings"])
    with robs.collect() as rreg, tobs.collect() as treg:
        for name in ("conv", "decode", "allreduce"):
            if name == "conv":
                rs, ts = (jnp.asarray(inp), jnp.asarray(wgt)), (inp, wgt)
            else:
                rs, ts = rdemo[name], tdemo[name]
            rcodec.compare_streams(rs, cc["lanes"], orderings=ref_orderings,
                                   codecs=cc["codecs"], workload=name)
            tcodec.compare_streams(ts, cc["lanes"], orderings=cc["orderings"],
                                   codecs=cc["codecs"], workload=name, device="cpu")
    for reg in (rreg, treg):
        assert {s.labels["stream"]: int(s.value)
                for s in reg.series("codec.stream.bt")} == ca["stream_bt"]
