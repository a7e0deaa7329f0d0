"""The port's multi-axis measurement against repro.kernels on the CPU.

``bt_count_axes`` and its thin configurations ``bt_count_links``,
``bt_count_variants`` and ``bt_count_codecs`` take the same numpy packets
as the reference's: the reference runs its compiled backend (and, for one
tiny case of each entry point, the Pallas kernel body through
``backend="interpret"``), the port its plain PyTorch version, which is a
whole-stream formulation independent of the kernel's block + fold split.
Totals are int32 and compared bit-exact, for every chunk size too.  The
CUDA kernels are held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
import repro_torch.kernels as tk
from repro_torch.kernels.axes import MAX_N, bt_axes_cuda
from torch_groups import torch_threads  # noqa: F401

ORDERINGS = [("none", None, False), ("column_major", None, False), ("acc", None, False),
             ("acc", None, True), ("app", 2, False), ("app", 4, True), ("app", 8, False)]
CODECS = [("none", None), ("gray", None), ("sign_magnitude", None), ("transition", None),
          ("bus_invert", None), ("bus_invert", 4), ("bus_invert", 2)]


def _grid(width):
    """Every ordering x every codec (bus-invert partitions None / 4 / 2)."""
    return [(*o, c, part) for o in ORDERINGS for c, part in CODECS if (o[1] or 0) <= width + 1]


def _pair(shape, seed, dtype=np.uint8, hi=256):
    a = np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


def _same(jx, tx):
    assert tx.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


# (width, N, input_lanes, paired, pack): widths 4 and 8 crossed with the
# paired and input-only framings in 'lane' and 'row' packing
FRAMINGS = [(8, 32, 8, True, "lane"), (4, 32, 8, True, "row"),
            (8, 64, 16, False, "row"), (4, 64, 16, False, "lane")]


@pytest.mark.parametrize("width,n,lanes,paired,pack", FRAMINGS)
def test_axes_matches_reference_over_the_grid(width, n, lanes, paired, pack):
    p = 21  # no multiple of the reference's 8-packet blocks
    jx, tx = _pair((4, p, n), width * n, np.int32, 1 << width)
    jw, tw = _pair((4, p, n), width * n + 1) if paired else (None, None)
    valid = [0, p, 5, p + 9]  # an empty link, a full one, a short one, one past P
    grid = _grid(width)
    ref = rk.bt_count_axes(
        jx, jw, jnp.asarray(valid), configs=tuple(rk.CodecVariant(*c) for c in grid),
        width=width, input_lanes=lanes, pack=pack, block_packets=8,
    )
    for chunk in (None, 1, 7):
        got = tk.bt_count_axes(
            tx, tw, torch.tensor(valid), configs=tuple(tk.CodecVariant(*c) for c in grid),
            width=width, input_lanes=lanes, pack=pack, chunk_packets=chunk,
        )
        _same(ref, got)


def test_axes_split_lanes_int32_payloads_and_valid_forms():
    jx, tx = _pair((3, 30, 32), 5, np.int32, 1 << 12)
    jw, tw = _pair((3, 30, 32), 6, np.int32, 1 << 12)
    grid = [("acc", None, False, "none", None), ("app", 4, True, "bus_invert", 4),
            ("none", None, False, "transition", None), ("column_major", None, False, "gray", None)]
    kw = dict(width=12, input_lanes=8, split_lanes=5, pack="row")
    ref = rk.bt_count_axes(jx, jw, [30, 2, 17], configs=tuple(rk.CodecVariant(*c) for c in grid),
                           block_packets=8, **kw)
    tgrid = tuple(tk.CodecVariant(*c) for c in grid)
    for valid in ([30, 2, 17], np.array([30, 2, 17]), torch.tensor([30, 2, 17])):
        _same(ref, tk.bt_count_axes(tx, tw, valid, configs=tgrid, **kw))
    # no valid: every link sends all P packets
    ref_all = rk.bt_count_axes(jx, jw, None, configs=tuple(rk.CodecVariant(*c) for c in grid),
                               block_packets=8, **kw)
    _same(ref_all, tk.bt_count_axes(tx, tw, None, configs=tgrid, chunk_packets=4, **kw))


def test_links_match_reference_with_any_padding():
    jx, tx = _pair((5, 60, 16), 7)
    lengths = [60, 0, 1, 33, 80]
    for input_lanes, chunk in ((None, None), (10, 7), (16, 1)):
        ref = rk.bt_count_links(jx, input_lanes, jnp.asarray(lengths), chunk_rows=chunk)
        got = tk.bt_count_links(tx, input_lanes, torch.tensor(lengths), chunk_rows=chunk)
        _same(ref, got)
    _same(rk.bt_count_links(jx), tk.bt_count_links(tx))
    # rows past each length count nothing, whatever they hold
    noisy = tx.clone()
    noisy[3, 33:] = 255 - noisy[3, 33:]
    assert torch.equal(tk.bt_count_links(noisy, 10, lengths), tk.bt_count_links(tx, 10, lengths))


def test_variants_and_codecs_match_reference():
    jx, tx = _pair((45, 32), 8)
    jw, tw = _pair((45, 32), 9)
    variants = [("acc", None, False), ("app", 4, True), ("none", None, False),
                ("column_major", None, False)]
    ref = rk.bt_count_variants(jx, jw, tuple(rk.Variant(*v) for v in variants))
    got = tk.bt_count_variants(tx, tw, tuple(tk.Variant(*v) for v in variants), chunk_packets=10)
    _same(ref, got)
    configs = [("app", 2, False, "bus_invert", None), ("acc", None, False, "transition", None),
               ("none", None, False, "sign_magnitude", None)]
    for weights, lanes, wl in ((jw, 8, None), (None, 16, None), (None, 8, 8)):
        ref = rk.bt_count_codecs(jx, weights, tuple(rk.CodecVariant(*c) for c in configs),
                                 input_lanes=lanes, weight_lanes=wl)
        got = tk.bt_count_codecs(tx, None if weights is None else tw,
                                 tuple(tk.CodecVariant(*c) for c in configs),
                                 input_lanes=lanes, weight_lanes=wl)
        _same(ref, got)


def test_each_entry_point_matches_the_interpreted_kernel():
    """One tiny case per entry point against the Pallas kernel body."""
    jx, tx = _pair((2, 11, 16), 10)
    jw, tw = _pair((2, 11, 16), 11)
    cfg = ("app", 4, False, "bus_invert", 4)
    ref = rk.bt_count_axes(jx, jw, [11, 6], configs=(rk.CodecVariant(*cfg),), block_packets=4,
                           backend="interpret")
    _same(ref, tk.bt_count_axes(tx, tw, [11, 6], configs=(tk.CodecVariant(*cfg),)))
    ref = rk.bt_count_links(jx, 10, [11, 4], block_rows=4, backend="interpret")
    _same(ref, tk.bt_count_links(tx, 10, [11, 4]))
    ref = rk.bt_count_variants(jx[0], jw[0], (rk.Variant("acc"),), block_packets=4,
                               backend="interpret")
    _same(ref, tk.bt_count_variants(tx[0], tw[0], (tk.Variant("acc"),)))
    cfg = ("none", None, False, "transition", None)
    ref = rk.bt_count_codecs(jx[1], None, (rk.CodecVariant(*cfg),), block_packets=4,
                             backend="interpret")
    _same(ref, tk.bt_count_codecs(tx[1], None, (tk.CodecVariant(*cfg),)))


def test_empty_shapes_give_zeros():
    configs = (tk.CodecVariant(), tk.CodecVariant("none", codec="bus_invert"))
    for shape in ((0, 5, 16), (3, 0, 16)):
        got = tk.bt_count_axes(torch.zeros(shape, dtype=torch.uint8), configs=configs)
        ref = rk.bt_count_axes(jnp.zeros(shape, jnp.uint8),
                               configs=tuple(rk.CodecVariant(*c) for c in configs))
        _same(ref, got)
        assert got.shape == (shape[0], 2, 3)
    for shape in ((0, 9, 8), (4, 1, 8), (4, 0, 8)):
        _same(rk.bt_count_links(jnp.zeros(shape, jnp.uint8)),
              tk.bt_count_links(torch.zeros(shape, dtype=torch.uint8)))


def test_validation_errors():
    x = torch.zeros((2, 4, 16), dtype=torch.uint8)
    cases = [
        (dict(configs=(tk.CodecVariant(codec="bogus"),)), "unknown codec scheme"),
        (dict(configs=(tk.CodecVariant(codec="gray", partition=4),)), "only meaningful"),
        (dict(configs=(tk.CodecVariant(codec="bus_invert", partition=3),)), "does not divide"),
        (dict(configs=(tk.CodecVariant("app", None),)), "'app' needs k"),
        (dict(configs=(tk.CodecVariant("none", descending=True),)), "descending"),
        (dict(configs=()), "at least one"),
        (dict(pack="col"), "'lane'\\|'row'"),
        (dict(input_lanes=5), "divisible"),
        (dict(weight_lanes=4), "symmetric"),
        (dict(split_lanes=17), "outside"),
        (dict(chunk_packets=0), "chunk_packets"),
        (dict(valid=[1, 2, 3]), "valid must be"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            tk.bt_count_axes(x, **kw)
    with pytest.raises(ValueError, match="\\(L, P, N\\)"):
        tk.bt_count_axes(x[0])
    with pytest.raises(ValueError, match="paired shapes"):
        tk.bt_count_axes(x, x[:, :2])
    with pytest.raises(ValueError, match="outside"):
        tk.bt_count_links(x, input_lanes=17)
    for fn, args in ((tk.bt_count_axes, (x,)), (tk.bt_count_links, (x,)),
                     (tk.bt_count_codecs, (x[0],))):
        with pytest.raises(ValueError, match="activity_windows must be >= 1"):
            fn(*args, activity_windows=0)
        assert type(fn(*args, activity_windows=4)).__name__ in ("AxesActivity", "LinkActivity")


def test_cpu_tensors_never_launch_and_the_cuda_wrapper_checks_first():
    x = torch.zeros((2, 4, 16), dtype=torch.uint8)
    tk.reset_launch_counts()
    tk.bt_count_axes(x, configs=(tk.CodecVariant("acc", codec="bus_invert"),))
    tk.bt_count_axes(x, backend="torch")
    assert tk.launch_counts()["bt_axes"] == 0
    kw = dict(configs=(tk.CodecVariant(),), width=8, input_lanes=8, weight_lanes=0,
              split_lanes=None, pack="lane")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bt_axes_cuda(x, None, torch.tensor([4, 4]), **kw)
    with pytest.raises(TypeError, match="uint8 or int32"):
        bt_axes_cuda(x.to(torch.int64), None, torch.tensor([4, 4]), **kw)
    with pytest.raises(ValueError, match=f"N <= {MAX_N}"):
        bt_axes_cuda(torch.zeros((1, 2, 2048), dtype=torch.uint8), None, torch.tensor([2]), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bt_axes_cuda(x.transpose(0, 1), None, torch.tensor([4, 4]), **kw)


@pytest.mark.parametrize("links,p,flits,lanes,orderings", [
    (1, 1838, 4, 16, 3),      # the codec path: one stream, three orderings
    (256, 16384, 4, 16, 5),   # the scale batch: already thousands of blocks
    (6, 1001, 4, 16, 10),
    (2, 3, 4, 16, 7),         # fewer packets than one block
    (1, 1, 1, 1, 1),
    (3, 5000, 64, 32, 1),     # 1,024-byte paired packets: 8 per image
    (1, 999, 10, 5, 2),       # 5-lane rows padded to 12 bytes
])
@pytest.mark.parametrize("sms", [132, 8])
def test_axes_blocking_fills_the_card_and_fits_the_image(links, p, flits, lanes, orderings, sms):
    from repro_torch.kernels.axes import AXES_BLOCK_PACKETS, AXES_IMAGE_BYTES, axes_blocking

    bpk, g = axes_blocking(links, p, flits, lanes, orderings, sms)
    row = 4 * (-(-lanes // 4) | 1)  # rows padded to an odd number of words
    assert 1 <= bpk <= AXES_BLOCK_PACKETS
    assert bpk * flits * row <= AXES_IMAGE_BYTES  # the padded image fits
    assert g == -(-p // bpk) and g * bpk >= p  # every valid packet has a block
    full = min(AXES_BLOCK_PACKETS, AXES_IMAGE_BYTES // (flits * row))
    if links * -(-p // full) * orderings >= 2 * sms:
        assert bpk == full  # a batch that fills the card keeps whole images
    else:  # a small one is split until two blocks per SM, or one packet a block
        assert links * g * orderings >= 2 * sms or bpk == 1
        # and no further: one halving less (at most twice as many packets
        # per block) would not fill the card
        assert bpk == full or links * -(-p // min(full, 2 * bpk)) * orderings < 2 * sms


def test_config_table_records_each_orderings_configs_and_items():
    """The kernels' table: per ordering its stateless codec bits, its
    stateless configs and its bus-invert (config, partition) items."""
    from repro_torch.kernels.axes import _config_table

    configs = tuple(tk.CodecVariant(*c) for c in _grid(8))
    lanes = 16
    tab, n_ord = _config_table(configs, lanes, torch.device("cpu"))
    tab = tab.tolist()
    assert n_ord == len(ORDERINGS)
    cfgs = tab[3 * n_ord:]
    for o in range(n_ord):
        need, s_off, n_s, i_off, n_i = cfgs[4 * len(configs) + 5 * o: 4 * len(configs) + 5 * o + 5]
        mine = [c for c in range(len(configs)) if cfgs[4 * c] == o]
        stateless = [c for c in mine if configs[c].codec != "bus_invert"]
        assert tab[s_off: s_off + n_s] == stateless
        assert need == sum({1 << cfgs[4 * c + 1] for c in stateless})
        pairs = [(c, q) for c in mine if configs[c].codec == "bus_invert"
                 for q in range(cfgs[4 * c + 2])]
        got = tab[i_off: i_off + 2 * n_i]
        assert list(zip(got[::2], got[1::2])) == pairs
