"""repro_torch.link against repro.link on the CPU.

Specs and power models cross over through ``repro_torch.convert``; packets
are the same numpy arrays (``np.random.default_rng`` or
``benchmarks/datagen.py``).  Streams, orders and BT totals are compared
bit-exact, energies exactly (both packages run the same float expression).
The last test holds both packages to the BT totals pinned in
``chip_smoke.py`` at the sizes the card runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.link as rl
import repro_torch.link as tl
from benchmarks.datagen import conv_streams, uniform_pairs
from benchmarks.table1_bt import _input_only_spec
from chip_smoke import TABLE1_CONV, TABLE1_UNIFORM
from repro.codec import CODECS
from repro_torch.convert import from_reference, packets_from_numpy
from torch_groups import torch_threads  # noqa: F401


def _port(spec):
    return from_reference(dataclasses.asdict(spec))[0]


def _pair(shape, seed, dtype=np.uint8, lo=0, hi=256):
    a = np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)
    return jnp.asarray(a), packets_from_numpy(a, "cpu")


def _same(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


def _same_report(jr, tr):
    for f in ("name", "num_flits", "input_bt", "weight_bt", "fused", "energy_pj",
              "aux_bt", "extra_wires"):
        assert getattr(jr, f) == getattr(tr, f), f
    assert jr.overall_bt_per_flit == tr.overall_bt_per_flit


SPECS = [
    rl.LinkSpec(),
    rl.LinkSpec(key="app", k=2, pack="row"),
    rl.LinkSpec(key="acc", width=4, descending=True),
    rl.LinkSpec(key="app", k=8, encode="gray"),
    rl.LinkSpec(key="none"),
    rl.LinkSpec(key="column_major", pack="row"),
    rl.LinkSpec(input_lanes=12, weight_lanes=4, key="acc"),
    rl.LinkSpec(input_lanes=12, weight_lanes=4, key="app", pack="row"),
    rl.LinkSpec(key="app", encode="sign_magnitude", descending=True),
]


# ---------------------------------------------------------------- spec/stages


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_spec_crosses_over_with_same_properties(spec):
    port = _port(spec)
    assert dataclasses.asdict(port) == dataclasses.asdict(spec)
    for prop in ("bytes_per_flit", "elems_per_packet", "weight_elems_per_packet", "symmetric"):
        assert getattr(port, prop) == getattr(spec, prop)


def test_spec_validation_and_registries():
    for kw in ({"key": "bogus"}, {"encode": "bogus"}, {"pack": "bogus"},
               {"codec": "bogus"}, {"input_lanes": 9}):
        with pytest.raises(ValueError):
            tl.LinkSpec(**kw)
    assert set(tl.KEY_STAGES) == set(rl.KEY_STAGES)
    assert set(tl.ENCODE_STAGES) == set(rl.ENCODE_STAGES)
    assert set(tl.PACK_STAGES) == set(rl.PACK_STAGES)
    assert set(tl.ORDER_STRATEGIES) == set(rl.ORDER_STRATEGIES)
    from repro_torch.codec import CODECS as PORT_CODECS

    assert set(PORT_CODECS) == set(CODECS)
    with pytest.raises(ValueError, match="registered pack stages"):
        tl.lookup_stage("pack", "bogus", tl.PACK_STAGES)


def test_coded_spec_is_not_ported_yet():
    """Coded specs run in the port now, on the staged path only, as in the
    reference: forcing the fused kernel on one raises in both packages."""
    x = np.zeros((4, 32), dtype=np.uint8)
    rep = tl.TxPipeline(tl.LinkSpec(key="acc", codec="bus_invert"), device="cpu").measure(x)
    assert not rep.fused and rep.extra_wires == 1
    with pytest.raises(ValueError, match="cannot run fused"):
        tl.TxPipeline(tl.LinkSpec(key="acc", codec="bus_invert"), fused=True, device="cpu").run(x)
    with pytest.raises(ValueError, match="cannot run fused"):
        rl.TxPipeline(rl.LinkSpec(key="acc", codec="bus_invert"), fused=True).run(jnp.asarray(x))


def test_power_model_crosses_over_exactly():
    ref = rl.LinkPowerModel(energy_per_transition_pj=0.2, static_flit_energy_pj=1.5)
    _, port = from_reference(dataclasses.asdict(rl.LinkSpec()), dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for bt_red in (0.0, 0.1421, 0.2042):
        assert port.power_reduction(bt_red) == ref.power_reduction(bt_red)
    assert port.link_energy_pj(12345, 400) == ref.link_energy_pj(12345, 400)
    assert port.coded_link_energy_pj(100, 7, 40, 128, 1) == ref.coded_link_energy_pj(
        100, 7, 40, 128, 1
    )
    assert port.wire_energy_pj([1, 2, 3], 5) == ref.wire_energy_pj([1, 2, 3], 5)


@pytest.mark.parametrize("strategy", ["none", "column_major", "acc", "app"])
@pytest.mark.parametrize("n,lanes", [(32, 8), (64, 16)])
def test_make_order_and_order_packets(strategy, n, lanes):
    jx, tx = _pair((21, n), n + lanes)
    jw, tw = _pair((21, n), n + lanes + 1)
    for desc in (False, True):
        kw = dict(lanes=lanes, width=8, k=4, descending=desc)
        got = tl.make_order(strategy, tx, **kw)
        assert got.dtype == torch.int32
        _same(rl.make_order(strategy, jx, **kw), got)
    ji, jw2 = rl.order_packets(strategy, jx, jw, lanes=lanes)
    ti, tw2 = tl.order_packets(strategy, tx, tw, lanes=lanes)
    _same(ji, ti)
    _same(jw2, tw2)
    with pytest.raises(ValueError):
        tl.make_order("row_bucket", tx)


@pytest.mark.parametrize("pack", ["row", "lane"])
@pytest.mark.parametrize("shape,lanes", [((5, 64), 8), ((5, 64), 16), ((7, 16), 16), ((1, 32), 8)])
def test_pack_unpack_match_reference(pack, shape, lanes):
    jx, tx = _pair(shape, shape[1] + lanes)
    jf, tf = rl.pack_to_flits(jx, lanes, pack), tl.pack_to_flits(tx, lanes, pack)
    _same(jf, tf)
    assert torch.equal(tl.unpack_from_flits(tf, pack), tx)
    with pytest.raises(ValueError, match="stream-only"):
        tl.pack_to_flits(tx, lanes, "col")


def test_encode_stages_match_reference():
    jq, tq = _pair((6, 32), 4, np.int8, -128, 128)
    _same(rl.to_sign_magnitude(jq), tl.to_sign_magnitude(tq))
    _same(rl.to_gray(jq), tl.to_gray(tq))


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_paired_stream_and_legacy_measure(spec):
    p = 13
    jx, tx = _pair((p, spec.elems_per_packet), 7)
    jw, tw = _pair((p, spec.weight_elems_per_packet), 8)
    port = _port(spec)
    strategy = spec.key
    kw = dict(width=spec.width, k=spec.k, descending=spec.descending)
    js = rl.paired_stream(jx, jw, spec, strategy, spec.pack, **kw)
    ts = tl.paired_stream(tx, tw, port, strategy, spec.pack, **kw)
    assert ts.dtype == torch.uint8
    _same(js, ts)
    jr = rl.measure(jx, jw, spec, strategy, spec.pack, **kw)
    tr = tl.measure(tx, tw, port, strategy, spec.pack, **kw)
    for a, b in zip(jr, tr):
        assert float(a) == float(b)


# ----------------------------------------------------------------- TxPipeline


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_pipeline_run_and_measure_match_reference(spec):
    p = 45
    lo, hi, dt = ((-128, 128, np.int8) if spec.encode == "sign_magnitude" else (0, 256, np.uint8))
    jx, tx = _pair((p, spec.elems_per_packet), 17, dt, lo, hi)
    jw, tw = _pair((p, spec.weight_elems_per_packet), 18, dt, lo, hi)
    jpipe = rl.TxPipeline(spec)
    tpipe = tl.TxPipeline(_port(spec), device="cpu")
    jres, tres = jpipe.run(jx, jw), tpipe.run(tx, tw)
    assert jres.fused == tres.fused
    for f in ("order", "stream", "bt_input", "bt_weight"):
        _same(getattr(jres, f), getattr(tres, f))
    assert (jres.rank is None) == (tres.rank is None)
    if tres.rank is not None:
        _same(jres.rank, tres.rank)
    _same(jpipe.order(jx), tpipe.order(tx))
    _same_report(jpipe.measure(jx, jw, name="x"), tpipe.measure(tx, tw, name="x"))
    if spec.symmetric:  # input-only transmit of the same packets
        _same(jpipe.transmit(jx), tpipe.transmit(tx))


@pytest.mark.parametrize("key", ["acc", "app"])
def test_pipeline_forced_paths_agree(key):
    spec = rl.LinkSpec(key=key)
    jx, tx = _pair((30, 32), 1)
    jw, tw = _pair((30, 32), 2)
    for fused in (True, False):
        tres = tl.TxPipeline(_port(spec), fused=fused, device="cpu").run(tx, tw)
        jres = rl.TxPipeline(spec, fused=fused).run(jx, jw)
        assert tres.fused == fused
        _same(jres.stream, tres.stream)
        assert int(jres.bt_input) == int(tres.bt_input)
    asym = tl.LinkSpec(input_lanes=12, weight_lanes=4)
    with pytest.raises(ValueError, match="cannot run fused"):
        tl.TxPipeline(asym, fused=True, device="cpu").run(
            torch.zeros((2, 48), dtype=torch.uint8), torch.zeros((2, 16), dtype=torch.uint8)
        )


def test_pipeline_takes_numpy_on_its_device():
    x = np.random.default_rng(0).integers(0, 256, (10, 32), dtype=np.uint8)
    res = tl.TxPipeline(tl.LinkSpec(), device="cpu").run(x, x)
    assert res.stream.device.type == "cpu" and res.fused
    assert tl.TxPipeline(tl.LinkSpec()).device == torch.device("cuda")


@pytest.mark.parametrize(
    "key,pack,encode,k",
    [("row_bucket", "col", "sign_magnitude", 9), ("none", "col", "sign_magnitude", 4),
     ("row_bucket", "row", "identity", 4), ("none", "lane", "identity", 4)],
)
def test_row_streams_match_reference(key, pack, encode, k):
    rng = np.random.default_rng(9)
    rows = (rng.normal(size=(64, 64)) * rng.lognormal(0, 1.2, (64, 1)) * 20).clip(-127, 127)
    rows = rows.astype(np.int8)
    spec = rl.LinkSpec(flits_per_packet=1, input_lanes=16, weight_lanes=0, key=key,
                       encode=encode, pack=pack, k=k)
    jpipe, tpipe = rl.TxPipeline(spec), tl.TxPipeline(_port(spec), device="cpu")
    jr, tr = jnp.asarray(rows), torch.from_numpy(rows)
    _same(jpipe.row_order(jr), tpipe.row_order(tr))
    _same(jpipe.transmit_rows(jr), tpipe.transmit_rows(tr))
    _same_report(jpipe.measure_rows(jr), tpipe.measure_rows(tr))


def test_row_bucket_helpers_match_reference():
    jx, tx = _pair((50, 16), 3)
    for levels in (4, 9):
        _same(rl.row_bucket_keys(jx, levels), tl.row_bucket_keys(tx, levels))
        _same(rl.row_bucket_order(jx, levels, descending=True),
              tl.row_bucket_order(tx, levels, descending=True))
    _same(rl.tensor_flit_stream(jx, 32), tl.tensor_flit_stream(tx, 32))


def test_link_report_accounting():
    rep = tl.LinkReport("x", num_flits=10, input_bt=30, weight_bt=10, fused=True)
    base = tl.LinkReport("x", num_flits=10, input_bt=50, weight_bt=30)
    assert rep.total_bt == 40 and rep.gross_bt == 40
    assert rep.reduction_vs(base) == pytest.approx(0.5)
    assert float(rep.to_bt_report().overall_bt_per_flit) == pytest.approx(4.0)


# ------------------------------------------------------------------ Table I


def _uniform_rows(pkg, inp, wgt, device=None):
    kw = {} if device is None else {"device": device}
    out = {}
    for s in ("none", "column_major", "acc", "app"):
        spec = rl.LinkSpec(key=s)
        spec = spec if pkg is rl else _port(spec)
        out[s] = pkg.TxPipeline(spec, **kw).measure(inp, wgt)
    return out


def _conv_rows(pkg, streams, streams_cm, convert, lanes, k, device=None):
    kw = {} if device is None else {"device": device}
    out = {}
    for s in ("none", "column_major", "acc", "app"):
        src, key = (streams_cm, "none") if s == "column_major" else (streams, s)
        bts = []
        for side in src:
            spec = _input_only_spec(key, side.shape[-1], lanes, k)
            spec = spec if pkg is rl else _port(spec)
            bts.append(pkg.TxPipeline(spec, **kw).measure(convert(side)))
        out[s] = bts
    return out


def test_table1_rows_at_2000_packets_match_reference():
    inp, wgt = uniform_pairs(2000, 32)
    jrows = _uniform_rows(rl, jnp.asarray(inp), jnp.asarray(wgt))
    trows = _uniform_rows(tl, torch.from_numpy(inp), torch.from_numpy(wgt), "cpu")
    for s in jrows:
        _same_report(jrows[s], trows[s])
        assert trows[s].reduction_vs(trows["none"]) == jrows[s].reduction_vs(jrows["none"])
    streams, streams_cm = conv_streams(n_images=2), conv_streams(n_images=2, column_major=True)
    jc = _conv_rows(rl, streams, streams_cm, jnp.asarray, 16, 4)
    tc = _conv_rows(tl, streams, streams_cm, torch.from_numpy, 16, 4, "cpu")
    for s in jc:
        for a, b in zip(jc[s], tc[s]):
            _same_report(a, b)


def test_both_packages_reproduce_chip_smoke_pins():
    u, c = TABLE1_UNIFORM, TABLE1_CONV
    inp, wgt = uniform_pairs(u["packets"], u["elems"], seed=u["seed"])
    jrows = _uniform_rows(rl, jnp.asarray(inp), jnp.asarray(wgt))
    trows = _uniform_rows(tl, torch.from_numpy(inp), torch.from_numpy(wgt), "cpu")
    for s, pin in u["bt"].items():
        assert (jrows[s].input_bt, jrows[s].weight_bt) == pin, s
        assert (trows[s].input_bt, trows[s].weight_bt) == pin, s
    streams = conv_streams(n_images=c["images"])
    streams_cm = conv_streams(n_images=c["images"], column_major=True)
    jc = _conv_rows(rl, streams, streams_cm, jnp.asarray, c["lanes"], c["k"])
    tc = _conv_rows(tl, streams, streams_cm, torch.from_numpy, c["lanes"], c["k"], "cpu")
    for s, pin in c["bt"].items():
        assert tuple(r.input_bt for r in jc[s]) == pin, s
        assert tuple(r.input_bt for r in tc[s]) == pin, s
