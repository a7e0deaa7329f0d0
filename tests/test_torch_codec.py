"""repro_torch.codec against repro.codec on the CPU.

The same numpy flit streams go through both packages' encoders, decoders,
overhead accounting, ``compare_streams`` and coded ``TxPipeline`` specs:
wire bytes, invert lines and BT totals are compared bit-exact, and floats
(reductions, energies) exactly, since both packages compute them from the
same integers through the same expressions.  The last test holds both
packages to the codec-path totals pinned in ``chip_smoke.py`` at the sizes
the card runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codec as rc
import repro.link as rl
import repro_torch.codec as tc
import repro_torch.link as tl
from benchmarks.datagen import conv_streams, uniform_pairs
from chip_smoke import CODEC_COMPARE, CODED_TX
from repro.kernels import bt_count_codecs as rk_bt_count_codecs
from repro_torch.convert import from_reference, packets_from_numpy
from repro_torch.kernels import bt_count_codecs
from torch_groups import torch_threads  # noqa: F401


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _port(spec):
    return from_reference(dataclasses.asdict(spec))[0]


# ------------------------------------------------------------------ schemes


@pytest.mark.parametrize("name", sorted(rc.CODECS))
@pytest.mark.parametrize("shape", [(1, 16), (2, 8), (300, 12)])
def test_encode_decode_match_reference(name, shape):
    if name == "bus_invert4" and shape[1] % 4:
        shape = (shape[0], 16)
    s = _bytes(shape, shape[0] * 31 + shape[1])
    ref = rc.codec_by_name(name).encode(jnp.asarray(s))
    codec = tc.codec_by_name(name)
    got = codec.encode(torch.from_numpy(s))
    np.testing.assert_array_equal(np.asarray(ref.wire), got.wire.numpy())
    assert got.wire.dtype == torch.uint8
    if ref.invert is None:
        assert got.invert is None
    else:
        np.testing.assert_array_equal(np.asarray(ref.invert), got.invert.numpy())
    assert int(tc.invert_line_transitions(got.invert)) == int(
        rc.invert_line_transitions(ref.invert)
    )
    np.testing.assert_array_equal(codec.decode(got).numpy(), s)  # decode o encode == id
    np.testing.assert_array_equal(
        codec.decode(tc.CodedStream(*(None if a is None else torch.from_numpy(np.array(a))
                                      for a in ref))).numpy(), s)
    assert codec.stateful == rc.codec_by_name(name).stateful
    assert codec.extra_wires(shape[1]) == rc.codec_by_name(name).extra_wires(shape[1])


def test_bus_invert_ties_stay_uninverted():
    """Rows at exactly half the partition's wires from the previous wire
    flit are never inverted; ties reset the prefix-XOR of the closed form."""
    rows = [0x00, 0x0F, 0x00, 0xFF, 0xF0, 0x0F, 0x3C, 0xC3, 0xFF, 0x00, 0x0F, 0xF0]
    s = np.array([[v, v ^ 0x5A] for v in rows] * 7, dtype=np.uint8)
    for partition in (None, 1, 2):
        ref = rc.make_bus_invert(partition).encode(jnp.asarray(s))
        got = tc.make_bus_invert(partition).encode(torch.from_numpy(s))
        np.testing.assert_array_equal(np.asarray(ref.wire), got.wire.numpy())
        np.testing.assert_array_equal(np.asarray(ref.invert), got.invert.numpy())
    single = np.array([[0x00], [0x0F], [0xF0], [0x0F]], dtype=np.uint8)  # HD 4, 8, 8 of 8
    got = tc.make_bus_invert(None).encode(torch.from_numpy(single))
    assert got.invert[:, 0].tolist() == [0, 0, 1, 0]


def test_registry_and_errors():
    assert set(tc.CODECS) == set(rc.CODECS)
    assert tc.SCHEMES == rc.SCHEMES and tc.CODEC_STAGES is tc.CODECS
    for name in rc.CODECS:
        a, b = tc.codec_by_name(name), rc.codec_by_name(name)
        assert (a.name, a.scheme, a.partition) == (b.name, b.scheme, b.partition)
        assert tc.wire_codec(name) is a
    with pytest.raises(ValueError, match="registered codecs: .*bus_invert"):
        tc.codec_by_name("hamming")
    with pytest.raises(ValueError, match="registered codec stages"):
        tc.wire_codec("hamming")
    with pytest.raises(ValueError, match="unknown codec scheme"):
        tc.register_codec(tc.Codec("x", "hamming", None, None))
    with pytest.raises(ValueError, match="does not divide"):
        tc.make_bus_invert(3).encode(torch.zeros((4, 8), dtype=torch.uint8))
    # a codec registered at run time is a valid LinkSpec codec in both packages
    with pytest.raises(ValueError, match="bus_invert"):
        tl.LinkSpec(codec="bus_invert2")
    tc.register_codec(tc.make_bus_invert(2))
    rc.register_codec(rc.make_bus_invert(2))
    try:
        spec = rl.LinkSpec(key="app", codec="bus_invert2")
        x, w = _bytes((12, 32), 1), _bytes((12, 32), 2)
        ref = rl.TxPipeline(spec).measure(jnp.asarray(x), jnp.asarray(w))
        got = tl.TxPipeline(_port(spec), device="cpu").measure(x, w)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.extra_wires == 8
    finally:
        del tc.CODECS["bus_invert2"], rc.CODECS["bus_invert2"]


def test_encode_stream_and_kernel_config_match_reference():
    s = _bytes((40, 16), 3)
    for name in rc.CODECS:
        ref, got = rc.encode_stream(jnp.asarray(s), name), tc.encode_stream(torch.from_numpy(s), name)
        np.testing.assert_array_equal(np.asarray(ref.wire), got.wire.numpy())
    for spec in (rl.LinkSpec(key="app", k=2, codec="bus_invert4", descending=True),
                 rl.LinkSpec(key="acc", codec="transition"), rl.LinkSpec(key="none")):
        assert tuple(tc.kernel_config(_port(spec))) == tuple(rc.kernel_config(spec))


# ----------------------------------------------------------------- overhead


@pytest.mark.parametrize("lanes", [8, 16])
def test_overhead_matches_reference(lanes):
    rpower = rl.LinkPowerModel(energy_per_transition_pj=0.3, static_flit_energy_pj=1.25)
    tpower = from_reference(dataclasses.asdict(rl.LinkSpec()), dataclasses.asdict(rpower))[1]
    for name in rc.CODECS:
        assert dataclasses.asdict(tc.codec_overhead(name, lanes)) == dataclasses.asdict(
            rc.codec_overhead(name, lanes)
        )
        assert tc.codec_overhead(name, lanes).wire_overhead == rc.codec_overhead(
            name, lanes
        ).wire_overhead
        args = (1234, 56, 789, lanes)
        assert tc.coded_energy_pj(tpower, name, *args) == rc.coded_energy_pj(rpower, name, *args)
    assert tc.codec_overhead(tc.codec_by_name("bus_invert4"), lanes).extra_wires == lanes // 4


# ------------------------------------------------------------------ compare


def test_demo_workloads_bytes_equal():
    ref = rc.demo_workloads(images=2, grad_size=1 << 12, seed=3)
    got = tc.demo_workloads(images=2, grad_size=1 << 12, seed=3, device="cpu")
    assert set(got) == set(ref)
    for name in ref:
        (a,), (b,) = ref[name], got[name]
        assert b.dtype == torch.uint8 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_compare_streams_rows_equal():
    ref_w = rc.demo_workloads(images=1)
    got_w = tc.demo_workloads(images=1, device="cpu")
    conv = conv_streams(n_images=1)
    orderings = ("none", ("app", 4, True), ("column_major", None, False))
    codecs = ("none", "bus_invert4", "transition", "gray")
    cases = [("conv", tuple(jnp.asarray(s) for s in conv), conv, None),
             ("decode", ref_w["decode"], got_w["decode"], 50),
             ("allreduce", ref_w["allreduce"], got_w["allreduce"], None)]
    for name, jstreams, tstreams, chunk in cases:
        ref = rc.compare_streams(jstreams, 16, orderings=orderings, codecs=codecs, workload=name)
        got = tc.compare_streams(tstreams, 16, orderings=orderings, codecs=codecs, workload=name,
                                 chunk_packets=chunk, device="cpu")
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in ref]
        assert [(r.label, r.gross_bt) for r in got] == [(r.label, r.gross_bt) for r in ref]
        assert tc.format_table(got) == rc.format_table(ref)
    # the baseline is prepended when the grid lacks it
    got = tc.compare_streams(conv, 16, orderings=("acc",), codecs=("bus_invert",), device="cpu")
    assert [r.label for r in got] == ["none", "acc+bus_invert"]
    with pytest.raises(ValueError, match="divisible by lanes"):
        tc.compare_streams((conv[0][:, :60],), 16, device="cpu")


# ----------------------------------------------------------------- pipeline

CODED_SPECS = [
    rl.LinkSpec(key="app", codec="bus_invert4"),
    rl.LinkSpec(key="acc", codec="bus_invert", pack="row"),
    rl.LinkSpec(key="column_major", codec="transition"),
    rl.LinkSpec(input_lanes=12, weight_lanes=4, key="app", codec="sign_magnitude"),
]


@pytest.mark.parametrize("spec", CODED_SPECS, ids=str)
def test_coded_pipeline_matches_reference(spec):
    x, w = _bytes((33, spec.elems_per_packet), 4), _bytes((33, spec.weight_elems_per_packet), 5)
    rpipe, tpipe = rl.TxPipeline(spec), tl.TxPipeline(_port(spec), device="cpu")
    for weights in (w, None):  # paired, and an input-only run of the paired spec
        jw = None if weights is None else jnp.asarray(weights)
        ref = rpipe.run(jnp.asarray(x), jw)
        got = tpipe.run(x, weights)
        assert not got.fused and not ref.fused
        for f in ("order", "stream", "bt_input", "bt_weight", "bt_aux"):
            np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                          np.asarray(getattr(got, f)), err_msg=f)
        if ref.invert is None:
            assert got.invert is None
        else:
            np.testing.assert_array_equal(np.asarray(ref.invert), got.invert.numpy())
        rrep, trep = rpipe.measure(jnp.asarray(x), jw), tpipe.measure(x, weights)
        assert dataclasses.asdict(trep) == dataclasses.asdict(rrep)
        assert trep.reduction_vs(tpipe.measure(x, weights)) == 0.0
    # the reference's invariant: the staged coded row equals the
    # bt_count_codecs column of its config
    rep = tpipe.measure(x, w)
    if spec.symmetric:
        col = bt_count_codecs(torch.from_numpy(x), torch.from_numpy(w),
                              (tc.kernel_config(tpipe.spec),), input_lanes=spec.input_lanes,
                              pack=spec.pack)[0]
        assert (rep.input_bt, rep.weight_bt, rep.aux_bt) == tuple(col.tolist())
    with pytest.raises(ValueError, match="cannot run fused"):
        tl.TxPipeline(_port(spec), fused=True, device="cpu").run(x)


def test_coded_row_streams_match_reference():
    rows = _bytes((24, 40), 6)
    for codec, key, pack in (("bus_invert4", "row_bucket", "row"), ("transition", "none", "col"),
                             ("bus_invert", "none", "col")):
        spec = rl.LinkSpec(key=key, pack=pack, codec=codec)
        rpipe, tpipe = rl.TxPipeline(spec), tl.TxPipeline(_port(spec), device="cpu")
        np.testing.assert_array_equal(np.asarray(rpipe.transmit_rows(jnp.asarray(rows))),
                                      tpipe.transmit_rows(rows).numpy())
        assert dataclasses.asdict(tpipe.measure_rows(rows)) == dataclasses.asdict(
            rpipe.measure_rows(jnp.asarray(rows))
        )


def test_coded_reference_spec_crosses_over_and_measures_the_same():
    x, w = _bytes((20, 32), 7), _bytes((20, 32), 8)
    ref_spec = rl.LinkSpec(key="app", k=2, codec="bus_invert4", descending=True)
    power = rl.LinkPowerModel(energy_per_transition_pj=0.2)
    spec, tpower = from_reference(dataclasses.asdict(ref_spec), dataclasses.asdict(power))
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    ref = rl.TxPipeline(ref_spec, power=power).measure(jnp.asarray(x), jnp.asarray(w))
    got = tl.TxPipeline(spec, power=tpower, device="cpu").measure(
        packets_from_numpy(x, "cpu"), packets_from_numpy(w, "cpu"))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.aux_bt > 0 and got.extra_wires == 4


# --------------------------------------------------------------- the pins


def test_both_packages_reproduce_chip_smoke_codec_pins():
    cc = CODEC_COMPARE
    inp, wgt = conv_streams(n_images=cc["conv_images"])
    ref_demo = rc.demo_workloads(images=cc["demo_images"])
    got_demo = tc.demo_workloads(images=cc["demo_images"], device="cpu")
    ref_orderings = tuple(o.key if o.key == "none" else o for o in cc["orderings"])
    for name in cc["bt"]:
        if name == "conv":
            jstreams, tstreams = (jnp.asarray(inp), jnp.asarray(wgt)), (inp, wgt)
        else:
            jstreams, tstreams = ref_demo[name], got_demo[name]
        ref = rc.compare_streams(jstreams, cc["lanes"], orderings=ref_orderings,
                                 codecs=cc["codecs"], workload=name)
        got = tc.compare_streams(tstreams, cc["lanes"], orderings=cc["orderings"],
                                 codecs=cc["codecs"], workload=name, device="cpu")
        assert {r.label: (r.data_bt, r.aux_bt) for r in ref} == cc["bt"][name], name
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in ref]
    u_in, u_wt = uniform_pairs(100_000, 32, seed=0)
    for (key, codec), pin in CODED_TX.items():
        spec = rl.LinkSpec(key=key, codec=codec)
        got = tl.TxPipeline(_port(spec), device="cpu").measure(u_in, u_wt)
        assert (got.input_bt, got.weight_bt, got.aux_bt) == pin, (key, codec)
        ref = np.asarray(rk_bt_count_codecs(jnp.asarray(u_in), jnp.asarray(u_wt),
                                            (rc.kernel_config(spec),), input_lanes=8))[0]
        assert tuple(ref.tolist()) == pin, (key, codec)
