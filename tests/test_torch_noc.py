"""repro_torch.noc against repro.noc on the CPU.

The same numpy-seeded flows go through both packages: topologies, routes
and compiled fabric plans must be equal, the padded distinct-queue wire
streams, lengths, invert-line states and aux counts byte-equal, and every
``simulate_noc`` link row (BT, flits, energy), activity array, latency row
and probe counter equal — exactly, since both packages compute the floats
from the same integers through the same expressions.  The last tests hold
the port and the reference to the NoC pins of ``chip_smoke.py`` phase 3e.
"""

import dataclasses
import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.noc as rn
import repro_torch.noc as tn
from chip_smoke import (
    FLEET,
    NOC_BT,
    NOC_DESIGNS,
    NOC_FABRICS,
    fleet_weights,
    links_digest,
    noc_conv_inputs,
    noc_hop_inputs,
)
from repro import obs as robs
from repro.link import LinkSpec as RSpec
from repro.noc.fabric import _queue_gather_table as ref_queue_gather_table
from repro_torch import obs as tobs
from repro_torch.convert import flows_from_reference
from repro_torch.core.sorting import apply_order
from repro_torch.kernels import psu_sort
from repro_torch.link import LinkSpec as TSpec
from repro_torch.link import make_order
from repro_torch.noc.fabric import _queue_gather_table, _source_sorted

CPU = torch.device("cpu")

TOPOS = {
    "mesh2x2": ("mesh", (2, 2)),
    "mesh3x3": ("mesh", (3, 3)),
    "torus3x3": ("torus", (3, 3)),
    "ring4": ("ring", (4,)),
}
MORE_TOPOS = {"mesh4x4": ("mesh", (4, 4)), "torus2x3": ("torus", (2, 3))}


def _topos(name):
    kind, args = {**TOPOS, **MORE_TOPOS}[name]
    return getattr(rn, kind)(*args), getattr(tn, kind)(*args)


def _pk(p, seed, elems=32):
    return np.random.default_rng(seed).integers(0, 256, (p, elems), dtype=np.uint8)


def _items(num_routers, spec=TSpec(), seed=0, n=4):
    """Multi-tenant-ish endpoints (unicasts and multicasts with shared
    prefixes) as (name, src, dsts, inputs, weights) numpy tuples."""
    far, mid = num_routers - 1, num_routers // 2
    ends = [(0, (far,)), (0, (mid, far)), (1, (far,)), (mid, (0, 1, far))][:n]
    return [
        (f"f{i}", src, dsts, _pk(3 + 2 * i, seed + 2 * i, spec.elems_per_packet),
         _pk(3 + 2 * i, seed + 2 * i + 1, spec.weight_elems_per_packet)
         if spec.weight_lanes else None)
        for i, (src, dsts) in enumerate(ends)
    ]


def _ref_flows(items):
    return [rn.TrafficFlow(name, src, dsts, jnp.asarray(x), None if w is None else jnp.asarray(w))
            for name, src, dsts, x, w in items]


def _specs(**kw):
    return RSpec(**kw), TSpec(**kw)


def _counters(reg, prefixes=("noc.", "link.activity")):
    """Probe counters of one registry, without the backend-labelled
    kernel series and the span timings."""
    return sorted(
        (c["name"], tuple(sorted(c["labels"].items())), c["value"])
        for c in reg.to_dict()["counters"] if c["name"].startswith(prefixes)
    )


# ------------------------------------------------------------ topology / routing


@pytest.mark.parametrize("name", [*TOPOS, *MORE_TOPOS])
def test_topology_and_routes_match_reference(name):
    r, t = _topos(name)
    assert dataclasses.astuple(t) == dataclasses.astuple(r)
    assert (t.num_routers, t.num_links) == (r.num_routers, r.num_links)
    np.testing.assert_array_equal(t.link_table, r.link_table)
    for row in range(t.rows):
        assert t.row_routers(row) == r.row_routers(row)
    for col in range(t.cols):
        assert t.column_routers(col) == r.column_routers(col)
    for a in range(t.num_routers):
        assert t.coords(a) == r.coords(a)
        for b in range(t.num_routers):
            assert tn.route(t, a, b) == rn.route(r, a, b)
            assert tn.unicast_links(t, a, b) == rn.unicast_links(r, a, b)
            assert tn.hop_count(t, a, b) == rn.hop_count(r, a, b)
        dsts = tuple(range(a % 2, t.num_routers, 2))
        assert tn.multicast_links(t, a, dsts) == rn.multicast_links(r, a, dsts)


def test_topology_errors_match_reference():
    for build, args in (("mesh", (1, 1)), ("torus", (1, 3)), ("ring", (2,))):
        with pytest.raises(ValueError) as ref:
            getattr(rn, build)(*args)
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            getattr(tn, build)(*args)
    r, t = rn.mesh(2, 3), tn.mesh(2, 3)
    for call in (lambda m: m.coords(6), lambda m: m.router(2, 0), lambda m: m.link_id(0, 4),
                 lambda m: m.column_routers(3)):
        with pytest.raises(ValueError) as ref:
            call(r)
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            call(t)


@pytest.mark.parametrize("name", TOPOS)
def test_compile_fabric_tables_match_reference(name):
    r, t = _topos(name)
    ends = [(s, d) for s, d, *_ in (it[1:] for it in _items(t.num_routers))]
    rp, tp = rn.compile_fabric(r, ends), tn.compile_fabric(t, ends)
    for field in ("num_flows", "link_ids", "link_queue", "queues", "flow_links", "endpoints"):
        assert getattr(tp, field) == getattr(rp, field), field
    assert (tp.num_queues, tp.active_links) == (rp.num_queues, rp.active_links)
    for lid in tp.link_ids:
        assert tp.queue_of(lid) == rp.queue_of(lid)
    counts = (3, 5, 7, 9)
    table, qcounts = _queue_gather_table(tp, counts, 9, CPU)
    rtable, rq = ref_queue_gather_table(rp, counts, 9)
    np.testing.assert_array_equal(table.numpy(), rtable)
    assert qcounts == rq


@pytest.mark.parametrize("counts", [(9, 9, 9, 9), (0, 5, 0, 9), (1, 1, 1, 1)])
@pytest.mark.parametrize("name", ["mesh3x3", "ring4"])
def test_queue_gather_table_matches_reference(name, counts):
    """Full flows (each queue the identity run of its flow when alone),
    empty flows and one-packet flows: the device-built table equals the
    reference's numpy table, int64, pads at index 0."""
    r, t = _topos(name)
    ends = [(s, d) for s, d, *_ in (it[1:] for it in _items(t.num_routers))]
    rp, tp = rn.compile_fabric(r, ends), tn.compile_fabric(t, ends)
    table, qcounts = _queue_gather_table(tp, counts, 9, CPU)
    rtable, rq = ref_queue_gather_table(rp, counts, 9)
    assert table.dtype == torch.int64 and qcounts == rq
    np.testing.assert_array_equal(table.numpy(), rtable)
    ring = tn.ring(4)
    one = tn.compile_fabric(ring, [(i, ((i + 1) % 4,)) for i in range(4)])
    ident, _ = _queue_gather_table(one, (9, 9, 9, 9), 9, CPU)
    assert torch.equal(ident.reshape(-1), torch.arange(36))


# ------------------------------------------------------------ expansion


_EXPAND = [
    ("none", "source", "none", {}),
    ("acc", "source", "none", {}),
    ("app", "hop", "none", {"descending": True}),
    ("acc", "hop", "transition", {}),
    ("column_major", "source", "gray", {"encode": "gray"}),
    ("app", "source", "bus_invert", {"k": 3}),
    ("none", "hop", "bus_invert4", {}),
    ("acc", "source", "bus_invert4", {"encode": "sign_magnitude", "pack": "row"}),
]


def _expand_both(name, key, sort_at, codec, kw, seed=17):
    r, t = _topos(name)
    rs, ts = _specs(key=key, codec=codec, **kw)
    items = _items(t.num_routers, ts, seed=seed)
    rf, tf = _ref_flows(items), flows_from_reference(items, CPU)
    ends = [(f.src, f.dsts) for f in tf]
    ref = rn.expand_fabric(rn.compile_fabric(r, ends), rn.FlowBatch.from_flows(rf, rs), rs,
                           sort_at=sort_at)
    got = tn.expand_fabric(tn.compile_fabric(t, ends), tn.FlowBatch.from_flows(tf, ts), ts,
                           sort_at=sort_at)
    return ref, got


def _assert_fabric_equal(ref, got):
    assert got.lengths == ref.lengths
    assert got.streams.dtype == torch.uint8
    # the whole padded tensor: each queue's pad rows copy its last real flit
    np.testing.assert_array_equal(got.streams.numpy(), np.asarray(ref.streams))
    for a, b in ((got.aux_bt, ref.aux_bt), (got.inverts, ref.inverts)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.link_lengths() == ref.link_lengths()


# every design on the mesh, half of them each on the torus and the ring
_EXPAND_CASES = [("mesh3x3", *c) for c in _EXPAND] + [
    ("torus3x3" if i % 2 else "ring4", *c) for i, c in enumerate(_EXPAND)]


@pytest.mark.parametrize("name,key,sort_at,codec,kw", _EXPAND_CASES,
                         ids=[f"{n}-{k}-{s}-{c}" for n, k, s, c, _ in _EXPAND_CASES])
def test_expand_fabric_streams_match_reference(name, key, sort_at, codec, kw):
    _assert_fabric_equal(*_expand_both(name, key, sort_at, codec, kw))


@pytest.mark.parametrize("kw", [{"input_lanes": 12, "weight_lanes": 4},
                                {"input_lanes": 16, "weight_lanes": 0, "key": "app"}],
                         ids=["asymmetric", "input-only"])
def test_expand_fabric_framings_match_reference(kw):
    kw = {"key": "acc", **kw}
    _assert_fabric_equal(*_expand_both("mesh2x2", kw.pop("key"), "hop", "bus_invert", kw))


def test_expand_fabric_identity_queues_match_reference():
    """One flow per queue, all of one length (a ring all-reduce step): the
    batch is already queued and the gather table is skipped."""
    r, t = rn.ring(4), tn.ring(4)
    rs, ts = _specs(input_lanes=16, weight_lanes=0, key="app")
    grad = np.random.default_rng(3).standard_normal(4 * 64 * 5).astype(np.float32)
    rf = rn.ring_allreduce_flows(jnp.asarray(grad), r, spec=rs)
    tf = tn.ring_allreduce_flows(torch.from_numpy(grad), t, spec=ts)
    ends = [(f.src, f.dsts) for f in tf]
    plan = tn.compile_fabric(t, ends)
    assert plan.queues == tuple((f,) for f in range(len(tf)))
    ref = rn.expand_fabric(rn.compile_fabric(r, ends), rn.FlowBatch.from_flows(rf, rs), rs)
    _assert_fabric_equal(ref, tn.expand_fabric(plan, tn.FlowBatch.from_flows(tf, ts), ts))


@pytest.mark.parametrize("codec", ["none", "bus_invert"])
def test_link_streams_match_reference(codec):
    r, t = _topos("mesh3x3")
    rs, ts = _specs(key="acc", codec=codec)
    items = _items(t.num_routers, ts, seed=5)
    ref = rn.expand_link_streams(r, _ref_flows(items), rs, sort_at="hop")
    got = tn.expand_link_streams(t, flows_from_reference(items, CPU), ts, sort_at="hop")
    assert (got.link_ids, got.lengths, tuple(got.aux_bt)) == (
        ref.link_ids, ref.lengths, tuple(ref.aux_bt))
    np.testing.assert_array_equal(got.streams.numpy(), np.asarray(ref.streams))
    assert len(got.inverts) == len(ref.inverts)
    for a, b in zip(got.inverts, ref.inverts):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jagged = [torch.from_numpy(_pk(n, n, 16)) for n in (1, 4, 3)]
    stacked, lengths = tn.stack_link_streams(jagged, 16)
    rstacked, rlengths = rn.stack_link_streams([jnp.asarray(s.numpy()) for s in jagged], 16)
    assert lengths == rlengths
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(rstacked))


def test_source_order_from_psu_sort_equals_make_order():
    """The fabric's ACC / APP source order is ``psu_sort``: the same stable
    counting sort as ``make_order`` for every key, k and direction."""
    x = torch.from_numpy(_pk(257, 9, 24))
    for width in (4, 8):
        for k in [None, *range(1, width + 2)]:
            for desc in (False, True):
                key = "acc" if k is None else "app"
                order = psu_sort(x, width=width, k=k, descending=desc, backend="torch")[0]
                want = make_order(key, x, width=width, k=k or 4, descending=desc)
                assert torch.equal(order, want), (width, k, desc)
    for key in ("none", "column_major", "acc", "app"):
        spec = TSpec(key=key, input_lanes=8, weight_lanes=8, flits_per_packet=3)
        w = torch.from_numpy(_pk(257, 10, 24))
        xs, ws = _source_sorted(x, w, spec, None)
        order = make_order(key, x, lanes=8, width=8, k=4)
        assert torch.equal(xs, apply_order(x, order)) and torch.equal(ws, apply_order(w, order))


def test_expansion_errors_match_reference():
    r, t = _topos("ring4")
    items = _items(4, seed=1, n=2)
    rf, tf = _ref_flows(items), flows_from_reference(items, CPU)
    rplan, tplan = (m.compile_fabric(g, [(f.src, f.dsts) for f in tf])
                    for m, g in ((rn, r), (tn, t)))
    cases = [
        (lambda m, f, p, s: m.expand_fabric(p, m.FlowBatch.from_flows(f[:1], s), s), {}),
        (lambda m, f, p, s: m.expand_fabric(p, m.FlowBatch.from_flows(f, s), s,
                                            sort_at="sink"), {}),
        (lambda m, f, p, s: m.expand_fabric(p, m.FlowBatch.from_flows(f, s), s),
         {"key": "row_bucket"}),
        (lambda m, f, p, s: m.FlowBatch.from_flows(f, s), {"input_lanes": 16, "weight_lanes": 0}),
        (lambda m, f, p, s: m.TrafficFlow("x", 0, (), f[0].inputs), {}),
    ]
    for call, kw in cases:
        rs, ts = _specs(**kw)
        with pytest.raises(ValueError) as ref:
            call(rn, rf, rplan, rs)
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            call(tn, tf, tplan, ts)


def test_empty_and_self_traffic_match_reference():
    r, t = _topos("mesh2x2")
    rep = tn.simulate_noc(t, [])
    ref = rn.simulate_noc(r, [])
    assert (rep.links, rep.flow_hops, rep.total_links) == (ref.links, ref.flow_hops,
                                                           ref.total_links)
    assert tn.expand_link_streams(t, []).streams.shape[0] == 0
    x = _pk(3, 4)
    own = [("self", 1, (1,), x, _pk(3, 5))]
    got = tn.simulate_noc(t, flows_from_reference(own, CPU))
    ref = rn.simulate_noc(r, _ref_flows(own))
    assert (got.links, got.flow_hops) == (ref.links, ref.flow_hops) == ((), (("self", 0),))


# ------------------------------------------------------------ simulate_noc


_SIM = [
    ("mesh3x3", {"key": "acc"}, "source", None, False),
    ("mesh3x3", {"key": "app", "codec": "bus_invert4"}, "hop", 3, False),
    ("torus3x3", {"key": "none", "codec": "bus_invert"}, "source", 4, True),
    ("ring4", {"key": "acc", "codec": "transition"}, "hop", None, True),
    ("ring4", {"key": "app", "k": 2, "codec": "bus_invert4"}, "source", 1, False),
]


@pytest.mark.parametrize("name,kw,sort_at,windows,lat", _SIM,
                         ids=[f"{n}-{k.get('key')}-{s}-w{w}-lat{int(lt)}"
                              for n, k, s, w, lt in _SIM])
def test_simulate_noc_matches_reference(name, kw, sort_at, windows, lat):
    r, t = _topos(name)
    rs, ts = _specs(**kw)
    items = _items(t.num_routers, ts, seed=23)
    rlat, tlat = ((rn.NocLatencyModel(clock_ghz=1.0, router_cycles=2),
                   tn.NocLatencyModel(clock_ghz=1.0, router_cycles=2)) if lat else (None, None))
    with robs.collect() as rreg:
        ref = rn.simulate_noc(r, _ref_flows(items), rs, sort_at=sort_at, activity_windows=windows,
                              latency=rlat, name="fab")
    with tobs.collect() as treg:
        got = tn.simulate_noc(t, flows_from_reference(items, CPU), ts, sort_at=sort_at,
                              activity_windows=windows, latency=tlat, name="fab")
    assert [dataclasses.astuple(s) for s in got.links] == [
        dataclasses.astuple(s) for s in ref.links]
    for field in ("name", "topology", "sort_at", "key", "flow_hops", "total_links",
                  "activity_window", "wire_lanes", "total_bt", "total_aux_bt", "gross_bt",
                  "total_flit_hops", "energy_pj", "max_hops", "active_links"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.reduction_vs(got) == ref.reduction_vs(ref)
    assert len(got.wire_toggles) == len(ref.wire_toggles)
    for a, b in zip(got.wire_toggles + got.wire_ones, ref.wire_toggles + ref.wire_ones):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, np.asarray(b))
    if lat:
        assert got.latency.links == ref.latency.links
        assert got.latency.flows == ref.latency.flows
        for p in ("max_latency_ns", "mean_latency_ns", "total_wait_cycles", "contended_links"):
            assert getattr(got.latency, p) == getattr(ref.latency, p)
    else:
        assert got.latency is ref.latency is None
    # the probe events (noc.link, noc.contend, link.activity) and span counts
    assert _counters(treg) == _counters(rreg)
    if windows:
        for p, s in zip(tobs.profiles_from_noc(got), got.links):
            p.check(s.gross_bt)


def test_latency_model_matches_reference():
    r, t = _topos("mesh3x3")
    ends = [(s, d) for s, d, *_ in (it[1:] for it in _items(9))]
    flits = [12, 20, 28, 36]
    for kw in ({}, {"clock_ghz": 2.0, "router_cycles": 0, "link_cycles": 3}):
        rm, tm = rn.NocLatencyModel(**kw), tn.NocLatencyModel(**kw)
        got = tn.fabric_latency(tn.compile_fabric(t, ends), flits, tm)
        ref = rn.fabric_latency(rn.compile_fabric(r, ends), flits, rm)
        assert (got.links, got.flows) == (ref.links, ref.flows)
        for hops, fl in ((0, 5), (3, 1), (4, 383)):
            assert tn.route_latency_cycles(hops, fl, tm) == rn.route_latency_cycles(hops, fl, rm)
            assert tn.route_latency_ns(hops, fl, tm) == rn.route_latency_ns(hops, fl, rm)
    for bad in ({"clock_ghz": 0}, {"link_cycles": 0}):
        with pytest.raises(ValueError) as ref:
            rn.NocLatencyModel(**bad)
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            tn.NocLatencyModel(**bad)
    with pytest.raises(ValueError, match="3 flit counts for 4 flows"):
        tn.fabric_latency(tn.compile_fabric(t, ends), flits[:3])


def test_power_model_matches_reference():
    rp, tp = rn.NocPowerModel(), tn.NocPowerModel(router_flit_energy_pj=0.98)
    assert dataclasses.astuple(tp) == dataclasses.astuple(rp)
    assert tp.hop_energy_pj(1234, 56) == rp.hop_energy_pj(1234, 56)
    assert tp.coded_hop_energy_pj(1234, 17, 56, 128, 4) == rp.coded_hop_energy_pj(
        1234, 17, 56, 128, 4)
    pw = np.arange(132) % 7
    assert tp.wire_hop_energy_pj(pw, 56, data_wires=128, extra_wires=4) == \
        rp.wire_hop_energy_pj(pw, 56, data_wires=128, extra_wires=4)


# ------------------------------------------------------------ adapters


def _assert_flows_equal(got, ref):
    assert [(f.name, f.src, f.dsts) for f in got] == [(f.name, f.src, f.dsts) for f in ref]
    for g, r in zip(got, ref):
        assert g.inputs.dtype == torch.uint8
        np.testing.assert_array_equal(g.inputs.numpy(), np.asarray(r.inputs))
        assert (g.weights is None) == (r.weights is None)
        if g.weights is not None:
            np.testing.assert_array_equal(g.weights.numpy(), np.asarray(r.weights))


def test_adapters_match_reference():
    rng = np.random.default_rng(31)
    r, t = rn.mesh(3, 3), tn.mesh(3, 3)
    patches, kernel = rng.integers(0, 256, (70, 25), dtype=np.uint8), _pk(1, 2, 25)[0]
    for kw in ({}, {"input_lanes": 16, "weight_lanes": 0}):
        rs, ts = _specs(**kw)
        _assert_flows_equal(
            tn.conv_platform_flows(torch.from_numpy(patches), torch.from_numpy(kernel), t, 0,
                                   [1, 2, 4, 5, 7], ts),
            rn.conv_platform_flows(jnp.asarray(patches), jnp.asarray(kernel), r, 0,
                                   [1, 2, 4, 5, 7], rs))
    rs, ts = _specs(input_lanes=16, weight_lanes=0)
    weight = rng.standard_normal((24, 40)).astype(np.float32)
    for mp in (None, 7):
        _assert_flows_equal(
            tn.decode_weight_flows(torch.from_numpy(weight), t, 3, (4, 5), ts, max_packets=mp),
            rn.decode_weight_flows(jnp.asarray(weight), r, 3, (4, 5), rs, max_packets=mp))
    for w in (fleet_weights()[:40], weight):
        _assert_flows_equal(
            tn.fleet_decode_flows(torch.from_numpy(w), t, users=4, layers=2, shards=2, spec=ts),
            rn.fleet_decode_flows(jnp.asarray(w), r, users=4, layers=2, shards=2, spec=rs))
    grad = rng.standard_normal(64 * 21 + 5).astype(np.float32)
    codes = rng.integers(-128, 128, 64 * 21 + 5).astype(np.int8)
    for g, routers in ((grad, None), (codes, (0, 4, 8, 2)), (grad[:64], (1, 2, 3))):
        _assert_flows_equal(tn.ring_allreduce_flows(torch.from_numpy(g), t, routers, ts),
                            rn.ring_allreduce_flows(jnp.asarray(g), r, routers, rs))
    expert_in = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    expert_in[:, 1] = 0  # an all-zero buffer quantizes to zero bytes
    for x in (expert_in, expert_in.astype(np.int8)):
        _assert_flows_equal(tn.moe_dispatch_flows(torch.from_numpy(x), t, 0, (4, 8), ts),
                            rn.moe_dispatch_flows(jnp.asarray(x), r, 0, (4, 8), rs))
    np.testing.assert_array_equal(
        tn.packetize(torch.from_numpy(patches), 32).numpy(),
        np.asarray(rn.packetize(jnp.asarray(patches), 32)))
    for call in (lambda m, x, s, tp: m.packetize(x[:1, :3], 32),
                 lambda m, x, s, tp: m.decode_weight_flows(x, tp, 0, (1,)),
                 lambda m, x, s, tp: m.fleet_decode_flows(x, tp, users=1, layers=1, shards=3,
                                                          spec=s),
                 lambda m, x, s, tp: m.moe_dispatch_flows(x[:1, :3], tp, 0, (1,), s)):
        pairs = ((rn, jnp.asarray(patches), rs, r), (tn, torch.from_numpy(patches), ts, t))
        with pytest.raises(ValueError) as ref:
            call(*pairs[0])
        with pytest.raises(ValueError) as got:
            call(*pairs[1])
        assert str(got.value) == str(ref.value)


# ------------------------------------------------------------ chip_smoke pins


def _conv_flows(mod, topo, src, pes, patches, kernel):
    """noc_bt.py's conv-platform flows, built by either package."""
    to, spec = (torch.from_numpy, TSpec()) if mod is tn else (jnp.asarray, RSpec())
    return [f for pt in patches for f in mod.conv_platform_flows(
        to(pt), to(kernel), topo, src, list(pes), spec)]


def _check_noc_bt_pins(mod):
    """benchmarks/noc_bt.py's defaults through ``mod`` (the port's plain
    versions or the reference) against chip_smoke.py's NOC_BT pins: every
    design on both fabrics, the hot links, the hop sweep and the coded
    fabric."""
    to, spec_cls, obs = (torch.from_numpy, TSpec, tobs) if mod is tn else (
        jnp.asarray, RSpec, robs)
    patches, kernel = noc_conv_inputs(NOC_BT["n_images"])
    for kind, args, src, pes in NOC_FABRICS:
        topo = getattr(mod, kind)(*args)
        tname = f"{topo.kind}{topo.rows}x{topo.cols}"
        flows = _conv_flows(mod, topo, src, pes, patches, kernel)
        for key, sort_at in NOC_DESIGNS:
            with obs.collect() as reg:
                rep = mod.simulate_noc(topo, flows, spec_cls(key=key), sort_at=sort_at)
            got = [rep.total_bt, rep.active_links, rep.total_flit_hops, links_digest(rep)]
            assert got == NOC_BT["designs"][tname][f"{key}-{sort_at}"], (tname, key, sort_at)
            if (kind, key, sort_at) == ("mesh", "acc", "source"):
                hot = [[r["link"], r["gross_bt"]] for r in obs.top_links(reg, 3)]
                assert hot == NOC_BT["hot_links"]
        if kind == "mesh":
            mesh, mesh_flows = topo, flows
    pkts, wgts, dests = noc_hop_inputs(NOC_BT["max_hops"])
    hops = [[mod.hop_count(mesh, 0, d)] + [mod.simulate_noc(mesh, [mod.TrafficFlow(
        "sweep", 0, (d,), to(pkts), to(wgts))], spec_cls(key=k)).total_bt
        for k in ("none", "acc")] for d in dests]
    assert hops == NOC_BT["hops"]
    rep = mod.simulate_noc(mesh, mesh_flows, spec_cls(key="acc", codec="bus_invert4"))
    assert [rep.total_bt, rep.total_aux_bt] == NOC_BT["coded"]


def test_port_equals_noc_bt_pins():
    """The port (plain versions) equals the JAX pins of chip_smoke.py
    phase 3e."""
    _check_noc_bt_pins(tn)


def test_reference_equals_noc_bt_pins(tmp_path):
    """The pins are the JAX package's, every one of them; the mesh ACC
    fabric also wire by wire, into the SAIF digest, which the port's text
    equals."""
    _check_noc_bt_pins(rn)
    patches, kernel = noc_conv_inputs(NOC_BT["n_images"])
    kind, args, src, pes = NOC_FABRICS[0]
    assert kind == "mesh"
    topo = getattr(rn, kind)(*args)
    rep = rn.simulate_noc(topo, _conv_flows(rn, topo, src, pes, patches, kernel),
                          RSpec(key="acc"), activity_windows=NOC_BT["window"])
    got = [rep.total_bt, rep.active_links, rep.total_flit_hops, links_digest(rep)]
    assert got == NOC_BT["designs"]["mesh4x4"]["acc-source"]
    text = robs.write_saif(str(tmp_path / "r.saif"), robs.profiles_from_noc(rep),
                           design="noc_bt")
    assert hashlib.sha256(text.encode()).hexdigest() == NOC_BT["saif_sha256"]
    ttopo = getattr(tn, kind)(*args)
    trep = tn.simulate_noc(ttopo, _conv_flows(tn, ttopo, src, pes, patches, kernel),
                           TSpec(key="acc"), activity_windows=NOC_BT["window"])
    ttext = tobs.write_saif(str(tmp_path / "t.saif"), tobs.profiles_from_noc(trep),
                            design="noc_bt")
    assert ttext == text


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_fleet_pins(pkg):
    """benchmarks/fleet_noc.py's defaults: the plan, the none / ACC / APP
    fabrics' BT and the contention model."""
    fl = FLEET
    mod, spec_cls, to = (tn, TSpec, torch.from_numpy) if pkg == "port" else (
        rn, RSpec, jnp.asarray)
    topo = mod.mesh(fl["rows"], fl["cols"])
    spec = spec_cls(input_lanes=16, weight_lanes=0, key="acc")
    flows = mod.fleet_decode_flows(to(fleet_weights()), topo, users=fl["users"],
                                   layers=fl["layers"], shards=fl["shards"], spec=spec)
    plan = mod.compile_fabric(topo, [(f.src, f.dsts) for f in flows])
    assert [len(flows), plan.active_links, plan.num_queues] == fl["plan"]
    for key in ("none", "acc", "app"):
        rep = mod.simulate_noc(topo, flows, dataclasses.replace(spec, key=key))
        assert rep.total_bt == fl["bt"][key], key
    lat = mod.fabric_latency(plan, [int(f.inputs.shape[0]) * 4 for f in flows])
    assert [lat.max_latency_ns, lat.mean_latency_ns, lat.contended_links] == fl["latency"]
