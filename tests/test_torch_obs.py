"""The port's observability package against repro.obs on the CPU.

``repro_torch.obs`` is the reference's ``repro.obs`` without its model-zoo
capture: the same activity profiles give byte-identical SAIF / VCD /
heatmap CSV text, the registry and trace schemas round-trip, the probe
vocabulary is the reference's, and the probes the port fires
(``kernel.dispatch``, ``link.tx`` / ``link.stage`` / ``link.report``,
``codec.stream``) carry the reference's values.  With observability
absent, imported or collecting, every output of the port's entry points
is the same, and no probe payload holds a tensor.  Under ``profiled()``
the probe spans are ``torch.profiler`` ranges, nested as the calls nest;
with nothing active no probe builds a payload.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codec as rcodec
import repro.kernels as rk
import repro.link as rlink
import repro.obs as robs
import repro_torch.codec as tcodec
import repro_torch.kernels as tk
import repro_torch.link as tlink
import repro_torch.noc as tnoc
import repro_torch.obs as tobs
import repro_torch.traffic as ttraffic
from repro.obs import probes as rprobes
from repro_torch import _obs_hooks
from repro_torch.obs import probes as tprobes
from torch_groups import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = [("none", None, False, "none", None), ("acc", None, False, "bus_invert", 4),
           ("app", 4, True, "transition", None), ("none", None, False, "gray", None)]


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _profiles(obs, arrays, window=5, lanes=8):
    """Profiles of one port activity result, built by ``obs`` (either
    package) from numpy copies of the arrays."""
    toggles, ones, duration = arrays
    return [
        obs.profile_from_arrays(f"cfg{ci}", toggles[ci], ones[ci], window_flits=window,
                                duration_flits=duration, data_lanes=lanes)
        for ci in range(len(toggles))
    ]


@pytest.fixture(scope="module")
def activity():
    x = _bytes((23, 32), 3)
    got = tk.bt_count_codecs(torch.from_numpy(x), None,
                             tuple(tk.CodecVariant(*c) for c in CONFIGS), input_lanes=8,
                             activity_windows=5)
    return got.toggles.numpy(), got.ones.numpy(), 23 * 4


def test_saif_vcd_and_wire_csv_text_identical_to_reference(tmp_path, activity):
    tprofs, rprofs = _profiles(tobs, activity), _profiles(robs, activity)
    ttext = tobs.write_saif(str(tmp_path / "t.saif"), tprofs, design="codec_bt")
    rtext = robs.write_saif(str(tmp_path / "r.saif"), rprofs, design="codec_bt")
    assert ttext == rtext
    assert (tmp_path / "t.saif").read_bytes() == (tmp_path / "r.saif").read_bytes()
    # parse_saif round-trips every net of every profile
    doc = tobs.parse_saif(str(tmp_path / "t.saif"))
    assert doc == robs.parse_saif(str(tmp_path / "r.saif"))
    assert doc["duration"] == 92 and doc["design"] == "codec_bt"
    for prof in tprofs:
        nets = doc["instances"][prof.name]
        assert [nets[n]["TC"] for n in prof.wire_names()] == prof.per_wire.tolist()
        assert [nets[n]["T1"] for n in prof.wire_names()] == prof.ones.tolist()
    trows = tobs.write_wires_csv(str(tmp_path / "t.csv"), tprofs)
    rrows = robs.write_wires_csv(str(tmp_path / "r.csv"), rprofs)
    assert trows == rrows
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()
    # a coded stream as a waveform: a tensor and an array give the reference's text
    stream, inv = _bytes((40, 4), 5), _bytes((40, 2), 6) & 1
    vt = tobs.write_vcd(str(tmp_path / "t.vcd"), torch.from_numpy(stream),
                        inverts=torch.from_numpy(inv), name="link0")
    assert vt == robs.write_vcd(str(tmp_path / "r.vcd"), stream, inverts=inv, name="link0")


def test_profiles_take_tensors_and_link_batches(activity):
    toggles, ones, duration = activity
    kw = dict(window_flits=5, duration_flits=duration, data_lanes=8)
    a = tobs.profile_from_arrays("t", torch.from_numpy(toggles[1]), torch.from_numpy(ones[1]),
                                 **kw)
    b = tobs.profile_from_arrays("t", toggles[1], ones[1], **kw)
    assert np.array_equal(a.toggles, b.toggles) and np.array_equal(a.ones, b.ones)
    assert a.toggles.dtype == np.int64 and a.aux_wires == toggles.shape[-1] - 64
    streams = _bytes((3, 50, 8), 7)
    lengths = [50, 20, 1]
    got = tk.bt_count_links(torch.from_numpy(streams), lengths=lengths, activity_windows=8)
    ref = rk.bt_count_links(jnp.asarray(streams), lengths=jnp.asarray(lengths),
                            activity_windows=8)
    tprofs = tobs.link_profiles(got, window_flits=8, lengths=lengths, data_lanes=8)
    rprofs = robs.link_profiles(ref, window_flits=8, lengths=lengths, data_lanes=8)
    for tp, rp, bt in zip(tprofs, rprofs, got.bt.sum(-1).tolist()):
        tp.check(bt)
        assert tp.num_windows == rp.num_windows == -(-tp.duration_flits // 8)
        assert np.array_equal(tp.toggles, rp.toggles) and np.array_equal(tp.ones, rp.ones)
        assert tp.hottest_wires(4) == rp.hottest_wires(4)
    # a NoC report is read duck-typed, as the reference reads simulate_noc's
    from types import SimpleNamespace

    report = SimpleNamespace(
        name="mesh", activity_window=8, wire_lanes=8, wire_toggles=got.toggles,
        wire_ones=got.ones, links=[SimpleNamespace(link=i, num_flits=n)
                                   for i, n in enumerate(lengths)])
    tnoc = tobs.profiles_from_noc(report)
    rnoc = robs.profiles_from_noc(SimpleNamespace(
        **{**vars(report), "wire_toggles": ref.toggles, "wire_ones": ref.ones}))
    assert [p.name for p in tnoc] == [p.name for p in rnoc] == ["mesh.link0", "mesh.link1",
                                                                 "mesh.link2"]
    for tp, rp in zip(tnoc, rnoc):
        assert np.array_equal(tp.toggles, rp.toggles) and np.array_equal(tp.ones, rp.ones)
    with pytest.raises(ValueError, match="carries no activity"):
        tobs.profiles_from_noc(SimpleNamespace(name="x", activity_window=0))


def test_registry_round_trip_and_reference_schema():
    regs = []
    for obs in (tobs, robs):
        reg = obs.Registry()
        reg.counter("codec.stream.bt", workload="conv", stream="conv[0]").inc(12)
        reg.counter("kernel.dispatch.calls", entry="bt_count", backend="cuda").inc()
        reg.gauge("links", topology="mesh").set(4)
        h = reg.histogram("kernel.dispatch.seconds", entry="bt_count")
        for v in (0.5, 1.5, 4.0):
            h.observe(v)
        reg.histogram("empty")
        regs.append(reg)
    doc = regs[0].to_dict()
    assert doc == regs[1].to_dict()
    json.dumps(doc)
    again = tobs.registry_from_dict(json.loads(json.dumps(doc)))
    assert again.to_dict() == doc
    assert again.value("codec.stream.bt", workload="conv", stream="conv[0]") == 12
    assert again.histogram("kernel.dispatch.seconds", entry="bt_count").mean == 2.0
    with pytest.raises(ValueError, match="negative"):
        again.counter("x").inc(-1)


def test_tracer_chrome_schema(tmp_path):
    x = torch.from_numpy(_bytes((8, 32), 1))
    tracer = tobs.Tracer()
    with tobs.tracing(tracer):
        with _obs_hooks.span("bench.module", module="demo"):
            tk.bt_count(x)
        _obs_hooks.event("noc.link", link=0, shape=(2, 3))
    doc = tracer.to_chrome(metadata={"git_sha": "abc"})
    json.dumps(doc)
    assert doc["metadata"] == {"torch": torch.__version__, "cuda": torch.version.cuda,
                               "device": "cpu", "device_count": 0, "git_sha": "abc"}
    assert doc["traceEvents"][0]["ph"] == "M"
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"bench.module", "kernel.dispatch"}
    for e in spans:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"} <= set(e)
        assert e["dur"] >= 0
    outer = next(e for e in spans if e["name"] == "bench.module")
    inner = next(e for e in spans if e["name"] == "kernel.dispatch")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0
    assert inner["args"] == {"entry": "bt_count", "backend": "torch", "kernel_launches": 0,
                             "shape": [8, 32], "width": 8}
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert instants and instants[0]["args"]["shape"] == [2, 3]
    out = tracer.write(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == out


def test_report_tables_empty_registry(tmp_path):
    reg = tobs.Registry()
    assert tobs.link_table(reg) == tobs.activity_table(reg) == []
    assert tobs.top_links(reg) == tobs.top_wires(reg) == []
    doc = tobs.metrics_dict(reg)
    assert doc == robs.metrics_dict(robs.Registry())
    assert doc["links"] == [] and "activity" not in doc
    assert tobs.write_links_csv(str(tmp_path / "l.csv"), reg) == []
    assert (tmp_path / "l.csv").read_text().strip().split(",") == list(
        robs.report.LINK_FIELDS)
    assert tobs.format_links([]) == robs.format_links([])
    assert tobs.scenario_table([{"scenario": "a", "red_acc": 0.1234567}]) == robs.scenario_table(
        [{"scenario": "a", "red_acc": 0.1234567}])
    path = tmp_path / "m.json"
    tobs.write_metrics_json(str(path), reg)
    assert tobs.read_metrics_json(str(path)).to_dict() == reg.to_dict()


def test_port_probe_kinds_are_the_ports_own():
    assert tobs.PROBE_KINDS == robs.PROBE_KINDS
    assert not set(tobs.PORT_PROBE_KINDS) & set(tobs.PROBE_KINDS)
    assert set(tprobes._PORT_SPAN_LABELS) == set(tobs.PORT_PROBE_KINDS)
    assert not set(tprobes._PORT_SPAN_LABELS) & set(tprobes._SPAN_LABELS)
    # the registry's rule: <kind>.calls and <kind>.seconds by the stage label
    with tobs.collect() as reg:
        _egress(), _ring()
    for stage in NOC_STAGES:
        assert reg.value("noc.stage.calls", stage=stage) == 1, stage
        assert reg.histogram("noc.stage.seconds", stage=stage).count == 1, stage
    for stage in TRAFFIC_STAGES:
        assert reg.value("traffic.stage.calls", stage=stage) == 1, stage


def test_probe_vocabulary_is_the_reference():
    assert tobs.PROBE_KINDS == robs.PROBE_KINDS
    assert tprobes._SPAN_LABELS == rprobes._SPAN_LABELS
    assert not _obs_hooks.active() and _obs_hooks.SINK is None
    with tobs.collect():
        assert _obs_hooks.active()
        with tobs.tracing():
            pass
        assert _obs_hooks.active()
    assert _obs_hooks.SINK is None and not _obs_hooks.capturing()
    with _obs_hooks.span("kernel.dispatch", entry="x"):
        pass
    _obs_hooks.event("noc.link", link=0)  # swallowed while nothing collects


def test_compare_streams_codec_stream_series_match_reference():
    demo = rcodec.demo_workloads(images=1)
    streams = [np.array(s) for s in demo["conv"] + demo["decode"]]
    kw = dict(orderings=("none", rk.Variant("acc")), codecs=("none", "bus_invert4"),
              workload="mix")
    with robs.collect() as rreg:
        rrows = rcodec.compare_streams([jnp.asarray(s) for s in streams], 16, **kw)
    kw["orderings"] = ("none", tk.Variant("acc"))
    with tobs.collect() as treg:
        trows = tcodec.compare_streams([torch.from_numpy(s) for s in streams], 16, **kw)
    assert [(r.label, r.data_bt, r.aux_bt) for r in trows] == [
        (r.label, r.data_bt, r.aux_bt) for r in rrows]

    def series(reg):
        return sorted((s.labels["stream"], s.value) for s in reg.series("codec.stream.bt"))

    assert series(treg) == series(rreg)
    assert len(series(treg)) == 2
    assert treg.value("kernel.dispatch.calls", entry="bt_count_axes", backend="torch") == 2


def test_tx_pipeline_fires_link_probes_with_reference_values():
    x = _bytes((40, 32), 9)
    w = _bytes((40, 32), 10)
    for key, codec in (("acc", "none"), ("column_major", "none"), ("app", "bus_invert4")):
        with robs.collect() as rreg:
            rrep = rlink.TxPipeline(rlink.LinkSpec(key=key, codec=codec)).measure(
                jnp.asarray(x), jnp.asarray(w), name="s0")
        with tobs.collect() as treg:
            trep = tlink.TxPipeline(tlink.LinkSpec(key=key, codec=codec), device="cpu").measure(
                x, w, name="s0")
        path = "fused" if key == "acc" else "staged"
        for reg in (rreg, treg):
            assert reg.value("link.tx.calls", path=path, key=key, codec=codec) == 1
        for side in ("input", "weight", "aux"):
            assert (treg.value("link.bt", side=side, stream="s0")
                    == rreg.value("link.bt", side=side, stream="s0"))
        assert treg.value("link.flits", stream="s0") == rrep.num_flits == trep.num_flits
        assert treg.value("link.energy_pj", stream="s0") == pytest.approx(rrep.energy_pj)
        stages = ("order", "assemble", "codec", "bt") if codec != "none" else (
            ("order", "assemble", "bt") if path == "staged" else ())
        for stage in stages:
            assert treg.value("link.stage.calls", stage=stage) == 1


class _Recorder:
    """A sink that keeps every raw probe payload."""

    def __init__(self):
        self.payloads = []

    def span(self, kind, data):
        self.payloads.append((kind, data))
        return _obs_hooks._NULL_SPAN

    def event(self, kind, data):
        self.payloads.append((kind, data))


def _json_scalar(v):
    if isinstance(v, (tuple, list)):
        return all(_json_scalar(u) for u in v)
    return v is None or isinstance(v, (bool, int, float, str))


NOC_STAGES = ("plan", "batch", "source_order", "gather", "queue", "assemble", "pad",
              "readback", "links")
TRAFFIC_STAGES = ("int8_view", "egress_permutation", "egress_base")


def _egress():
    """int8_view and egress_permutation on a weight vector with a tail."""
    w = torch.from_numpy(np.random.default_rng(4).normal(size=64 * 9 + 7).astype(np.float32))
    return ttraffic.egress_permutation(ttraffic.int8_view(w), packet=64, strategy="app", k=4)


def _ring():
    """One reduce-scatter step on ring(4) under APP at the source: shards
    of 37, 37, 37 and 40 packets, so the queues are padded."""
    codes = torch.from_numpy(_bytes(151 * 64, 8).view(np.int8))
    spec = tlink.LinkSpec(width_bits=128, flits_per_packet=4, input_lanes=16, weight_lanes=0,
                          k=4, key="app")
    topo = tnoc.ring(4)
    return tnoc.simulate_noc(topo, tnoc.ring_allreduce_flows(codes, topo, spec=spec), spec)


# each program range under profiled() and the range it is nested in
NESTING = {
    ("repro_torch.traffic.int8_view", None),
    ("repro_torch.traffic.egress_permutation", None),
    ("repro_torch.kernel.psu_sort", "repro_torch.traffic.egress_permutation"),
    ("repro_torch.traffic.egress_base", "repro_torch.traffic.egress_permutation"),
    ("repro_torch.noc.simulate", None),
    *((f"repro_torch.noc.{s}", "repro_torch.noc.simulate")
      for s in ("plan", "batch", "expand", "readback", "links")),
    ("repro_torch.kernel.bt_count_links", "repro_torch.noc.simulate"),
    *((f"repro_torch.noc.{s}", "repro_torch.noc.expand")
      for s in ("source_order", "queue", "assemble", "pad")),
    ("repro_torch.kernel.psu_sort", "repro_torch.noc.source_order"),
    ("repro_torch.noc.gather", "repro_torch.noc.source_order"),
}


def test_profiled_spans_are_ranges_of_the_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outside"):
            _egress(), _ring()  # no range while profiled() is off
        with tobs.profiled():
            assert _obs_hooks.active()
            with tobs.profiled():  # nested scopes: still one range a span
                _egress()
            _ring()
    assert _obs_hooks.SINK is None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((e["ts"], -e["dur"], e["name"])
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "user_annotation" and e["name"].startswith("repro_torch."))
    outside = next(e for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "user_annotation" and e["name"] == "outside")
    assert all(ts > outside["ts"] + outside["dur"] for ts, _, _ in spans)
    pairs, open_ = [], []
    for ts, neg, name in spans:
        open_ = [(t, d, n) for t, d, n in open_ if ts < t + d]
        pairs.append((name, open_[-1][2] if open_ else None))
        open_.append((ts, -neg, name))
    assert set(pairs) == NESTING
    assert sorted(n for n, _ in pairs) == sorted(n for n, _ in NESTING)  # each range once


def test_no_probe_builds_a_payload_while_nothing_collects(monkeypatch):
    assert _obs_hooks.SINK is None
    want_ring, want_egress = _ring(), _egress()
    spans, stages = [], []

    def span(kind, **data):
        spans.append((kind, data))
        return _obs_hooks._NULL_SPAN

    def stage(*args, **data):
        stages.append((args, data))
        return _obs_hooks._NULL_SPAN

    monkeypatch.setattr(_obs_hooks, "span", span)
    monkeypatch.setattr(_obs_hooks, "stage", stage)
    got_ring, got_egress = _ring(), _egress()
    assert got_ring == want_ring
    assert all(torch.equal(a, b) for a, b in zip(got_egress, want_egress))
    assert {k for k, _ in spans} == {"noc.simulate", "noc.expand", "kernel.dispatch"}
    assert all(data == {} for _, data in spans), spans
    assert all(data == {} for _, data in stages)
    assert sorted(a for a, _ in stages) == sorted(
        [("noc.stage", s) for s in NOC_STAGES] + [("traffic.stage", s) for s in TRAFFIC_STAGES])


# the port's entry points at a small size; every output as numpy arrays
DRIVE = """
import numpy as np, torch
import repro_torch.kernels as tk
from repro_torch import noc, traffic
from repro_torch.codec import compare_streams
from repro_torch.link import LinkSpec, TxPipeline

def drive():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 21, 32)).astype(np.uint8))
    cfg = (tk.CodecVariant('app', 4, False, 'bus_invert', 4),
           tk.CodecVariant('acc', None, True, 'transition'), tk.CodecVariant('none'))
    out = {}
    out['sort'] = tk.psu_sort(x[0], k=4)
    out['stream'] = tuple(tk.psu_stream(x[0], x[1], k=4))
    out['bt'] = tk.bt_count(x[0].reshape(-1, 8))
    out['axes'] = tk.bt_count_axes(x, None, [21, 9], configs=cfg, chunk_packets=5)
    out['act'] = tuple(tk.bt_count_axes(x, None, [21, 9], configs=cfg, activity_windows=6))
    out['links'] = tuple(tk.bt_count_links(x, 5, [21, 3], activity_windows=4))
    out['codecs'] = tuple(tk.bt_count_codecs(x[0], x[1], cfg, activity_windows=3))
    rep = TxPipeline(LinkSpec(key='app', codec='bus_invert4'), device='cpu').measure(x[0], x[1])
    rows = compare_streams([x[0], x[1]], 16, codecs=('none', 'transition'))
    out['tx'] = torch.tensor([rep.input_bt, rep.weight_bt, rep.aux_bt])
    out['rows'] = torch.tensor([[r.data_bt, r.aux_bt] for r in rows])
    w = torch.from_numpy(rng.normal(size=64 * 5 + 3).astype(np.float32))
    out['egress'] = traffic.egress_permutation(traffic.int8_view(w), packet=64, k=4)
    topo = noc.ring(4)
    flows = noc.ring_allreduce_flows(x.reshape(-1)[: 64 * 21].view(torch.int8), topo,
                                     spec=LinkSpec(width_bits=128, flits_per_packet=4,
                                                   input_lanes=16, weight_lanes=0))
    ring = noc.simulate_noc(topo, flows, LinkSpec(width_bits=128, flits_per_packet=4,
                                                  input_lanes=16, weight_lanes=0, key='acc'))
    out['ring'] = torch.tensor([[s.link, s.bt_input, s.bt_weight, s.num_flits]
                                for s in ring.links])
    flat = {}
    for k, v in out.items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            flat[f'{k}{i}'] = t.numpy()
    return flat
"""


def test_outputs_identical_with_obs_absent_imported_or_collecting(tmp_path):
    code = (
        f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}]\n" + DRIVE
        + "out = drive()\n"
        "assert not any(m.startswith('repro_torch.obs') for m in sys.modules)\n"
        f"np.savez({str(tmp_path / 'absent.npz')!r}, **out)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=ROOT)
    absent = dict(np.load(tmp_path / "absent.npz"))
    scope: dict = {}
    exec(DRIVE, scope)
    imported = scope["drive"]()  # repro_torch.obs is imported by this module
    with tobs.collect() as reg, tobs.tracing() as tracer:
        active = scope["drive"]()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]), tobs.profiled():
        profiled = scope["drive"]()
    for name, ref in absent.items():
        assert np.array_equal(imported[name], ref), name
        assert np.array_equal(active[name], ref), name
        assert np.array_equal(profiled[name], ref), name
    # bt_count_axes, its activity mode, bt_count_codecs and one per compared stream
    assert reg.value("kernel.dispatch.calls", entry="bt_count_axes", backend="torch") == 5
    assert tracer.spans("link.tx") and reg.series("codec.stream.bt")
    # raw payloads: JSON-safe scalars only, never a tensor
    rec = _Recorder()
    _obs_hooks.SINK = rec
    try:
        scope["drive"]()
    finally:
        _obs_hooks.SINK = None
    kinds = {k for k, _ in rec.payloads}
    assert {"kernel.dispatch", "link.tx", "link.stage", "link.report", "codec.stream",
            "noc.simulate", "noc.expand", "noc.link", "noc.stage",
            "traffic.stage"} <= kinds <= set(tobs.PROBE_KINDS) | set(tobs.PORT_PROBE_KINDS)
    for kind, data in rec.payloads:
        assert all(_json_scalar(v) for v in data.values()), (kind, data)
    dispatch = [d for k, d in rec.payloads if k == "kernel.dispatch"]
    assert {d["backend"] for d in dispatch} == {"torch"}
    assert all(d["kernel_launches"] == 0 for d in dispatch)
