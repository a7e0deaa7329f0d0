"""repro_torch.dse against repro.dse on the CPU.

Design points, grids, the area/timing joins, every ``Evaluation`` field
(BT, aux BT, per-wire BT, reductions, energy, NoC reduction and latency),
the Pareto fronts, knees and the JSON/CSV artifacts must be equal — floats
exactly, since both packages compute them from the same integers through
the same expressions.  The last tests hold both packages to the DSE pins of
``chip_smoke.py`` phase 3e (benchmarks/dse_sweep.py's defaults, Fig. 5's k
sweep and Fig. 7's sorting-unit overhead row).
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dse as rd
import repro_torch.dse as td
from benchmarks.datagen import conv_streams
from chip_smoke import DSE_SWEEP, dse_axis_points, dse_grid, evals_digest
from repro import obs as robs
from repro.noc import NocLatencyModel as RLat
from repro_torch import obs as tobs
from repro_torch.convert import design_point_from_reference
from repro_torch.noc import NocLatencyModel as TLat
from torch_groups import torch_threads  # noqa: F401


def _workloads(streams, lanes=16, name="w"):
    return (rd.Workload(name, tuple(jnp.asarray(s) for s in streams), lanes=lanes),
            td.Workload(name, tuple(torch.from_numpy(s) for s in streams), lanes=lanes))


def _rand(p, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (p, n), dtype=np.uint8)


def _port_points(points):
    return tuple(design_point_from_reference(dataclasses.asdict(p)) for p in points)


def _assert_evals_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
        for prop in ("label", "hot_wire", "hot_wire_bt", "wire_bt_mean", "hot_wire_ratio",
                     "area_um2", "gross_bt", "bt_per_flit", "latency_ns", "total_latency_ns"):
            assert getattr(g, prop) == getattr(r, prop), prop


# ------------------------------------------------------------ the design space


def test_design_points_and_grids_match_reference():
    grids = [
        {},
        {"families": ("psu", "bitonic", "csn"), "ns": (25, 49), "widths": (4, 8),
         "ks": (1, 2, 4, 5, 9), "orderings": ("none", "column_major", "acc", "app"),
         "descendings": (False, True), "codecs": (None, "bus_invert4", "gray"),
         "topologies": (None, "mesh3x3", "ring5")},
    ]
    for kw in grids:
        ref, got = rd.expand_grid(**kw), td.expand_grid(**kw)
        assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in ref]
        assert _port_points(ref) == got
        for r, g in zip(ref, got):
            assert (g.label, tuple(g.variant), tuple(g.codec_variant)) == (
                r.label, tuple(r.variant), tuple(r.codec_variant))
            assert dataclasses.astuple(g.area()) == dataclasses.astuple(r.area())
            assert dataclasses.astuple(g.timing()) == dataclasses.astuple(r.timing())
            assert g.noc_hops() == r.noc_hops()
            assert td.area_reduction(g) == rd.area_reduction(r)
    for kw in ({}, {"n": 49, "width": 4, "ks": (1, 3, 5), "include_baseline": False,
                    "topology": "torus2x3"}):
        assert [dataclasses.asdict(p) for p in td.k_sweep(**kw)] == [
            dataclasses.asdict(p) for p in rd.k_sweep(**kw)]
    for name in ("mesh4x4", "torus2x3", "ring8", "mesh1x5"):
        assert dataclasses.astuple(td.parse_topology(name)) == dataclasses.astuple(
            rd.parse_topology(name))
        assert td.topology_route_hops(name) == rd.topology_route_hops(name)
    assert (td.FAMILIES, td.ORDERINGS) == (rd.FAMILIES, rd.ORDERINGS)


@pytest.mark.parametrize("kw", [
    {"family": "tree"}, {"ordering": "bogus"}, {"n": 0}, {"ordering": "app", "k": 10},
    {"family": "csn", "ordering": "app"}, {"ordering": "acc", "k": 4},
    {"family": "bitonic", "ordering": "none", "k": None},
    {"ordering": "none", "k": None, "descending": True}, {"codec": "morse"},
    {"topology": "hypercube4"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_design_point_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref:
        rd.DesignPoint(**kw)
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        td.DesignPoint(**kw)


def test_paper_rows_fig5_k_sweep_and_fig7_overhead():
    """fig5_area.py's k_sweep rows and fig7_power.py's sorting-unit overhead
    row, through both packages, equal the pins (35.4 % area at APP k=4)."""
    for mod in (rd, td):
        rows = {f"k{pt.k}": f"total={pt.area().total:.0f}um2" for pt in mod.k_sweep(
            n=25, width=8, ks=(2, 4, 8), include_baseline=False, include_precise=False)}
        assert rows == DSE_SWEEP["fig5_k_sweep"]
        red = mod.area_reduction(mod.DesignPoint(n=25, width=8, k=4, ordering="app"))
        row = f"app/acc area ratio={1 - red:.3f} -> overhead reduction={100 * red:.1f}%"
        assert row == DSE_SWEEP["fig7_psu_power_overhead"]
    assert td.area_reduction(td.DesignPoint()) == rd.area_reduction(rd.DesignPoint())


# ------------------------------------------------------------ evaluation


@pytest.fixture(scope="module")
def conv2():
    return conv_streams(n_images=2)


def test_evaluate_grid_matches_reference(conv2):
    rw, tw = _workloads(conv2, name="conv")
    ref = rd.evaluate_grid(dse_grid((2, 4, 8), (25, 49), rd), rw)
    got = td.evaluate_grid(dse_grid((2, 4, 8), (25, 49)), tw)
    _assert_evals_equal(got, ref)
    # a custom power model and chunked measurement change nothing but the model
    from repro.link import LinkPowerModel as RPow
    from repro_torch.link import LinkPowerModel as TPow

    kw = {"transfer_factor": 0.8, "energy_per_transition_pj": 0.3}
    pts = rd.k_sweep(n=25)
    _assert_evals_equal(
        td.evaluate_grid(_port_points(pts), tw, power=TPow(**kw), chunk_packets=97),
        rd.evaluate_grid(pts, rw, power=RPow(**kw)))


@pytest.mark.parametrize("windows", [None, 7])
def test_multi_axis_grid_matches_reference(conv2, windows):
    """Streams x NoC route rows x (ordering, codec) configs in one call per
    key width: codecs, a descending point, two topologies, two widths."""
    rw, tw = _workloads(conv2, name="conv")
    pts = dse_axis_points(25, (2, 4), rd) + (
        rd.DesignPoint(ordering="acc", k=None, descending=True, codec="transition"),
        rd.DesignPoint(ordering="column_major", k=None, codec="bus_invert"),
        rd.DesignPoint(ordering="app", k=3, width=4, topology="ring5"),
        rd.DesignPoint(ordering="none", k=None, width=4, codec="gray", topology="torus3x3"),
    )
    lat = {"clock_ghz": 1.0, "router_cycles": 2}
    ref = rd.evaluate_grid(pts, rw, activity_windows=windows, latency=RLat(**lat))
    got = td.evaluate_grid(_port_points(pts), tw, activity_windows=windows, latency=TLat(**lat))
    _assert_evals_equal(got, ref)
    assert any(e.noc_latency_ns for e in got) and any(e.aux_bt for e in got)


def test_noc_points_and_latency_plane_match_reference():
    streams = (_rand(96, 64, 11),)
    rw, tw = _workloads(streams, name="rand")
    pts = (rd.DesignPoint(ordering="acc", k=None, topology="mesh3x3"),
           rd.DesignPoint(ordering="acc", k=None),
           rd.DesignPoint(ordering="app", k=4),
           rd.DesignPoint(ordering="app", k=4, topology="mesh3x3"))
    ref, got = rd.evaluate_grid(pts, rw), td.evaluate_grid(_port_points(pts), tw)
    _assert_evals_equal(got, ref)
    assert got[0].noc_active_links == 4 and got[3].noc_latency_ns == 798.0
    for objs in ("DEFAULT_OBJECTIVES", "AREA_BT_OBJECTIVES", "AREA_BT_LATENCY_OBJECTIVES"):
        ro, to = getattr(rd, objs), getattr(td, objs)
        assert [o.name for o in to] == [o.name for o in ro]
        rf, tf = rd.pareto_front(ref, ro), td.pareto_front(got, to)
        assert [e.label for e in tf] == [e.label for e in rf]
        assert td.knee_point(tf, to).label == rd.knee_point(rf, ro).label
        for a, b in zip(range(len(got)), range(len(got))):
            for c in range(len(got)):
                assert td.dominates(got[a], got[c], to) == rd.dominates(ref[b], ref[c], ro)
    with pytest.raises(ValueError, match="empty front"):
        td.knee_point(())


def test_report_artifacts_are_byte_equal(tmp_path, conv2):
    rw, tw = _workloads(conv2, name="conv")
    pts = dse_grid((2, 4), (25,), rd) + (
        rd.DesignPoint(ordering="acc", k=None, codec="bus_invert4", topology="mesh3x3"),)
    ref = rd.evaluate_grid(pts, rw, activity_windows=16)
    got = td.evaluate_grid(_port_points(pts), tw, activity_windows=16)
    rfront, tfront = rd.pareto_front(ref), td.pareto_front(got)
    meta = {"conv_images": 2}
    rdoc = rd.write_json(str(tmp_path / "r" / "front.json"), ref, front=rfront,
                         knee=rd.knee_point(rfront), workload="conv", meta=meta)
    tdoc = td.write_json(str(tmp_path / "t" / "front.json"), got, front=tfront,
                         knee=td.knee_point(tfront), workload="conv", meta=meta)
    assert tdoc == rdoc
    rd.write_csv(str(tmp_path / "r" / "grid.csv"), ref, front=rfront)
    td.write_csv(str(tmp_path / "t" / "grid.csv"), got, front=tfront)
    for name in ("front.json", "grid.csv"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "r" / name).read_bytes()
    assert td.to_records(got, tfront) == rd.to_records(ref, rfront)
    assert td.point_record(got[0], on_front=True) == rd.point_record(ref[0], on_front=True)


def test_dse_probes_match_reference(conv2):
    rw, tw = _workloads(conv2, name="conv")
    pts = dse_axis_points(25, (2, 4), rd)
    with robs.collect() as rreg:
        rd.evaluate_grid(pts, rw)
    with tobs.collect() as treg:
        td.evaluate_grid(_port_points(pts), tw)

    def counters(reg):
        return sorted((c["name"], tuple(sorted(c["labels"].items())), c["value"])
                      for c in reg.to_dict()["counters"] if c["name"].startswith("dse."))

    assert counters(treg) == counters(rreg) != []


def test_workload_validation_and_empty_grid():
    tw = td.Workload("w", (torch.zeros((4, 64), dtype=torch.uint8),), lanes=16)
    assert td.evaluate_grid((), tw) == () and td.grid_launch_count((), tw) == 0
    assert (tw.elems_per_packet, tw.num_flits) == (64, 16)
    bad = [
        (td.Workload("w", ()), rd.Workload("w", ())),
        _workloads((_rand(4, 64, 0), _rand(4, 32, 1))),
        _workloads((_rand(4, 24, 0),)),
    ]
    for t, r in bad:
        with pytest.raises(ValueError) as ref:
            rd.evaluate_grid(rd.k_sweep(), r)
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            td.evaluate_grid(td.k_sweep(), t)


def test_grid_launch_count_on_the_cpu_is_zero(conv2):
    """The port counts CUDA launches of the one measurement; on CPU
    tensors the plain version runs and nothing is launched (the reference
    counts one pallas_call for one key width)."""
    rw, tw = _workloads(conv2, name="conv")
    pts = dse_axis_points(25, (2, 4), rd)
    assert rd.grid_launch_count(pts, rw) == 1
    assert td.grid_launch_count(_port_points(pts), tw) == 0


# ------------------------------------------------------------ chip_smoke pins


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_dse_sweep_pins(pkg):
    """benchmarks/dse_sweep.py's defaults (8 conv images, k in {2, 4, 8},
    N in {25, 49}) equal the pins: every point's BT and derived floats, the
    front, the area x BT knee (APP k=4 at N=25), the mesh4x4 point and the
    multi-axis grid, also wire-resolved."""
    ds = DSE_SWEEP
    mod = td if pkg == "port" else rd
    streams = conv_streams(n_images=ds["conv_images"])
    rw, tw = _workloads(streams, name="conv")
    w = tw if pkg == "port" else rw
    evals = mod.evaluate_grid(dse_grid(ds["ks"], ds["ns"], mod), w)
    assert {e.label: [e.total_bt, e.aux_bt] for e in evals} == ds["bt"]
    assert evals_digest(evals) == ds["evals_sha256"]
    assert [e.label for e in mod.pareto_front(evals)] == ds["front"]
    plane = [e for e in evals if e.point.n == ds["ns"][0]]
    knee = mod.knee_point(mod.pareto_front(plane, mod.AREA_BT_OBJECTIVES),
                          mod.AREA_BT_OBJECTIVES)
    assert knee.label == ds["knee"] == "app-k4@N25"
    noc_w = mod.Workload("conv", w.streams[:1], lanes=16)
    ne = mod.evaluate_grid((mod.DesignPoint(ordering="app", k=4, topology="mesh4x4"),), noc_w)
    assert evals_digest(ne) == ds["noc_point_sha256"]
    axis = dse_axis_points(ds["ns"][0], ds["ks"], mod)
    assert evals_digest(mod.evaluate_grid(axis, w)) == ds["axis_sha256"]
    assert evals_digest(mod.evaluate_grid(axis, w, activity_windows=ds["window"])) == \
        ds["axis_activity_sha256"]
