"""``stages.py``: the reduction of a trace that holds the port's own
ranges, on a hand-made trace, and its windows on the CPU at a small size."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import stages, trace
from portbench.test_portbench_cells import CELLS, small_cell

ROOT = Path(__file__).resolve().parents[1]


def x(cat, name, ts, dur, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


# test_trace_reduction's trace; below, its kernels' launches and program
# ranges nested inside the pb.* ranges
PB = [
    x("user_annotation", "pb.window", 0, 100),
    x("user_annotation", "pb.a", 1, 20), x("gpu_user_annotation", "pb.a", 10, 30),
    x("kernel", "k1", 10, 10, 1), x("kernel", "k2", 25, 15, 2),
    x("user_annotation", "pb.b", 45, 40), x("gpu_user_annotation", "pb.b", 50, 45),
    x("gpu_memcpy", "copy", 50, 5, 3),
    x("kernel", "k1", 60, 35),  # no correlation: placed by its device-side range
    x("kernel", "late", 99, 10, 4),  # launched outside every program range
]
# the profiler writes a device-side span for the innermost range alone:
# pb.a and egress_permutation, which hold other ranges, have none
PROGRAM = [
    x("user_annotation", "repro_torch.traffic.egress_permutation", 2, 18),
    x("user_annotation", "repro_torch.kernel.psu_sort", 3, 5),
    x("gpu_user_annotation", "repro_torch.kernel.psu_sort", 10, 10),
    x("user_annotation", "repro_torch.traffic.egress_base", 12, 8),
    x("gpu_user_annotation", "repro_torch.traffic.egress_base", 25, 15),
    x("user_annotation", "repro_torch.noc.simulate", 46, 34),
    x("gpu_user_annotation", "repro_torch.noc.simulate", 60, 35),
    x("user_annotation", "repro_torch.noc.gather", 47, 2),
    x("gpu_user_annotation", "repro_torch.noc.gather", 50, 5),
    x("cuda_runtime", "cudaLaunchKernel", 4, 1, 1),
    x("cuda_runtime", "cudaLaunchKernel", 13, 1, 2),
    x("cuda_runtime", "cudaMemcpyAsync", 48, 1, 3),
    x("cuda_runtime", "cudaLaunchKernel", 90, 1, 4),
]


FULL = [e for e in PB if (e["cat"], e["name"]) != ("gpu_user_annotation", "pb.a")] + PROGRAM


def _write(tmp_path, name, events):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_program_ranges_leave_the_pb_reading_as_it_was(tmp_path):
    bare = trace.read(_write(tmp_path, "bare.json", PB))
    st = stages.read(_write(tmp_path, "full.json", FULL))
    assert st.window_s == bare.window_s
    assert st.busy_s == pytest.approx(bare.busy_s)
    assert st.range_s == pytest.approx(bare.range_s) == {"pb.a": 25e-6, "pb.b": 40e-6}
    assert st.ops_s == pytest.approx(bare.ops_s)
    # inclusive: an operation counts for every program range open at its launch
    assert st.prog_s == pytest.approx({
        "repro_torch.traffic.egress_permutation": 25e-6, "repro_torch.kernel.psu_sort": 10e-6,
        "repro_torch.traffic.egress_base": 15e-6, "repro_torch.noc.gather": 5e-6,
        "repro_torch.noc.simulate": 40e-6})
    # idle: [20, 25) began in egress_base inside egress_permutation, [55, 60)
    # in noc.simulate; the breakdown names the innermost range, a program one
    assert st.prog_idle_s == pytest.approx({
        "repro_torch.traffic.egress_permutation": 5e-6, "repro_torch.traffic.egress_base": 5e-6,
        "repro_torch.noc.simulate": 5e-6})
    assert st.idle_s == pytest.approx({trace.OUTSIDE: 24e-6,
                                       "repro_torch.traffic.egress_base": 5e-6,
                                       "repro_torch.noc.simulate": 5e-6})
    assert sum(st.idle_s.values()) == pytest.approx(sum(bare.idle_s.values()))
    assert set(st.prog_calls.values()) == {1} and len(st.prog_calls) == 5
    # without the program's ranges the two reductions are one
    same = stages.read(_write(tmp_path, "pb.json", PB))
    assert same.idle_s == pytest.approx(bare.idle_s)
    assert same.prog_s == same.prog_idle_s == same.prog_calls == {}


def test_readings_of_a_window(tmp_path):
    st = stages.read(_write(tmp_path, "full.json", FULL))
    work = {"noc_fabric": (3.35e12 * 1e-6, 0)}  # a least time of 1 us
    got = stages.readings(st, 1, work)
    assert got == pytest.approx({"egress_base_ms": 15e-3, "noc_gather_ms": 5e-3,
                                 "noc_host_gap_ms": 5e-3})
    st = st._replace(prog_s={**st.prog_s, "repro_torch.kernel.bt_count_links": 4e-6})
    assert stages.readings(st, 2, work)["noc_measure_roofline"] == pytest.approx(50.0)
    assert stages.readings(st._replace(busy_s=0.0), 1, work) == {}


@pytest.mark.parametrize("name", CELLS)
def test_windows_on_the_cpu(name):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = stages.measure(small_cell(name), 2**31 + 17, 0.05, 2, torch.device("cpu"))
    finally:
        torch.set_num_threads(saved)
    assert out["device"] == "cpu" and min(out["steps"].values()) >= 2
    assert set(out["step_ms"]) == set(stages.MODES)
    assert out["readings"] == {} and out["device_idle_pct"] == {"traced": None, "profiled": None}
    calls = out["prog_calls"]
    assert calls["repro_torch.kernel.quantize_egress"] == 1
    if name.endswith("ring_allreduce"):
        for rng in ("noc.simulate", "noc.plan", "noc.batch", "noc.expand", "noc.queue",
                    "noc.assemble", "noc.readback", "noc.links", "kernel.bt_count_links"):
            assert calls[f"repro_torch.{rng}"] == 3, rng  # one fabric a key
        for rng in ("noc.source_order", "noc.gather", "kernel.psu_sort"):
            assert calls[f"repro_torch.{rng}"] == 2, rng  # ACC and APP sort at the source
    else:
        for rng in ("traffic.int8_view", "traffic.egress_permutation", "traffic.egress_base",
                    "kernel.psu_sort"):
            assert calls[f"repro_torch.{rng}"] == 1, rng
        assert calls["repro_torch.kernel.bt_count"] >= 2


def test_stages_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "stages.py"),
                        "--workload", CELLS[0], "--seed", "5", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr)
    assert "no result" in p.stderr
