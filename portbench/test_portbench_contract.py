"""``BENCHMARK.json`` against the rules its check applies, the harness's
imports, the trace reduction on a hand-made trace, and a run that finds
no card."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import trace

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_reference_imports_torch_alone():
    for path in (HERE / "reference").rglob("*.py"):
        assert _imports(path) <= {"torch", "__future__"}, path


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    named = BENCH["configs"] + BENCH["workloads"] + metrics
    for entry in named:
        assert NAME.fullmatch(entry["name"]), entry["name"]
    for kind in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({e["name"] for e in kind}) == len(kind)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in BENCH["workloads"]:
        assert NAME.fullmatch(e["config"]) and NAME.fullmatch(e["traffic"]) and e["chips"] == 1
    for text in ([e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert LINE.fullmatch(text), text
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}

    def reported(m):
        return set(m.get("workloads", cells))

    e2e = {m["name"]: reported(m) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        assert set(m["workloads"]) <= e2e[m["moves"]] <= cells, m
    for cell in cells:
        has = {name for name, where in e2e.items() if cell in where}
        assert "setup_s" in has and len(has) >= 2, cell
        assert any(cell in m["workloads"] for m in BENCH["per_layer"]), cell


def test_files_the_harness_finds_by_name():
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
        assert (HERE / "paths" / f"{mix['path']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert "def read(run)" in (HERE / "metrics" / f"{m['name']}.py").read_text()


def test_trace_reduction(tmp_path):
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", "pb.window", 0, 100),
        x("user_annotation", "pb.a", 1, 20), x("gpu_user_annotation", "pb.a", 10, 30),
        x("kernel", "k1", 10, 10), x("kernel", "k2", 25, 15),
        x("user_annotation", "pb.b", 45, 40), x("gpu_user_annotation", "pb.b", 50, 45),
        x("gpu_memcpy", "copy", 50, 5), x("kernel", "k1", 60, 35),
        x("kernel", "late", 99, 10),  # runs past the window: counted up to its end
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = trace.read(str(path))
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((10 + 15 + 5 + 35 + 1) * 1e-6)
    assert tr.range_s == pytest.approx({"pb.a": 25e-6, "pb.b": 40e-6})
    assert tr.ops_s == pytest.approx({"k1": 45e-6, "k2": 15e-6, "copy": 5e-6, "late": 10e-6})
    # idle: [0, 10) before any range, [20, 25) in pb.a, [40, 50) between
    # pb.a and pb.b, [55, 60) in pb.b, [95, 99) after pb.b
    assert tr.idle_s == pytest.approx({"between ranges": 24e-6, "pb.a": 5e-6, "pb.b": 5e-6})


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", BENCH["workloads"][0]["name"],
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr)
    assert "no result" in p.stderr
