"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Everything that belongs to a configuration, a traffic mix or a metric is
found by its name in ``BENCHMARK.json``: ``configs/<config>.json`` (the
sizes), ``mixes/<traffic>.json`` (the parameters the generator and the
path read), ``paths/<path>.py`` (the step the mix names, with its plain
reference) and ``metrics/<metric>.py`` (a reader of the run: its
``read(run)`` gives the metric's value, or None where it finds nothing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import re
import statistics
import tempfile
import time
from pathlib import Path
from types import ModuleType

import torch

from . import generate, peaks, trace
from .compare import steps_wrong

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
TOP = 10  # entries of each breakdown list
OP_NAME = 160  # characters of a device operation's name kept in the breakdown


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    path: ModuleType
    end_to_end: dict  # metric name -> (reader module, unit), for --trace 0
    per_layer: dict  # the same, for --trace 1


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _reader(name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_").replace("-", "_"),
        HERE / "metrics" / f"{_checked(name)}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(bench: dict, name: str, config: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json's contents); ``config``
    replaces its configuration's file (the tests' small sizes)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    if config is None:
        files = {c["name"]: c["file"] for c in bench["configs"]}
        with open(HERE.parent / files[w["config"]]) as f:
            config = json.load(f)
    with open(HERE / "mixes" / f"{_checked(w['traffic'])}.json") as f:
        mix = json.load(f)
    path = importlib.import_module(f"portbench.paths.{_checked(mix['path'])}")
    e2e = {m["name"]: (_reader(m["name"]), m["unit"]) for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    per_layer = {m["name"]: (_reader(m["name"]), m["unit"]) for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)}
    return Cell(name, w["chips"], config, mix, path, e2e, per_layer)


@dataclasses.dataclass
class Window:
    answers: list  # (snapshot index, answer) of each step, in order
    step_s: list  # host seconds of each step: its start to its answer on the host
    seconds: float  # first step's start to last step's answer
    launches: dict  # the port's kernel launches in the window
    kept: tuple  # (snapshot index, device outputs) of the last step


def _span(name: str):
    return torch.profiler.record_function(f"pb.{name}")


def _no_span(name: str):
    return contextlib.nullcontext()


def measure(cell: Cell, snaps: list, seconds: float, span) -> Window:
    """Closed loop, one client: step after step on the snapshots in turn
    until ``seconds`` have passed.  Each step's device outputs are dropped
    before the next begins; the last step's stay for the check."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    answers, step_s, kept = [], [], None
    start = time.perf_counter()
    while True:
        s = len(answers) % len(snaps)
        kept = None
        t0 = time.perf_counter()
        answer, outputs = cell.path.step(snaps[s], cell.mix, span)
        t1 = time.perf_counter()
        answers.append((s, answer))
        step_s.append(t1 - t0)
        kept = (s, outputs)
        del outputs
        if t1 - start >= seconds:
            return Window(answers, step_s, t1 - start, kernels.launch_counts(), kept)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    setup_s: float  # host clock, process start to the first timed step
    steps: int
    window_s: float  # host clock, first step's start to last step's answer
    step_s: list  # host clock, each step
    wire_bytes: int  # int8 wire bytes a step measures
    peak_bytes: int  # the allocator's peak over set-up and window
    layers: dict  # the path's LAYERS: layer -> the ranges its calls run in
    work: dict  # layer -> (bytes, integer operations) a step
    launches: dict  # the port's own launch counters over the window
    trace: trace.Trace | None  # the traced window (--trace 1 only)

    def least_s(self, layer: str) -> float | None:
        """The least time of one step's work in ``layer``, or None if this
        cell's path has no such layer."""
        return peaks.least_s(*self.work[layer]) if layer in self.work else None

    def device_s(self, layer: str) -> float:
        """Device seconds of the operations in ``layer``'s ranges."""
        return sum(self.trace.range_s.get(f"pb.{r}", 0.0) for r in self.layers.get(layer, ()))

    def roofline_pct(self, layer: str) -> float | None:
        """``layer``'s least time over its device time, in %; None where
        this cell has no such layer or the trace shows none of its work."""
        least, dev = self.least_s(layer), self.device_s(layer)
        return None if least is None or dev <= 0 else 100 * least * self.steps / dev


def _traced(cell: Cell, snaps: list, seconds: float,
            device: torch.device) -> tuple[Window, trace.Trace]:
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        with _span("window"):
            win = measure(cell, snaps, seconds, _span)
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return win, trace.read(path)
    finally:
        os.unlink(path)


def _top(d: dict) -> list:
    return sorted(([k[:OP_NAME], v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             started: float) -> tuple[dict, dict]:
    """One run: the result line (each compared number beside its limit
    last) and notes on the window (steps, seconds, median step), the
    reference's seconds and set-up's parts.  ``started`` is the host clock
    at process start."""
    cuda = device.type == "cuda"
    t_inputs = time.perf_counter()
    snaps = generate.snapshots(cell.config, cell.mix, seed, device)
    m = generate.gradient_elements(cell.config)
    t_warm = time.perf_counter()
    cell.path.step(snaps[0], cell.mix, _no_span)  # the warm-up: every shape the window uses
    if cuda:
        torch.cuda.synchronize(device)
    t_first = time.perf_counter()
    setup_s = t_first - started
    if traced:
        win, tr = _traced(cell, snaps, seconds, device)
    else:
        win, tr = measure(cell, snaps, seconds, _no_span), None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    steps = len(win.answers)
    run = Run(setup_s, steps, win.seconds, win.step_s, m, peak, cell.path.LAYERS,
              cell.path.work(m, cell.mix), win.launches, tr)
    metrics = {}
    for name, (reader, unit) in (cell.per_layer if traced else cell.end_to_end).items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    # the reference runs once the peak is read and only the last step's
    # outputs are left of the program's
    kept, win.kept = win.kept, None
    check_start = time.perf_counter()
    want, checks = {}, {}
    for i, snap in enumerate(snaps):
        want[i], counts = cell.path.reference(snap, cell.mix, kept[1] if i == kept[0] else None)
        checks.update(counts)
    del kept
    checks = {"steps_wrong": steps_wrong(win.answers, want), **checks}
    result = {
        "correct": all(v == 0 for v in checks.values()),
        "attempted": steps,
        "failed": checks["steps_wrong"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if traced:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": _top(tr.ops_s), "idle_gaps": _top(tr.idle_s)}
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return result, {"steps": steps, "seconds": win.seconds,
                    "step_ms_median": 1e3 * statistics.median(win.step_s),
                    "check_s": time.perf_counter() - check_start,
                    "setup_split_s": {"start": t_inputs - started, "inputs": t_warm - t_inputs,
                                      "warm_up": t_first - t_warm}}
