"""The port's own probe spans in traced windows of one cell: device and
idle time by program stage, and what putting the spans in the trace costs.

    python3 portbench/stages.py --workload <name> --seed <n> --seconds <s> [--rounds <r>]

From the root of a checkout, with a CUDA card.  The cell's inputs and
warm-up are the benchmark's (``harness``).  Then ``rounds`` pairs of
traced windows of ``--seconds`` each run in turn, one without and one with
``repro_torch.obs.profiled()``, which makes every probe span of the port a
``repro_torch.<area>.<what>`` range of the profiler's trace.  Each window
is closed-loop, as the benchmark's.  The last line of standard output is
one JSON object:

- ``step_ms``: per mode ("traced", "profiled"), the median and 95th
  percentile of the host step times over the mode's windows; their
  difference is the bridge's own cost;
- ``roofline_pct`` and ``device_idle_pct``: per mode, the benchmark's
  ``<layer>_roofline`` shares and idle share, the ``pb.*`` ranges read as
  ``trace.read`` reads them (program ranges left out), so the two modes
  give the same readings where the bridge moves nothing;
- ``idle_ms``: per mode, idle ms a step by the innermost range the host
  was in, a program range where one was open;
- ``ops_ms``: from the profiled windows, the device operations that took
  the most device ms a step;
- ``prog_ms`` / ``prog_idle_ms`` / ``prog_calls``: from the profiled
  windows, device ms a step launched inside each program range, idle ms a
  step of the gaps that began inside it (both inclusive: an operation or
  gap counts for every program range open), and host calls a step;
- ``readings``: the per-layer quantities these spans give
  (:func:`readings`), where the cell runs the range.

Without a CUDA card it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import generate, harness, peaks, trace  # noqa: E402

PROGRAM = "repro_torch."
MODES = ("traced", "profiled")


class Stages(NamedTuple):
    window_s: float  # the window's length on the trace's clock
    busy_s: float  # time in which a device operation ran, inside the window
    range_s: dict  # pb.* range -> device seconds, as trace.read attributes them
    ops_s: dict  # device operation name -> seconds
    idle_s: dict  # innermost range the host was in (or trace.OUTSIDE) -> idle seconds
    prog_s: dict  # program range -> device seconds of operations launched inside it
    prog_idle_s: dict  # program range -> idle seconds of gaps that began inside it
    prog_calls: dict  # program range -> host calls


class _Open:
    """The names of the spans holding t, for t that never decrease."""

    def __init__(self, spans: list):
        self.spans, self.next, self.open = spans, 0, []

    def at(self, t: float) -> set:
        while self.next < len(self.spans) and self.spans[self.next][0] <= t:
            self.open.append(self.spans[self.next])
            self.next += 1
        self.open = [s for s in self.open if s[1] >= t]
        return {s[2] for s in self.open}


def _add(d: dict, names, seconds: float) -> None:
    for name in names:
        d[name] = d.get(name, 0.0) + seconds


def read(path: str) -> Stages:
    """``trace.read``'s reduction of a trace that may hold program ranges,
    plus the program's own attribution.  A device operation belongs to the
    innermost ``pb.*`` range, and to every program range, open on the host
    when it was launched (its ``correlation`` id and the runtime call that
    carries it).  Only where the trace lacks the correlation does it go by
    the device-side spans that hold its midpoint, as ``trace.read`` goes:
    the profiler writes a device-side span for the innermost range alone,
    so a ``pb.*`` range with program ranges inside has none."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = trace._spans(events, "user_annotation")
    windows = [s for s in host if s[2] == trace.WINDOW]
    if not windows:
        raise RuntimeError(f"no {trace.WINDOW} range in the trace")
    w0, w1, _ = windows[0]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"],
                  e.get("args", {}).get("correlation"))
                 for e in events if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_OPS
                 and float(e["ts"]) + float(e.get("dur", 0)) > w0 and float(e["ts"]) < w1)
    # the host time of the CUDA API call that launched each operation
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat", "").startswith("cuda_")
                and "correlation" in e.get("args", {})}
    ops_s: dict = {}
    for a, b, name, _ in ops:
        ops_s[name] = ops_s.get(name, 0.0) + (b - a) / 1e6
    prog = [s for s in host if s[2].startswith(PROGRAM)]
    range_s: dict = {}
    prog_s: dict = {}

    def attribute(placed: list, spans: list) -> None:
        """Each (time, seconds) of ``placed`` to the innermost ``pb.*`` range
        and every program range of ``spans`` that holds its time."""
        pb = trace._Innermost([s for s in spans if s[2].startswith("pb.") and s[2] != trace.WINDOW])
        inside = _Open([s for s in spans if s[2].startswith(PROGRAM)])
        for t, seconds in sorted(placed):
            where = pb.at(t)
            if where is not None:
                range_s[where] = range_s.get(where, 0.0) + seconds
            _add(prog_s, inside.at(t), seconds)

    attribute([(launched[c], (b - a) / 1e6) for a, b, _, c in ops if c in launched], host)
    attribute([((a + b) / 2, (b - a) / 1e6) for a, b, _, c in ops if c not in launched],
              trace._spans(events, "gpu_user_annotation"))
    in_range = trace._Innermost([s for s in host if s[2] != trace.WINDOW])
    in_prog = _Open(prog)
    busy, idle, prog_idle, end = 0.0, {}, {}, w0
    for a, b, _, _ in ops + [(w1, w1, "", None)]:
        a, b = max(a, w0), min(b, w1)
        if a > end:
            gap = (a - end) / 1e6
            _add(idle, [in_range.at(end) or trace.OUTSIDE], gap)
            _add(prog_idle, in_prog.at(end), gap)
        if b > end:
            busy += (b - max(a, end)) / 1e6
            end = b
    calls = Counter(s[2] for s in prog if w0 <= s[0] <= w1)
    return Stages((w1 - w0) / 1e6, busy, range_s, ops_s, idle, prog_s, prog_idle, dict(calls))


# per-layer quantities the program's spans give: device ms a step in a range
DEVICE_MS = {
    "int8_view_ms": "repro_torch.traffic.int8_view",
    "egress_base_ms": "repro_torch.traffic.egress_base",
    "noc_gather_ms": "repro_torch.noc.gather",
}


def readings(st: Stages, steps: int, work: dict) -> dict:
    """The per-layer quantities of one profiled window: :data:`DEVICE_MS`;
    ``noc_measure_roofline``, the NoC layer's counted work at the H100's
    peaks over the device time in ``repro_torch.kernel.bt_count_links``;
    ``noc_host_gap_ms``, idle ms a step that began inside
    ``repro_torch.noc.simulate``.  A quantity whose range the window did
    not run, or a window with no device operation, gives none."""
    if st.busy_s <= 0:
        return {}
    out = {name: 1e3 * st.prog_s[rng] / steps for name, rng in DEVICE_MS.items()
           if st.prog_s.get(rng, 0.0) > 0}
    measured = st.prog_s.get("repro_torch.kernel.bt_count_links", 0.0)
    if measured > 0 and "noc_fabric" in work:
        out["noc_measure_roofline"] = 100 * peaks.least_s(*work["noc_fabric"]) * steps / measured
    if st.prog_calls.get("repro_torch.noc.simulate"):
        out["noc_host_gap_ms"] = 1e3 * st.prog_idle_s.get("repro_torch.noc.simulate", 0.0) / steps
    return out


def window(cell, snaps, seconds: float, device, profiled: bool):
    """One traced window as the harness traces one, with the port's probe
    spans in the trace or not; (the window, its reduction)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with obs.profiled() if profiled else contextlib.nullcontext():
                win = harness.measure(cell, snaps, seconds, harness._span)
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return win, read(path)
    finally:
        os.unlink(path)


def per_step(d: dict, steps: int) -> dict:
    return {k: 1e3 * v / steps for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def _plus(a: Stages | None, b: Stages) -> Stages:
    """Two windows' reductions as one: times and counts added."""
    if a is None:
        return b
    return Stages(*(x + y if isinstance(x, float) else
                    {k: x.get(k, 0) + y.get(k, 0) for k in x.keys() | y.keys()}
                    for x, y in zip(a, b)))


def measure(cell, seed: int, seconds: float, rounds: int, device) -> dict:
    """``rounds`` pairs of windows, the mode that goes first taking turns."""
    snaps = generate.snapshots(cell.config, cell.mix, seed, device)
    m = generate.gradient_elements(cell.config)
    work = cell.path.work(m, cell.mix)
    cell.path.step(snaps[0], cell.mix, harness._no_span)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_s = {mode: [] for mode in MODES}
    total = dict.fromkeys(MODES)
    for r in range(rounds):
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            win, st = window(cell, snaps, seconds, device, mode == "profiled")
            step_s[mode] += win.step_s
            total[mode] = _plus(total[mode], st)
    out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "steps": {mode: len(step_s[mode]) for mode in MODES}, "step_ms": {},
           "roofline_pct": {}, "device_idle_pct": {}, "idle_ms": {}}
    for mode in MODES:
        st, steps, ms = total[mode], len(step_s[mode]), [1e3 * s for s in step_s[mode]]
        out["step_ms"][mode] = {
            "median": statistics.median(ms),
            "p95": statistics.quantiles(ms, n=20, method="inclusive")[-1] if len(ms) > 1 else ms[0]}
        run = harness.Run(0.0, steps, st.window_s, step_s[mode], m, 0, cell.path.LAYERS, work,
                          {}, st)
        out["roofline_pct"][mode] = {layer: run.roofline_pct(layer) for layer in work}
        out["device_idle_pct"][mode] = (100 * (1 - st.busy_s / st.window_s)
                                        if st.busy_s > 0 else None)
        out["idle_ms"][mode] = per_step(st.idle_s, steps)
    st, steps = total["profiled"], len(step_s["profiled"])
    out["ops_ms"] = dict(list(per_step(st.ops_s, steps).items())[:harness.TOP])
    out["prog_ms"] = per_step(st.prog_s, steps)
    out["prog_idle_ms"] = per_step(st.prog_idle_s, steps)
    out["prog_calls"] = {k: v / steps for k, v in sorted(st.prog_calls.items())}
    out["readings"] = readings(st, steps, work)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        cell = harness.load_cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print(f"stages: {args.workload} needs a CUDA card; no result", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = measure(cell, args.seed, args.seconds, args.rounds, torch.device("cuda", 0))
    print(f"stages: {args.workload} seed {args.seed}: {time.perf_counter() - t0:.1f} s; "
          f"step_ms {out['step_ms']}; readings {out['readings']}", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
