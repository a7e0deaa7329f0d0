"""Where the wall time of a pytest run goes, file by file.

As a pytest plugin it writes a line when a test starts and one when it
ends (the xdist worker, ``start`` or ``end``, the wall-clock time, the
test's node id) to the file named by ``SUITE_BUDGET_OUT``; every xdist
worker appends to it::

    SUITE_BUDGET_OUT=/tmp/budget.tsv PYTHONPATH=src:experiments \\
        python -m pytest -p xdist -n 6 --dist loadfile -p suite_budget ...

Run as a script on that file, it prints a markdown table: each test file's
worker, its number of tests, when its first test started (seconds after
the run's first) and the seconds from its first test's start to its last
test's end; then the run's first-start-to-last-end span and each worker's
last end.  With two files it prints both runs' columns side by side
(before and after a change)::

    python experiments/suite_budget.py /tmp/before.tsv [/tmp/after.tsv]
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

_OUT = os.environ.get("SUITE_BUDGET_OUT")


def _log(kind: str, nodeid: str) -> None:
    if _OUT:
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        with open(_OUT, "a") as f:
            f.write(f"{worker}\t{kind}\t{time.time():.3f}\t{nodeid}\n")


def pytest_runtest_logstart(nodeid, location):
    _log("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _log("end", nodeid)


def read(path: str) -> dict:
    """file -> {"worker", "tests", "first", "last"} from a log."""
    lines = [line.rstrip("\n").split("\t") for line in open(path)]
    # under xdist the controller ("main") sees every test too: keep the workers'
    xdist = any(w != "main" for w, *_ in lines)
    rows = defaultdict(lambda: {"tests": 0, "first": None, "last": None, "worker": set()})
    for worker, kind, t, nodeid in lines:
        if xdist and worker == "main":
            continue
        t = float(t)
        name = nodeid.split("::")[0]
        row = rows[name]
        row["worker"].add(worker)
        if kind == "start":
            row["first"] = t if row["first"] is None else min(row["first"], t)
        else:
            row["tests"] += 1
            row["last"] = t if row["last"] is None else max(row["last"], t)
    return rows


def _span(rows: dict) -> tuple[float, float]:
    return (min(r["first"] for r in rows.values()), max(r["last"] for r in rows.values()))


def _cells(row: dict | None, t0: float) -> list[str]:
    if row is None:
        return ["-"] * 4
    return [",".join(sorted(row["worker"])), str(row["tests"]), f"{row['first'] - t0:.1f}",
            f"{row['last'] - row['first']:.1f}"]


def main(paths: list[str]) -> None:
    runs = [read(p) for p in paths]
    names = sorted(set().union(*runs), key=lambda n: -max(
        r[n]["last"] - r[n]["first"] for r in runs if n in r))
    head = ["file"] + ["worker", "tests", "start s", "seconds"] * len(runs)
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    for n in names:
        cells = [n]
        for rows in runs:
            cells += _cells(rows.get(n), _span(rows)[0])
        print("| " + " | ".join(cells) + " |")
    for path, rows in zip(paths, runs):
        first, last = _span(rows)
        ends = defaultdict(float)
        for r in rows.values():
            for w in r["worker"]:
                ends[w] = max(ends[w], r["last"] - first)
        print(f"\n{path}: {sum(r['tests'] for r in rows.values())} tests, first start to "
              f"last end {last - first:.1f} s; each worker's last end (s): "
              + ", ".join(f"{w} {t:.0f}" for w, t in sorted(ends.items())))


if __name__ == "__main__":
    main(sys.argv[1:])
