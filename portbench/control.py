"""Readings of one cell's compared numbers: sound runs of the program, the
control and the planted faults (``faults.py``), each on several seeds in
one process at the cell's own sizes.  The benchmark's own runs never run
this.  On a card, from the root of a checkout:

    python3 portbench/control.py --workload <name> --seeds 11 12 13 --seconds 2 \\
        [--modes sound control stale half altered]

Prints one line per run (mode, seed, ``correct`` and each compared number)
and exits 1 unless every sound run is correct and every other is not.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--modes", nargs="+", default=["sound", "control", "stale", "half", "altered"])
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import faults, harness

    with open(ROOT / "BENCHMARK.json") as f:
        cell = harness.load_cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ok = True
    for mode in args.modes:
        for seed in args.seeds:
            broken = contextlib.nullcontext() if mode == "sound" else faults.BROKEN[mode]()
            with broken:
                result, window = harness.run_cell(cell, seed, args.seconds, False, dev,
                                                  time.perf_counter())
            ok &= result["correct"] == (mode == "sound")
            print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                              "correct": result["correct"], "steps": window["steps"],
                              "checks": {k: c["value"] for k, c in result["checks"].items()}}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
