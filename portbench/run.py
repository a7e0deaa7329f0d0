"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the cell's inputs are made on the card from
``--seed``, every shape is warmed up, then the port (``src/repro_torch``)
is measured for ``--seconds`` seconds, compared with the plain reference,
and the last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, also the last lines of standard error).  With ``--trace 0`` the
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones, read from a ``torch.profiler`` trace of the window.

Without a CUDA card, or with fewer cards than the cell asks for, it
prints no result and exits 2.  If JAX, flax or the JAX package ``repro``
is loaded once the window has closed, it prints no result and exits 3.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import harness

    with open(ROOT / "BENCHMARK.json") as f:
        cell = harness.load_cell(json.load(f), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}; "
              "no result", file=sys.stderr)
        return 2
    result, window = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      torch.device("cuda", 0), STARTED)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}: {window['steps']} steps in "
          f"{window['seconds']:.3f} s, median step {window['step_ms_median']:.3f} ms, "
          f"reference {window['check_s']:.1f} s, set-up {window['setup_split_s']}; " +
          " ".join(f"{k}={v['value']}" for k, v in result["metrics"].items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
