"""Latency and rate of gloo collectives among N processes that share one card.

Phase 3k of ``chip_smoke.py`` runs granite-moe-3b-a800m on 16 processes of
a gloo group sharing one GPU, and a decode step issues ~194 collectives of
a few KB.  This measures one all-reduce among N processes three ways:

* ``cuda``: the tensor on card 0 (gloo copies it through host memory), the
  process's CUDA context with the driver's default scheduling, which spins
  the CPU while it waits for the card when the host has the cores;
* ``cuda-blocking``: the same with the primary context created with
  ``CU_CTX_SCHED_BLOCKING_SYNC`` (set through the driver before torch
  touches the card), so a waiting process sleeps;
* ``cpu``: the tensor in host memory, no card.

Each variant starts N fresh processes; rank 0 prints the median and the
quartiles of ``reps`` timed collectives (after a warm-up), in ms, and the
rate of the median call in GB/s of result bytes.  ``--op`` picks the
collective: ``all-reduce`` of ``--bytes``, or FSDP's pair,
``all-gather`` (``all_gather_into_tensor``, a ``--bytes`` result) and
``reduce-scatter`` (``reduce_scatter_tensor`` with a SUM, a ``--bytes``
input, a 1 / N result).

    python experiments/gloo_latency.py [--ranks 16] [--reps 50] [--bytes 24576]
    python experiments/gloo_latency.py --ranks 2 --variants cuda --op reduce-scatter \
        --bytes 1073741824 --reps 5
"""

from __future__ import annotations

import argparse
import ctypes
import json
import socket
import statistics
import subprocess
import sys
import time

VARIANTS = ("cuda", "cuda-blocking", "cpu")
OPS = ("all-reduce", "all-gather", "reduce-scatter")


def _blocking_sync() -> None:
    """Create card 0's primary context with blocking synchronisation."""
    cu = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    for call in (lambda: cu.cuInit(0), lambda: cu.cuDeviceGet(ctypes.byref(dev), 0),
                 lambda: cu.cuDevicePrimaryCtxSetFlags(dev, 0x04)):
        if call() != 0:
            raise RuntimeError("the CUDA driver refused to set blocking synchronisation")


def _op(op: str, world: int, nbytes: int, dev):
    """(the call, its result bytes) of collective ``op`` over ``nbytes``."""
    import torch
    import torch.distributed as dist

    n = nbytes // 4 // world * world
    if op == "all-reduce":
        t = torch.ones(n, dtype=torch.float32, device=dev)
        return (lambda: dist.all_reduce(t)), n * 4
    whole = torch.ones(n, dtype=torch.float32, device=dev)
    part = torch.ones(n // world, dtype=torch.float32, device=dev)
    if op == "all-gather":
        return (lambda: dist.all_gather_into_tensor(whole, part)), n * 4
    return (lambda: dist.reduce_scatter_tensor(part, whole)), n // world * 4


def rank_main(rank: int, world: int, port: int, variant: str, reps: int, nbytes: int,
              op: str = "all-reduce") -> None:
    if variant == "cuda-blocking":
        _blocking_sync()
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = torch.device("cpu" if variant == "cpu" else "cuda:0")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        call, result = _op(op, world, nbytes, dev)
        times = []
        for i in range(reps + 5):
            dist.barrier()
            t0 = time.perf_counter()
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            q = statistics.quantiles(times, n=4)
            med = statistics.median(times)
            print(json.dumps({"variant": variant, "op": op, "ranks": world, "bytes": nbytes,
                              "result_bytes": result, "median_ms": med, "q1_ms": q[0],
                              "q3_ms": q[2], "gb_per_s": result / med / 1e6}), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--bytes", type=int, default=24576)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--op", default="all-reduce", choices=OPS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.port, args.variants[0], args.reps, args.bytes,
                  args.op)
        return
    for variant in args.variants:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--ranks",
                                   str(args.ranks), "--port", str(port), "--variants", variant,
                                   "--reps", str(args.reps), "--bytes", str(args.bytes),
                                   "--op", args.op])
                 for r in range(args.ranks)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise SystemExit(f"{variant}: the ranks exited {codes}")


if __name__ == "__main__":
    main()
