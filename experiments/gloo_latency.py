"""Latency of small gloo collectives among N processes that share one card.

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
quartiles of ``reps`` timed all-reduces (after a warm-up), in ms.

    python experiments/gloo_latency.py [--ranks 16] [--reps 50] [--bytes 24576]
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


def _blocking_sync() -> None:
    """Create card 0's primary context with blocking synchronisation."""
    cu = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    for call in (lambda: cu.cuInit(0), lambda: cu.cuDeviceGet(ctypes.byref(dev), 0),
                 lambda: cu.cuDevicePrimaryCtxSetFlags(dev, 0x04)):
        if call() != 0:
            raise RuntimeError("the CUDA driver refused to set blocking synchronisation")


def rank_main(rank: int, world: int, port: int, variant: str, reps: int, nbytes: int) -> None:
    if variant == "cuda-blocking":
        _blocking_sync()
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = torch.device("cpu" if variant == "cpu" else "cuda:0")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        t = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
        times = []
        for i in range(reps + 5):
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(t)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            q = statistics.quantiles(times, n=4)
            print(json.dumps({"variant": variant, "ranks": world, "bytes": nbytes,
                              "median_ms": statistics.median(times), "q1_ms": q[0],
                              "q3_ms": q[2]}), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--bytes", type=int, default=24576)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.port, args.variants[0], args.reps, args.bytes)
        return
    for variant in args.variants:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--ranks",
                                   str(args.ranks), "--port", str(port), "--variants", variant,
                                   "--reps", str(args.reps), "--bytes", str(args.bytes)])
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
