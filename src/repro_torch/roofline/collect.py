"""Roofline inputs from a torch run (counterpart of ``repro.roofline.collect``).

The reference reads a compiled executable: XLA's ``cost_analysis`` for
FLOPs and bytes, ``memory_analysis`` for the peak, and the HLO text for
the collective schedule.  The port never has HLO, so its record comes from
stand-ins, each named in the record:

  * ``hlo_flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
    around the step (matrix products, convolutions and attention; it
    counts no elementwise op, as XLA's FLOPs are dominated by the same
    products);
  * ``peak_bytes_per_device``: ``torch.cuda.max_memory_allocated`` over the
    step (absent on the CPU);
  * ``collective_ops``: the port's own collective calls, recorded as they
    are issued (kind, result bytes, group size, trip);
  * no ``hlo_bytes_per_device``: nothing in torch counts bytes accessed,
    so ``analysis.analyse`` reads the memory floor alone.

``summarize_collectives`` and ``wire_bytes`` are the reference's, over
the same records.  A collective over a one-rank group moves nothing over a
link, so ``wire_bytes`` counts it as 0 (XLA drops such collectives, so the
reference never meets one).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

from .. import _collectives

__all__ = ["summarize_collectives", "wire_bytes", "record_collectives", "collect_from_step"]

_WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def summarize_collectives(records: list[dict]) -> dict[str, dict]:
    summary: dict[str, dict] = {}
    for r in records:
        trip = r.get("trip", 1)
        s = summary.setdefault(r["kind"], {"count": 0, "bytes": 0})
        s["count"] += trip
        s["bytes"] += r["bytes"] * trip
    return summary


def wire_bytes(collective_ops: list[dict]) -> float:
    """Ring-algorithm wire bytes per device (factors above, trips applied);
    an unknown group counts as 2, a one-rank group as nothing."""
    total = 0.0
    for op in collective_ops:
        n = op.get("group") or 2
        if n < 2:
            continue
        total += _WIRE_FACTOR[op["kind"]](n) * op["bytes"] * op.get("trip", 1)
    return total


@contextlib.contextmanager
def record_collectives():
    """Collect the port's collective calls made inside the block into the
    list it yields."""
    sink: list = []
    _collectives._SINKS.append(sink)
    try:
        yield sink
    finally:
        _collectives._SINKS.remove(sink)


def collect_from_step(
    step: Callable, *args, arch: str, shape: str, kind: str, mesh_desc: str,
    num_devices: int, cfg, device=None,
) -> dict[str, Any]:
    """Run ``step(*args)`` once and return its roofline record, with the
    keys of the reference's ``collect_from_compiled`` that a torch run can
    fill.  ``device`` (a CUDA device) adds the step's peak memory."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with FlopCounterMode(display=False) as counter, record_collectives() as ops:
        step(*args)
    rec: dict[str, Any] = {
        "arch": arch,
        "shape": shape,
        "kind": kind,
        "mesh": mesh_desc,
        "num_devices": num_devices,
        "hlo_flops_per_device": float(counter.get_total_flops()),
        "cost_source": "torch.FlopCounterMode",
        "collectives": summarize_collectives(ops),
        "collective_ops": ops,
        "collective_source": "the port's collective calls",
        "wire_bytes_per_device": wire_bytes(ops),
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
    }
    if cuda:
        torch.cuda.synchronize(device)
        rec["peak_bytes_per_device"] = int(torch.cuda.max_memory_allocated(device))
        rec["peak_source"] = "torch.cuda.max_memory_allocated"
    return rec
