"""The port's record of its own collective calls.

Every collective the port issues (``optim.compress``, the rule-placed train
step, the sharded link axis, the pipeline) calls :func:`note` with its
kind (the XLA names of ``repro.roofline.collect``), its result bytes and
its group's size.  While ``roofline.collect.record_collectives()`` is open
the notes land in its list; otherwise :func:`note` is one ``if``.
"""

from __future__ import annotations

_SINKS: list[list] = []


def group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def note(kind: str, nbytes: int, group=None, size: int | None = None) -> None:
    """Record one collective of ``kind`` whose result is ``nbytes`` bytes
    over ``group`` (a process group, or None for the world), or over
    ``size`` ranks where that is given."""
    if _SINKS:
        _SINKS[-1].append({"kind": kind, "bytes": int(nbytes),
                           "group": size if size is not None else group_size(group),
                           "trip": 1})
