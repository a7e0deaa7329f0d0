"""Span tracing in Chrome/Perfetto trace-event JSON.

Counterpart of ``repro.obs.trace``.  A :class:`Tracer` records *complete*
spans (``ph: "X"``) and *instant* events (``ph: "i"``) with microsecond
timestamps on one (pid, tid) timeline; nested ``span()`` contexts nest
visually in Perfetto / ``chrome://tracing`` purely by timestamp
containment.  ``to_chrome()`` emits the JSON object form
(``{"traceEvents": [...], "metadata": {...}}``), whose metadata names the
torch version, its CUDA version and the device; ``write()`` puts it on
disk.

Spans time host-side enqueue, not device time: PyTorch returns from a
kernel launch before the card has run it, and no probe synchronizes the
device (that would change what is being measured).  A span around a call
whose result the caller reads on the host includes that wait; for a
kernel's own time use CUDA events or ``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Mapping

import torch

__all__ = ["Tracer", "runtime_metadata"]


def runtime_metadata() -> dict:
    """What ran the traced program: the torch and CUDA versions and the
    device (the CUDA device's name, or "cpu" without one)."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
    }


def _json_safe(value):
    """Coerce probe payload values into JSON-serializable scalars."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (tuple, list)):
        return [_json_safe(v) for v in value]
    if isinstance(value, Mapping):
        return {str(k): _json_safe(v) for k, v in value.items()}
    return str(value)


class Tracer:
    """Collects trace events; one instance per trace file."""

    def __init__(self, process_name: str = "repro_torch") -> None:
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._pid,
                "tid": 0,
                "args": {"name": process_name},
            }
        ]

    # ----------------------------------------------------------------- time
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # --------------------------------------------------------------- record
    @contextmanager
    def span(self, name: str, cat: str = "repro_torch", args: Mapping | None = None):
        """Record one complete ("X") span around the with-body."""
        ts = self._now_us()
        try:
            yield self
        finally:
            self._events.append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": ts,
                    "dur": self._now_us() - ts,
                    "pid": self._pid,
                    "tid": threading.get_ident() & 0xFFFF,
                    "args": _json_safe(dict(args or {})),
                }
            )

    def begin(self, name: str, cat: str = "repro_torch", args: Mapping | None = None):
        """Imperative form of :meth:`span` for the probe layer: returns a
        zero-argument ``end()`` callable."""
        ts = self._now_us()

        def end() -> None:
            self._events.append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": ts,
                    "dur": self._now_us() - ts,
                    "pid": self._pid,
                    "tid": threading.get_ident() & 0xFFFF,
                    "args": _json_safe(dict(args or {})),
                }
            )

        return end

    def instant(self, name: str, cat: str = "repro_torch", args: Mapping | None = None):
        """Record one instant ("i") event."""
        self._events.append(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",
                "ts": self._now_us(),
                "pid": self._pid,
                "tid": threading.get_ident() & 0xFFFF,
                "args": _json_safe(dict(args or {})),
            }
        )

    # -------------------------------------------------------------- queries
    @property
    def events(self) -> tuple[dict, ...]:
        return tuple(self._events)

    def spans(self, name: str | None = None) -> list[dict]:
        """All complete spans, optionally filtered by exact name."""
        return [
            e
            for e in self._events
            if e["ph"] == "X" and (name is None or e["name"] == name)
        ]

    def span_seconds(self, name: str) -> float:
        """Total duration (s) of every span with this name."""
        return sum(e["dur"] for e in self.spans(name)) / 1e6

    # --------------------------------------------------------------- export
    def to_chrome(self, metadata: Mapping | None = None) -> dict:
        """The JSON-object trace form Perfetto / chrome://tracing load;
        ``metadata`` adds to (or overrides) :func:`runtime_metadata`."""
        return {
            "traceEvents": list(self._events),
            "displayTimeUnit": "ms",
            "metadata": _json_safe({**runtime_metadata(), **dict(metadata or {})}),
        }

    def write(self, path: str, metadata: Mapping | None = None) -> dict:
        """Write (and return) the Chrome trace document."""
        doc = self.to_chrome(metadata)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return doc
