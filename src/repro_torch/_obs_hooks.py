"""Zero-cost observability hook slots.

Counterpart of ``repro._obs_hooks``.  This module is the only thing the
port's production code imports for telemetry.  It holds one mutable slot,
``SINK`` — ``None`` by default — that ``repro_torch.obs`` installs a
collector into while a ``collect()`` / ``tracing()`` / ``profiled()``
context is active.
With the slot empty every probe is one attribute test against ``None``,
so an entry point does the same tensor work, launches the same kernels
and returns the same outputs whether ``repro_torch.obs`` is imported,
active, or absent (``tests/test_torch_obs.py``).  A probe reads Python
scalars the call already has on the host: it never syncs the device.

Dependency-free: the module imports nothing, so the hot path carries no
observability code until a collector turns it on.
"""

from __future__ import annotations

__all__ = ["SINK", "TAP", "active", "capturing", "event", "muted", "span", "stage", "tap"]

# The installed sink (repro_torch.obs.probes._Sink) or None.  Probes read
# this once per call; repro_torch.obs flips it when the first collector
# activates.
SINK = None

# The installed traffic tap (repro_torch.obs.capture._Tap) or None.  Tap
# payloads carry tensors, not the JSON-safe scalars the probe sink
# expects, hence a slot of its own with the same zero-cost contract.
TAP = None

# Depth of open ``muted()`` scopes: tap sites inside one record nothing.
_MUTED = 0


class _NullSpan:
    """No-op context manager returned while no sink is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def active() -> bool:
    """True while at least one collector (registry, tracer or profiler bridge) is active."""
    return SINK is not None


def span(kind: str, **data):
    """A context manager timing one probe span (no-op when inactive).

    ``kind`` names the probe point (e.g. ``"kernel.dispatch"``); ``data``
    carries JSON-safe scalars only — never a tensor, whose conversion
    would wait for the device.
    """
    s = SINK
    return _NULL_SPAN if s is None else s.span(kind, data)


def stage(kind: str, name: str):
    """The probe span of one named stage of a layer (no-op when inactive).

    ``kind`` is a stage kind (``"traffic.stage"``, ``"noc.stage"``) and
    ``name`` its ``stage`` label.  Unlike ``span``, the call takes no
    keywords, so while nothing collects it builds no payload at all.
    """
    s = SINK
    return _NULL_SPAN if s is None else s.span(kind, {"stage": name})


def event(kind: str, **data) -> None:
    """Fire one instant probe event (no-op when inactive)."""
    s = SINK
    if s is not None:
        s.event(kind, data)


def capturing() -> bool:
    """True while at least one traffic-capture session is active."""
    return TAP is not None


def tap(kind: str, **payload) -> None:
    """Offer tensors at a traffic-tap site (no-op when no capture is
    active, or inside ``muted()``)."""
    t = TAP
    if t is not None and not _MUTED:
        t.tap(kind, payload)


class _Muted:
    """The context manager ``muted()`` returns."""

    __slots__ = ()

    def __enter__(self):
        global _MUTED
        _MUTED += 1
        return self

    def __exit__(self, *exc):
        global _MUTED
        _MUTED -= 1
        return False


def muted():
    """A scope in which tap sites record nothing.

    ``repro_torch.serve`` runs the model's prefill and decode inside one:
    the reference jits them, so a tap site inside the model (``moe.dispatch``)
    sees tracers there and its tap drops them.  The serving loop's own taps
    (``serve.weights``, ``serve.kv``) fire outside the scope, as in the
    reference.
    """
    return _Muted()
