"""The probe layer: routes hook firings into registries, tracers and the
profiler.

Counterpart of ``repro.obs.probes``.  Production modules call
``repro_torch._obs_hooks.span/stage/event`` at fixed probe points; while at
least one :func:`collect`, :func:`tracing` or :func:`profiled` context is
active this module's sink is installed into the hook slot and every firing
fans out to all active collectors.  ``PROBE_KINDS`` is the reference's
vocabulary; ``PORT_PROBE_KINDS`` adds the port's own stage spans, which
the reference has no probe for:

  =================  =====  ==============================================
  kind               form   fired by
  =================  =====  ==============================================
  kernel.dispatch    span   every public kernel entry point in
                            ``repro_torch.kernels.ops`` (backend "cuda" /
                            "torch", shapes, CUDA launches of the call)
  link.tx            span   ``link.TxPipeline.run`` (fused or staged)
  link.stage         span   each staged-path stage (order/assemble/codec/
                            bt) inside ``TxPipeline.run``
  link.report        event  ``TxPipeline.measure``/``measure_rows`` —
                            per-stream BT/energy totals
  link.activity      event  ``noc.simulate_noc`` with ``activity_windows``
                            — per-link wire toggles
  noc.simulate       span   ``noc.simulate_noc`` (the whole fabric)
  noc.expand         span   ``noc.expand_fabric``
  noc.link           event  ``noc.simulate_noc`` — per-link BT/energy
  noc.contend        event  ``noc.fabric_latency`` — per-link queueing
  dse.measure        span   ``dse`` — one measurement of a design point's
                            links
  dse.link           event  ``dse`` — per-link BT of a design point
  dse.point          event  ``dse`` — a design point's BT reduction
  codec.stream       event  per-stream totals in ``codec.compare_streams``
  capture.stream     event  each stream ``obs.capture`` records
  bench.module       span   the reference's benchmark modules; the port
                            fires none
  traffic.stage      span   port only: ``traffic.int8_view``,
                            ``traffic.egress_permutation`` and its base
                            adds (label ``stage``)
  noc.stage          span   port only: each stage of ``simulate_noc`` and
                            ``expand_fabric`` — plan, batch, source_order,
                            gather, queue, assemble, pad, readback, links
  =================  =====  ==============================================

Span firings become Chrome trace spans on every active tracer plus a
``<kind>.calls`` counter and ``<kind>.seconds`` histogram (labeled by the
kind's identity keys) on every active registry; a ``kernel.dispatch`` span
also adds its ``kernel_launches`` to the ``kernel.launches`` counter.
While :func:`profiled` is active each span also opens a
``torch.profiler.record_function`` range named ``repro_torch.<area>.<what>``
(:func:`_range_name`), so the spans sit in the profiler's own trace, on the
device's clock.  Event firings become instant trace events plus the
per-kind counters below.  Unknown kinds still count (``<kind>.calls``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from .. import _obs_hooks

from .activity import wire_name
from .metrics import Registry
from .trace import Tracer

__all__ = [
    "PROBE_KINDS",
    "PORT_PROBE_KINDS",
    "collect",
    "tracing",
    "profiled",
    "active_registries",
    "active_tracers",
]

# the probe vocabulary — kind -> form, the reference's dict verbatim
# (tests/test_torch_obs.py holds the two equal)
PROBE_KINDS: dict[str, str] = {
    "kernel.dispatch": "span",
    "link.tx": "span",
    "link.stage": "span",
    "link.report": "event",
    "link.activity": "event",
    "noc.expand": "span",
    "noc.simulate": "span",
    "noc.link": "event",
    "noc.contend": "event",
    "dse.measure": "span",
    "dse.link": "event",
    "dse.point": "event",
    "codec.stream": "event",
    "capture.stream": "event",
    "bench.module": "span",
}

# label keys lifted from span payloads into metric series identity —
# everything else stays trace-only (unbounded-cardinality values like
# shapes must never become label sets)
_SPAN_LABELS: dict[str, tuple[str, ...]] = {
    "kernel.dispatch": ("entry", "backend"),
    "link.tx": ("path", "key", "codec"),
    "link.stage": ("stage",),
    "noc.expand": ("topology", "sort_at"),
    "noc.simulate": ("topology", "sort_at"),
    "dse.measure": ("width",),
    "bench.module": ("module",),
}


# the port's own kinds (tests/test_torch_obs.py holds them apart from the
# reference's): named stages inside a layer's entry point
PORT_PROBE_KINDS: dict[str, str] = {
    "traffic.stage": "span",
    "noc.stage": "span",
}

_PORT_SPAN_LABELS: dict[str, tuple[str, ...]] = {
    "traffic.stage": ("stage",),
    "noc.stage": ("stage",),
}

# the payload key whose value ends a span's profiler range name
_RANGE_KEYS: dict[str, str] = {
    "kernel.dispatch": "entry",
    "link.stage": "stage",
    "traffic.stage": "stage",
    "noc.stage": "stage",
}


def _range_name(kind: str, data: dict) -> str:
    """The profiler range of one span: ``repro_torch.<area>.<what>``, the
    area the kind's first part and ``what`` its naming label's value
    (``kernel.dispatch`` -> the entry, a stage kind -> the stage) or else
    the kind's second part (``noc.simulate`` -> ``simulate``)."""
    area, what = kind.split(".", 1)
    key = _RANGE_KEYS.get(kind)
    return f"repro_torch.{area}.{data[key] if key in data else what}"


def _labels(kind: str, data: dict) -> dict:
    keys = _SPAN_LABELS.get(kind) or _PORT_SPAN_LABELS.get(kind, ())
    return {k: data[k] for k in keys if k in data}


def _record_span(reg: Registry, kind: str, data: dict, seconds: float) -> None:
    labels = _labels(kind, data)
    reg.counter(f"{kind}.calls", **labels).inc()
    reg.histogram(f"{kind}.seconds", **labels).observe(seconds)
    if kind == "kernel.dispatch":
        reg.counter("kernel.launches", **labels).inc(data.get("kernel_launches", 0))


def _record_event(reg: Registry, kind: str, data: dict) -> None:
    if kind == "noc.link":
        lab = {
            "link": data["link"], "src": data["src"], "dst": data["dst"],
        }
        reg.counter("noc.link.bt", side="input", **lab).inc(data["bt_input"])
        reg.counter("noc.link.bt", side="weight", **lab).inc(data["bt_weight"])
        reg.counter("noc.link.bt", side="aux", **lab).inc(data["bt_aux"])
        reg.counter("noc.link.flits", **lab).inc(data["num_flits"])
        reg.counter("noc.link.energy_pj", **lab).inc(data["energy_pj"])
    elif kind == "noc.contend":
        lab = {
            "link": data["link"], "src": data["src"], "dst": data["dst"],
        }
        reg.counter("noc.contend.flows", **lab).inc(data["flows"])
        reg.counter("noc.contend.wait_cycles", **lab).inc(
            data["wait_cycles"]
        )
    elif kind == "link.report":
        lab = {"stream": data["name"]}
        reg.counter("link.bt", side="input", **lab).inc(data["bt_input"])
        reg.counter("link.bt", side="weight", **lab).inc(data["bt_weight"])
        reg.counter("link.bt", side="aux", **lab).inc(data["aux_bt"])
        reg.counter("link.flits", **lab).inc(data["num_flits"])
        reg.counter("link.energy_pj", **lab).inc(data["energy_pj"])
    elif kind == "link.activity":
        lab = {
            "link": data["link"], "src": data["src"], "dst": data["dst"],
        }
        reg.counter("link.activity.toggles", **lab).inc(
            data["toggles_total"]
        )
        reg.counter("link.activity.windows", **lab).inc(
            data["num_windows"]
        )
        reg.counter(
            "link.activity.hot_wire_toggles",
            wire=wire_name(data["hot_wire"], data["data_lanes"]),
            **lab,
        ).inc(data["hot_wire_toggles"])
        # per-wire distribution as a histogram (bounded series count —
        # wire *values* stream through one series per link, never one
        # series per wire)
        hist = reg.histogram("link.activity.wire_toggles", **lab)
        for v in data["per_wire"]:
            hist.observe(v)
    elif kind == "dse.link":
        lab = {"link": data["link"], "width": data["width"]}
        reg.counter("dse.link.bt", **lab).inc(data["bt"])
        reg.counter("dse.link.packets", **lab).inc(data["packets"])
    elif kind == "dse.point":
        reg.counter("dse.points", width=data["width"]).inc()
        reg.histogram("dse.point.bt_reduction").observe(data["bt_reduction"])
    elif kind == "codec.stream":
        reg.counter(
            "codec.stream.bt", workload=data["workload"],
            stream=data["stream"],
        ).inc(data["bt"])
    elif kind == "capture.stream":
        lab = {"scenario": data["scenario"], "stream": data["stream"]}
        reg.counter("capture.bytes", **lab).inc(data["bytes"])
        reg.counter("capture.streams", **lab).inc()
    else:  # unknown kinds still count — new probes degrade gracefully
        reg.counter(f"{kind}.calls", **_labels(kind, data)).inc()


class _SpanCtx:
    """One probe span fanned out to every active tracer + registry, and to
    the profiler while one ``profiled()`` scope is open."""

    __slots__ = ("_sink", "_kind", "_data", "_ends", "_range", "_t0")

    def __init__(self, sink: "_Sink", kind: str, data: dict) -> None:
        self._sink, self._kind, self._data = sink, kind, data

    def __enter__(self):
        self._ends = [
            t.begin(self._kind, args=self._data) for t in self._sink.tracers
        ]
        self._range = None
        if self._sink.profiled:
            self._range = torch.profiler.record_function(_range_name(self._kind, self._data))
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        for end in self._ends:
            end()
        for reg in self._sink.registries:
            _record_span(reg, self._kind, self._data, seconds)
        return False


class _Sink:
    """The multiplexer installed into ``repro_torch._obs_hooks.SINK``."""

    def __init__(self) -> None:
        self.registries: list[Registry] = []
        self.tracers: list[Tracer] = []
        self.profiled = 0  # open profiled() scopes

    def span(self, kind: str, data: dict) -> _SpanCtx:
        return _SpanCtx(self, kind, data)

    def event(self, kind: str, data: dict) -> None:
        for t in self.tracers:
            t.instant(kind, args=data)
        for reg in self.registries:
            _record_event(reg, kind, data)


_SINK = _Sink()


def _refresh() -> None:
    _obs_hooks.SINK = (
        _SINK if (_SINK.registries or _SINK.tracers or _SINK.profiled) else None
    )


def active_registries() -> tuple[Registry, ...]:
    return tuple(_SINK.registries)


def active_tracers() -> tuple[Tracer, ...]:
    return tuple(_SINK.tracers)


@contextmanager
def collect(registry: Registry | None = None):
    """Activate metrics collection for the with-body; yields the registry.

    Nested ``collect()`` scopes all receive every probe firing (each scope
    sees its own totals).  Entering the first scope is what installs the
    sink — before that, probes are a ``None`` test and nothing else.
    """
    reg = Registry() if registry is None else registry
    _SINK.registries.append(reg)
    _refresh()
    try:
        yield reg
    finally:
        _SINK.registries.remove(reg)
        _refresh()


@contextmanager
def tracing(tracer: Tracer | None = None):
    """Activate span tracing for the with-body; yields the tracer."""
    tr = Tracer() if tracer is None else tracer
    _SINK.tracers.append(tr)
    _refresh()
    try:
        yield tr
    finally:
        _SINK.tracers.remove(tr)
        _refresh()


@contextmanager
def profiled():
    """Put every probe span of the with-body in ``torch.profiler``'s trace.

    Each span opens ``torch.profiler.record_function(_range_name(...))`` and
    closes it when it ends, so a profiler recording around the body holds
    the port's ranges on the same clock as its kernels: each device
    operation can be traced back to the spans open when it was launched,
    and each idle gap to the span the host was in.  Nested scopes open one
    range a span.  Outside a profiler recording a range costs a few host
    microseconds and records nothing.
    """
    _SINK.profiled += 1
    _refresh()
    try:
        yield
    finally:
        _SINK.profiled -= 1
        _refresh()
