"""Wire-level switching-activity profiles.

Counterpart of ``repro.obs.activity``.  The kernels' ``activity_windows=``
mode (``repro_torch.kernels.bt_count_axes`` / ``bt_count_links`` /
``bt_count_codecs``) returns raw per-wire x per-time-window toggle tensors
plus per-wire time-at-1 totals; this module wraps one measured link's
tensors into an :class:`ActivityProfile` — the unit of wire-resolved
telemetry that the SAIF/VCD exporters (``repro_torch.obs.saif``) and the
per-wire heatmap CSV consume.  Tensors may lie on any device: each is
copied to the host once, as int64 numpy.

Wire indexing is fixed by the kernel layout: data wire ``i`` is bit
``i % 8`` of byte lane ``i // 8`` (LSB first), named ``lane<l>_b<b>``;
codec aux wires (the bus-invert invert lines) follow the data wires and
are named ``inv<p>``.  The load-bearing invariant — pinned by
:meth:`ActivityProfile.check` — is that the sum of per-wire toggles equals
the link's gross BT (data + aux), i.e. nothing the scalar accounting
counts escapes the wire-resolved view.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "ActivityProfile",
    "profile_from_arrays",
    "link_profiles",
    "profiles_from_noc",
    "wire_name",
    "wire_records",
    "write_wires_csv",
    "WIRE_FIELDS",
]


def _host(values) -> np.ndarray:
    """int64 numpy copy of an array or a tensor on any device (one copy;
    ``np.asarray`` alone refuses a CUDA tensor)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=np.int64)


def wire_name(index: int, data_lanes: int) -> str:
    """Canonical net name of wire ``index`` (the SAIF / VCD net)."""
    dw = data_lanes * 8
    if index < 0:
        raise ValueError(f"negative wire index {index}")
    if index < dw:
        return f"lane{index // 8}_b{index % 8}"
    return f"inv{index - dw}"


@dataclasses.dataclass(frozen=True)
class ActivityProfile:
    """One link's wire-resolved switching activity.

    ``toggles`` is (num_windows, num_wires) — transition counts per time
    window (a window spans ``window_flits`` flit rows); ``ones`` is
    (num_wires,) — flit rows each wire spent at logic 1 over the whole
    ``duration_flits`` run (SAIF T1; T0 = duration − T1).
    """

    name: str
    window_flits: int
    duration_flits: int
    data_lanes: int
    toggles: np.ndarray
    ones: np.ndarray

    def __post_init__(self) -> None:
        tog = _host(self.toggles)
        one = _host(self.ones)
        if tog.ndim != 2:
            raise ValueError(
                f"toggles must be (windows, wires), got {tog.shape}"
            )
        if one.shape != (tog.shape[1],):
            raise ValueError(
                f"ones shape {one.shape} != (num_wires,)={tog.shape[1:]}"
            )
        if tog.shape[1] < self.data_lanes * 8:
            raise ValueError(
                f"{tog.shape[1]} wires < {self.data_lanes} lanes x 8 bits"
            )
        if self.window_flits < 1:
            raise ValueError(f"window_flits must be >= 1: {self.window_flits}")
        object.__setattr__(self, "toggles", tog)
        object.__setattr__(self, "ones", one)

    # ------------------------------------------------------------- geometry
    @property
    def num_windows(self) -> int:
        return int(self.toggles.shape[0])

    @property
    def num_wires(self) -> int:
        return int(self.toggles.shape[1])

    @property
    def data_wires(self) -> int:
        return self.data_lanes * 8

    @property
    def aux_wires(self) -> int:
        return self.num_wires - self.data_wires

    def wire_names(self) -> list[str]:
        return [wire_name(i, self.data_lanes) for i in range(self.num_wires)]

    # ------------------------------------------------------------ summaries
    @property
    def per_wire(self) -> np.ndarray:
        """Total toggles per wire over the whole run — (num_wires,)."""
        return self.toggles.sum(axis=0)

    @property
    def gross_bt(self) -> int:
        """All transitions on all wires (data + aux) — the scalar the
        per-link counters report."""
        return int(self.per_wire.sum())

    @property
    def waveform(self) -> np.ndarray:
        """Total toggles per time window — (num_windows,), the time view."""
        return self.toggles.sum(axis=1)

    @property
    def toggle_rate(self) -> np.ndarray:
        """Per-wire activity factor: toggles per flit-boundary opportunity
        (``duration − 1`` boundaries) — (num_wires,) float in [0, 1]."""
        return self.per_wire / max(self.duration_flits - 1, 1)

    @property
    def static_prob(self) -> np.ndarray:
        """Per-wire probability of logic 1 (SAIF T1 / duration)."""
        return self.ones / max(self.duration_flits, 1)

    @property
    def t1(self) -> np.ndarray:
        """SAIF T1 per wire: flit rows at logic 1."""
        return self.ones

    @property
    def t0(self) -> np.ndarray:
        """SAIF T0 per wire: flit rows at logic 0."""
        return self.duration_flits - self.ones

    def rate_histogram(
        self, bins: int = 10
    ) -> tuple[np.ndarray, np.ndarray]:
        """Histogram of per-wire toggle rates — (counts, bin_edges) over
        [0, 1], the hot-wire-tail view."""
        return np.histogram(self.toggle_rate, bins=bins, range=(0.0, 1.0))

    def hottest_wires(self, n: int = 5) -> list[tuple[str, int]]:
        """The n wires with the most toggles, descending — ties broken by
        wire index so the ranking is deterministic."""
        pw = self.per_wire
        order = np.lexsort((np.arange(len(pw)), -pw))[:n]
        return [(wire_name(int(i), self.data_lanes), int(pw[i])) for i in order]

    # ------------------------------------------------------------ invariant
    def check(self, gross_bt: int | None = None) -> None:
        """Assert internal consistency; with ``gross_bt`` also pin the
        wire-vs-scalar invariant ``sum(per-wire toggles) == gross_bt``.

        Per-wire sanity: a wire cannot toggle more than once per boundary
        and cannot be at 1 for more rows than the run has.
        """
        max_tog = max(self.duration_flits - 1, 0)
        if (self.per_wire > max_tog).any():
            raise ValueError(
                f"{self.name}: wire toggles exceed {max_tog} boundaries"
            )
        if (self.ones > self.duration_flits).any() or (self.ones < 0).any():
            raise ValueError(
                f"{self.name}: T1 outside [0, {self.duration_flits}]"
            )
        if gross_bt is not None and self.gross_bt != int(gross_bt):
            raise ValueError(
                f"{self.name}: sum(per-wire toggles) = {self.gross_bt} "
                f"!= gross BT {int(gross_bt)}"
            )


def profile_from_arrays(
    name: str,
    toggles,
    ones,
    *,
    window_flits: int,
    duration_flits: int,
    data_lanes: int,
) -> ActivityProfile:
    """Wrap one link's raw kernel activity arrays, trimming the trailing
    all-padding windows of a stacked jagged batch (a link shorter than the
    batch's T_max owns only ``ceil(duration / window)`` windows)."""
    tog = _host(toggles)
    nw = -(-duration_flits // window_flits) if duration_flits else 0
    return ActivityProfile(
        name=name,
        window_flits=window_flits,
        duration_flits=duration_flits,
        data_lanes=data_lanes,
        toggles=tog[:nw],
        ones=_host(ones),
    )


def link_profiles(
    activity,
    *,
    window_flits: int,
    lengths: Sequence[int],
    data_lanes: int,
    names: Sequence[str] | None = None,
) -> list[ActivityProfile]:
    """Profiles for a batched measurement — duck-typed over anything with
    ``.toggles`` (L, NW, W) and ``.ones`` (L, W) arrays, i.e. the
    ``LinkActivity`` result of ``bt_count_links(..., activity_windows=)``.
    """
    tog = _host(activity.toggles)
    one = _host(activity.ones)
    if names is None:
        names = [f"link{i}" for i in range(tog.shape[0])]
    return [
        profile_from_arrays(
            str(names[i]),
            tog[i],
            one[i],
            window_flits=window_flits,
            duration_flits=int(lengths[i]),
            data_lanes=data_lanes,
        )
        for i in range(tog.shape[0])
    ]


def profiles_from_noc(report) -> list[ActivityProfile]:
    """Profiles from a NoC report with activity — duck-typed over
    ``.name`` / ``.links`` (each with ``.link`` and ``.num_flits``) /
    ``.wire_lanes`` / ``.wire_toggles`` / ``.wire_ones`` /
    ``.activity_window``, so the NoC layer never has to import this
    package (the reference's ``simulate_noc(activity_windows=)`` report
    has this shape; the port's NoC layer is a later slice)."""
    if not getattr(report, "activity_window", 0):
        raise ValueError(
            f"report {getattr(report, 'name', '?')!r} carries no activity "
            "(run simulate_noc with activity_windows=)"
        )
    lanes = report.wire_lanes
    return [
        profile_from_arrays(
            f"{report.name}.link{s.link}",
            report.wire_toggles[i],
            report.wire_ones[i],
            window_flits=report.activity_window,
            duration_flits=s.num_flits,
            data_lanes=lanes,
        )
        for i, s in enumerate(report.links)
    ]


WIRE_FIELDS = (
    "profile",
    "wire",
    "net",
    "kind",
    "lane",
    "bit",
    "toggles",
    "t1",
    "t0",
    "toggle_rate",
    "static_prob",
)


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def wire_records(profiles: Sequence[ActivityProfile]) -> list[dict]:
    """One flat JSON-safe record per (profile, wire) — the heatmap rows."""
    rows: list[dict] = []
    for p in profiles:
        pw, t1, t0 = p.per_wire, p.t1, p.t0
        rate, prob = p.toggle_rate, p.static_prob
        dw = p.data_wires
        for i in range(p.num_wires):
            rows.append(
                {
                    "profile": p.name,
                    "wire": i,
                    "net": wire_name(i, p.data_lanes),
                    "kind": "data" if i < dw else "aux",
                    "lane": i // 8 if i < dw else "",
                    "bit": i % 8 if i < dw else "",
                    "toggles": int(pw[i]),
                    "t1": int(t1[i]),
                    "t0": int(t0[i]),
                    "toggle_rate": round(float(rate[i]), 6),
                    "static_prob": round(float(prob[i]), 6),
                }
            )
    return rows


def write_wires_csv(
    path: str, profiles: Sequence[ActivityProfile]
) -> list[dict]:
    """Write (and return) the per-wire heatmap CSV — one row per wire of
    each profile, the ``(profile, wire)`` pair being the heatmap
    coordinate (README: "wire heatmap in 3 commands")."""
    rows = wire_records(profiles)
    _ensure_parent(path)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=WIRE_FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    return rows
