"""Machine-readable DSE artifacts — JSON / CSV export of evaluated grids.

Counterpart of ``repro.dse.report`` (pure Python).

The bench trajectory (CI's bench-smoke artifact) and downstream tooling
consume these; every record is flat scalars so the artifact diffs cleanly
run to run.  ``write_json`` emits the full grid plus the front/knee labels;
``write_csv`` emits one row per point with the same fields.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Mapping, Sequence

from .evaluate import Evaluation
from .pareto import DEFAULT_OBJECTIVES, Objective

__all__ = ["point_record", "to_records", "write_json", "write_csv"]

_FIELDS = (
    "label",
    "family",
    "n",
    "width",
    "k",
    "ordering",
    "descending",
    "codec",
    "topology",
    "area_um2",
    "area_popcount_um2",
    "area_sort_um2",
    "area_codec_um2",
    "area_reduction",
    "total_bt",
    "aux_bt",
    "extra_wires",
    "num_flits",
    "bt_per_flit",
    "bt_reduction",
    "link_power_reduction",
    "energy_pj",
    "latency_ns",
    "latency_cycles",
    "noc_latency_ns",
    "total_latency_ns",
    "noc_bt_reduction",
    "noc_active_links",
    "hot_wire",
    "hot_wire_bt",
    "hot_wire_ratio",
    "on_front",
)


def point_record(e: Evaluation, *, on_front: bool = False) -> dict:
    """One evaluation as a flat dict of JSON-safe scalars."""
    pt = e.point
    return {
        "label": e.label,
        "family": pt.family,
        "n": pt.n,
        "width": pt.width,
        "k": pt.k,
        "ordering": pt.ordering,
        "descending": pt.descending,
        "codec": pt.codec,
        "topology": pt.topology,
        "area_um2": round(e.area_um2, 3),
        "area_popcount_um2": round(e.area.popcount, 3),
        "area_sort_um2": round(e.area.sort, 3),
        "area_codec_um2": round(e.area.codec, 3),
        "area_reduction": round(e.area_reduction, 6),
        "total_bt": e.total_bt,
        "aux_bt": e.aux_bt,
        "extra_wires": e.extra_wires,
        "num_flits": e.num_flits,
        "bt_per_flit": round(e.bt_per_flit, 6),
        "bt_reduction": round(e.bt_reduction, 6),
        "link_power_reduction": round(e.link_power_reduction, 6),
        "energy_pj": round(e.energy_pj, 3),
        "latency_ns": round(e.latency_ns, 3),
        "latency_cycles": e.timing.latency_cycles,
        "noc_latency_ns": (
            None if e.noc_latency_ns is None else round(e.noc_latency_ns, 3)
        ),
        "total_latency_ns": round(e.total_latency_ns, 3),
        "noc_bt_reduction": (
            None if e.noc_bt_reduction is None else round(e.noc_bt_reduction, 6)
        ),
        "noc_active_links": e.noc_active_links,
        "hot_wire": e.hot_wire,
        "hot_wire_bt": e.hot_wire_bt,
        "hot_wire_ratio": (
            None if e.hot_wire_ratio is None else round(e.hot_wire_ratio, 4)
        ),
        "on_front": on_front,
    }


def to_records(
    evals: Sequence[Evaluation], front: Sequence[Evaluation] = ()
) -> list[dict]:
    """Flat records for every evaluation, front membership marked."""
    front_ids = {id(e) for e in front}
    return [point_record(e, on_front=id(e) in front_ids) for e in evals]


def write_json(
    path: str,
    evals: Sequence[Evaluation],
    *,
    front: Sequence[Evaluation] = (),
    knee: Evaluation | None = None,
    workload: str = "",
    objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
    meta: Mapping[str, object] | None = None,
) -> dict:
    """Write (and return) the full grid artifact as one JSON document."""
    doc = {
        "workload": workload,
        "objectives": [obj.name for obj in objectives],
        "points": to_records(evals, front),
        "front": [e.label for e in front],
        "knee": None if knee is None else knee.label,
    }
    if meta:
        doc["meta"] = dict(meta)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return doc


def write_csv(
    path: str,
    evals: Sequence[Evaluation],
    *,
    front: Sequence[Evaluation] = (),
) -> None:
    """Write one CSV row per evaluated point (bench-trajectory format)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=_FIELDS)
        writer.writeheader()
        writer.writerows(to_records(evals, front))
