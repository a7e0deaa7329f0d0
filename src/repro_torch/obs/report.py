"""Reports over collected telemetry: per-link BT tables, top-N hottest
links, CSV/JSON heatmap dumps.

Counterpart of ``repro.obs.report``.  Everything here reads a
:class:`~repro_torch.obs.metrics.Registry` populated by the ``noc.link`` /
``link.report`` / ``link.activity`` probes (and the scenario records of a
traffic campaign) and emits flat records with JSON-safe values, so the
artifacts diff cleanly.  The NoC and capture layers that fire the
per-link probes are later slices of the port; until then their tables are
empty.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Sequence

from .metrics import Registry, registry_from_dict

__all__ = [
    "link_table",
    "top_links",
    "format_links",
    "write_links_csv",
    "activity_table",
    "top_wires",
    "write_activity_csv",
    "scenario_table",
    "format_scenarios",
    "write_scenarios_csv",
    "write_scenarios_json",
    "metrics_dict",
    "write_metrics_json",
    "read_metrics_json",
]

LINK_FIELDS = (
    "link",
    "src",
    "dst",
    "bt_input",
    "bt_weight",
    "aux_bt",
    "gross_bt",
    "num_flits",
    "bt_per_flit",
    "energy_pj",
)


def link_table(registry: Registry) -> list[dict]:
    """One flat record per NoC link seen by the ``noc.link`` probe.

    Values accumulate across every ``simulate_noc`` run inside the
    ``collect()`` scope — a link traversed by several fabric runs reports
    its total traffic.
    """
    rows: dict[tuple[int, int, int], dict] = {}
    for series in registry.series("noc.link.bt"):
        lab = series.labels
        key = (int(lab["link"]), int(lab["src"]), int(lab["dst"]))
        row = rows.setdefault(
            key,
            {
                "link": key[0],
                "src": key[1],
                "dst": key[2],
                "bt_input": 0,
                "bt_weight": 0,
                "aux_bt": 0,
            },
        )
        row[f"bt_{lab['side']}" if lab["side"] != "aux" else "aux_bt"] = int(
            series.value
        )
    for key, row in rows.items():
        lab = {"link": key[0], "src": key[1], "dst": key[2]}
        flits = int(registry.value("noc.link.flits", **lab))
        gross = row["bt_input"] + row["bt_weight"] + row["aux_bt"]
        row["gross_bt"] = gross
        row["num_flits"] = flits
        row["bt_per_flit"] = round(gross / max(flits, 1), 6)
        row["energy_pj"] = round(
            registry.value("noc.link.energy_pj", **lab), 3
        )
    return [rows[k] for k in sorted(rows)]


def top_links(registry: Registry, n: int = 5) -> list[dict]:
    """The n hottest links by gross BT (data + invert-line), descending."""
    table = link_table(registry)
    table.sort(key=lambda r: (-r["gross_bt"], r["link"]))
    return table[:n]


def format_links(rows: Sequence[dict]) -> str:
    """Aligned text table of link records (the bench / example view)."""
    head = (
        f"{'link':>4s} {'route':>9s} {'input BT':>10s} {'weight BT':>10s} "
        f"{'aux BT':>8s} {'gross BT':>10s} {'flits':>8s} {'BT/flit':>8s} "
        f"{'energy pJ':>11s}"
    )
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['link']:4d} {r['src']:>4d}->{r['dst']:<4d} "
            f"{r['bt_input']:10d} {r['bt_weight']:10d} {r['aux_bt']:8d} "
            f"{r['gross_bt']:10d} {r['num_flits']:8d} "
            f"{r['bt_per_flit']:8.2f} {r['energy_pj']:11.1f}"
        )
    return "\n".join(lines)


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def write_links_csv(path: str, registry: Registry) -> list[dict]:
    """Write (and return) the per-link heatmap CSV — one row per directed
    link with its accumulated BT/energy, the ``(src, dst)`` pair being the
    heatmap coordinate (README: "reading a per-link heatmap CSV")."""
    rows = link_table(registry)
    _ensure_parent(path)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=LINK_FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    return rows


ACTIVITY_FIELDS = (
    "link",
    "src",
    "dst",
    "toggles",
    "windows",
    "wire_mean",
    "wire_max",
    "hot_wire",
    "hot_wire_toggles",
)


def activity_table(registry: Registry) -> list[dict]:
    """One flat record per link seen by the ``link.activity`` probe —
    the wire-resolved companion to :func:`link_table` (totals, per-wire
    spread, and the hottest net of each link)."""
    rows: dict[tuple[int, int, int], dict] = {}
    for series in registry.series("link.activity.toggles"):
        lab = series.labels
        key = (int(lab["link"]), int(lab["src"]), int(lab["dst"]))
        slab = {"link": lab["link"], "src": lab["src"], "dst": lab["dst"]}
        hist = registry.histogram("link.activity.wire_toggles", **slab)
        hot_wire, hot_tog = "", 0
        for s in registry.series("link.activity.hot_wire_toggles"):
            hl = s.labels
            if (int(hl["link"]), int(hl["src"]), int(hl["dst"])) == key:
                if s.value >= hot_tog:
                    hot_wire, hot_tog = hl["wire"], int(s.value)
        rows[key] = {
            "link": key[0],
            "src": key[1],
            "dst": key[2],
            "toggles": int(series.value),
            "windows": int(
                registry.value("link.activity.windows", **slab)
            ),
            "wire_mean": round(hist.mean, 3),
            "wire_max": int(hist.max) if hist.count else 0,
            "hot_wire": hot_wire,
            "hot_wire_toggles": hot_tog,
        }
    return [rows[k] for k in sorted(rows)]


def top_wires(registry: Registry, n: int = 5) -> list[dict]:
    """The n hottest (link, wire) pairs by toggle count, descending —
    the hot-wire-tail summary the bench prints."""
    pairs = [
        {
            "link": int(s.labels["link"]),
            "src": int(s.labels["src"]),
            "dst": int(s.labels["dst"]),
            "wire": s.labels["wire"],
            "toggles": int(s.value),
        }
        for s in registry.series("link.activity.hot_wire_toggles")
    ]
    pairs.sort(key=lambda r: (-r["toggles"], r["link"], r["wire"]))
    return pairs[:n]


def write_activity_csv(path: str, registry: Registry) -> list[dict]:
    """Write (and return) the per-link activity summary CSV (the full
    per-wire heatmap CSV comes from ``repro_torch.obs.activity.write_wires_csv``
    — this one is the registry-derived roll-up)."""
    rows = activity_table(registry)
    _ensure_parent(path)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=ACTIVITY_FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    return rows


SCENARIO_FIELDS = (
    "scenario",
    "streams",
    "num_bytes",
    "num_flits",
    "bt_base",
    "red_acc",
    "red_app",
    "red_composed",
    "energy_base_pj",
    "energy_app_pj",
    "noc_red_acc",
    "hot_link",
    "hot_wire",
)


def scenario_table(records: Sequence[dict]) -> list[dict]:
    """Normalized per-scenario campaign records.

    ``records`` come from real-traffic capture campaigns (the reference's
    ``benchmarks/model_traffic.py``): one dict per scenario with captured
    stream totals, DSE-measured BT under baseline/ACC/APP/codec-composed
    ordering, link energy, and the hottest link/wire of the scenario's NoC
    run.  Missing fields become ``""`` so partial campaigns still emit
    well-formed tables; reduction/energy floats are rounded for diffable
    artifacts.
    """
    out = []
    for rec in records:
        row = {k: rec.get(k, "") for k in SCENARIO_FIELDS}
        for k in ("red_acc", "red_app", "red_composed", "noc_red_acc"):
            if row[k] != "":
                row[k] = round(float(row[k]), 6)
        for k in ("energy_base_pj", "energy_app_pj"):
            if row[k] != "":
                row[k] = round(float(row[k]), 3)
        out.append(row)
    out.sort(key=lambda r: str(r["scenario"]))
    return out


def format_scenarios(records: Sequence[dict]) -> str:
    """Aligned text table of scenario records (the bench / README view)."""
    rows = scenario_table(records)
    head = (
        f"{'scenario':>16s} {'streams':>8s} {'bytes':>10s} {'flits':>8s} "
        f"{'base BT':>10s} {'ACC red':>8s} {'APP red':>8s} {'+codec':>8s} "
        f"{'E base pJ':>11s} {'E app pJ':>10s}"
    )
    lines = [head, "-" * len(head)]

    def pct(v):
        return f"{100 * v:7.2f}%" if v != "" else f"{'-':>8s}"

    for r in rows:
        lines.append(
            f"{str(r['scenario']):>16s} {str(r['streams']):>8s} "
            f"{str(r['num_bytes']):>10s} {str(r['num_flits']):>8s} "
            f"{str(r['bt_base']):>10s} {pct(r['red_acc'])} "
            f"{pct(r['red_app'])} {pct(r['red_composed'])} "
            f"{str(r['energy_base_pj']):>11s} {str(r['energy_app_pj']):>10s}"
        )
    return "\n".join(lines)


def write_scenarios_csv(path: str, records: Sequence[dict]) -> list[dict]:
    """Write (and return) the per-scenario campaign CSV."""
    rows = scenario_table(records)
    _ensure_parent(path)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=SCENARIO_FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    return rows


def write_scenarios_json(
    path: str, records: Sequence[dict], meta: dict | None = None
) -> dict:
    """Write (and return) the scenario campaign as one JSON document —
    the table plus campaign-level metadata (e.g. the recalibration
    comparison against the §10 synthetic numbers)."""
    doc = {"scenarios": scenario_table(records), **(meta or {})}
    _ensure_parent(path)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return doc


def metrics_dict(registry: Registry) -> dict:
    """The registry as one JSON-safe document (counters/gauges/histograms
    plus the derived per-link table)."""
    doc = registry.to_dict()
    doc["links"] = link_table(registry)
    act = activity_table(registry)
    if act:  # only present when wire activity was measured
        doc["activity"] = act
    return doc


def write_metrics_json(path: str, registry: Registry) -> dict:
    """Write (and return) the full metrics report as JSON."""
    doc = metrics_dict(registry)
    _ensure_parent(path)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return doc


def read_metrics_json(path: str) -> Registry:
    """Rebuild a registry from a :func:`write_metrics_json` artifact."""
    with open(path) as f:
        return registry_from_dict(json.load(f))
