"""SAIF / VCD export of measured wire activity.

Counterpart of ``repro.obs.saif``; for the same profiles it writes the
same text byte for byte.  ``write_saif`` serializes
:class:`~repro_torch.obs.activity.ActivityProfile`s as a standard
backward-SAIF file — per net, ``T0``/``T1`` (time at 0/1, in flit units)
and ``TC`` (toggle count) — the exchange format EDA power flows
(PrimeTime PX, OpenSTA, ...) consume, so the kernels' measured activity
can drive an independent power estimate without re-simulation.
``parse_saif`` round-trips the format.  ``write_vcd`` dumps an actual
coded wire stream (an array or a tensor on any device) as a value-change
waveform for eyeballing in GTKWave.

Time unit: ONE FLIT.  SAIF ``DURATION`` is the longest profile's flit
count; per net ``T0 = DURATION − T1`` (a link idle past its own traffic
holds its wires at 0), so ``T0 + T1 == DURATION`` on every net.
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np

from .activity import ActivityProfile, _host, wire_name

__all__ = ["write_saif", "parse_saif", "write_vcd"]


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def _sanitize(name: str) -> str:
    """SAIF/VCD identifiers: collapse anything non-word to '_'."""
    return re.sub(r"\W", "_", name) or "_"


def write_saif(
    path: str,
    profiles: Sequence[ActivityProfile] | ActivityProfile,
    *,
    design: str = "repro",
    timescale: str = "1 ns",
) -> str:
    """Write profiles as one backward-SAIF file; returns the text.

    Each profile becomes one ``INSTANCE`` under the design top, each wire
    one ``NET`` entry named by ``wire_name`` (``lane<l>_b<b>`` /
    ``inv<p>``).  ``TX`` and ``IG`` are 0 — the measurement has no unknown
    or glitch states.
    """
    if isinstance(profiles, ActivityProfile):
        profiles = [profiles]
    if not profiles:
        raise ValueError("write_saif: no profiles")
    duration = max(p.duration_flits for p in profiles)
    lines = [
        "(SAIFILE",
        '(SAIFVERSION "2.0")',
        '(DIRECTION "backward")',
        f'(DESIGN "{_sanitize(design)}")',
        "(DIVIDER / )",
        f"(TIMESCALE {timescale})",
        f"(DURATION {duration})",
        f"(INSTANCE {_sanitize(design)}",
    ]
    for p in profiles:
        pw, t1 = p.per_wire, p.t1
        lines.append(f"  (INSTANCE {_sanitize(p.name)}")
        lines.append("    (NET")
        for i in range(p.num_wires):
            net = wire_name(i, p.data_lanes)
            one = int(t1[i])
            lines.append(f"      ({net}")
            lines.append(
                f"        (T0 {duration - one}) (T1 {one}) (TX 0)"
                f" (TC {int(pw[i])}) (IG 0)"
            )
            lines.append("      )")
        lines.append("    )")
        lines.append("  )")
    lines.append(")")
    lines.append(")")
    text = "\n".join(lines) + "\n"
    _ensure_parent(path)
    with open(path, "w") as f:
        f.write(text)
    return text


# --------------------------------------------------------------- SAIF parse
def _sexpr_tokens(text: str) -> list[str]:
    return re.findall(r'\(|\)|"[^"]*"|[^\s()]+', text)


def _sexpr_parse(tokens: list[str], pos: int = 0):
    """One nested list per parenthesized group; returns (tree, next_pos)."""
    if tokens[pos] != "(":
        return tokens[pos], pos + 1
    out: list = []
    pos += 1
    while tokens[pos] != ")":
        node, pos = _sexpr_parse(tokens, pos)
        out.append(node)
    return out, pos + 1


def parse_saif(path: str) -> dict:
    """Read a SAIF file back into a plain dict:

    ``{"duration": int, "timescale": str, "design": str,
    "instances": {name: {net: {"T0","T1","TX","TC","IG"}}}}``

    Nested instances flatten to '/'-joined names (the top design instance
    is dropped from the prefix).
    """
    with open(path) as f:
        text = f.read()
    tree, _ = _sexpr_parse(_sexpr_tokens(text))
    if not tree or tree[0] != "SAIFILE":
        raise ValueError(f"{path}: not a SAIF file")
    doc: dict = {"duration": 0, "timescale": "", "design": "", "instances": {}}

    def walk_instance(node: list, prefix: str) -> None:
        name = node[1] if len(node) > 1 and isinstance(node[1], str) else "?"
        full = f"{prefix}/{name}" if prefix else name
        for child in node[2:]:
            if not isinstance(child, list):
                continue
            if child[0] == "INSTANCE":
                walk_instance(child, full)
            elif child[0] == "NET":
                nets = doc["instances"].setdefault(full, {})
                for net in child[1:]:
                    counts = {}
                    for item in net[1:]:
                        if isinstance(item, list) and len(item) == 2:
                            counts[item[0]] = int(item[1])
                    nets[net[0]] = counts

    for node in tree[1:]:
        if not isinstance(node, list):
            continue
        key = node[0]
        if key == "DURATION":
            doc["duration"] = int(node[1])
        elif key == "TIMESCALE":
            doc["timescale"] = " ".join(node[1:])
        elif key == "DESIGN":
            doc["design"] = str(node[1]).strip('"')
        elif key == "INSTANCE":
            # the design top: recurse with an empty prefix so instance
            # names in the doc match the profile names 1:1
            for child in node[2:]:
                if isinstance(child, list) and child[0] == "INSTANCE":
                    walk_instance(child, "")
                elif isinstance(child, list) and child[0] == "NET":
                    nets = doc["instances"].setdefault(
                        str(node[1]) if len(node) > 1 else "?", {}
                    )
                    for net in child[1:]:
                        counts = {}
                        for item in net[1:]:
                            if isinstance(item, list) and len(item) == 2:
                                counts[item[0]] = int(item[1])
                        nets[net[0]] = counts
    return doc


# ---------------------------------------------------------------------- VCD
def _vcd_id(i: int) -> str:
    """Short VCD identifier for wire i (printable ASCII 33..126)."""
    chars = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 94)
        chars = chr(33 + r) + chars
    return chars


def write_vcd(
    path: str,
    stream,
    *,
    inverts=None,
    name: str = "link",
    timescale: str = "1 ns",
) -> str:
    """Dump an actual (T, lanes) coded byte stream as a VCD waveform.

    One VCD time unit per flit row; every data bit is a 1-bit wire named
    ``lane<l>_b<b>`` (LSB first, matching the SAIF nets) and an optional
    (T, npart) ``inverts`` array adds the ``inv<p>`` aux wires.  Returns
    the text.
    """
    arr = _host(stream) & 0xFF
    if arr.ndim != 2:
        raise ValueError(f"stream must be (T, lanes), got {arr.shape}")
    t, lanes = arr.shape
    bits = ((arr[:, :, None] >> np.arange(8)) & 1).reshape(t, lanes * 8)
    if inverts is not None:
        inv = _host(inverts) & 1
        if inv.shape[0] != t:
            raise ValueError(
                f"inverts rows {inv.shape[0]} != stream rows {t}"
            )
        bits = np.concatenate([bits, inv], axis=1)
    nwires = bits.shape[1]
    ids = [_vcd_id(i) for i in range(nwires)]
    lines = [
        f"$timescale {timescale} $end",
        f"$scope module {_sanitize(name)} $end",
    ]
    for i in range(nwires):
        lines.append(f"$var wire 1 {ids[i]} {wire_name(i, lanes)} $end")
    lines += ["$upscope $end", "$enddefinitions $end", "#0", "$dumpvars"]
    for i in range(nwires):
        lines.append(f"{bits[0, i] if t else 0}{ids[i]}")
    lines.append("$end")
    for row in range(1, t):
        changed = np.nonzero(bits[row] != bits[row - 1])[0]
        if changed.size == 0:
            continue
        lines.append(f"#{row}")
        for i in changed:
            lines.append(f"{bits[row, i]}{ids[i]}")
    lines.append(f"#{t}")
    text = "\n".join(lines) + "\n"
    _ensure_parent(path)
    with open(path, "w") as f:
        f.write(text)
    return text
