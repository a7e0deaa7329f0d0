"""`DesignPoint` — one sorting-unit configuration, and grids of them.

Counterpart of ``repro.dse.space``; its deferred imports reach the port's
``noc`` and ``codec``.

The paper evaluates exactly two points of a large design space: the precise
ACC-PSU and the k=4 APP-PSU, at sort widths 25 and 49 (Fig. 5, Table I).
A :class:`DesignPoint` names any point of that space —

  * ``family``    — the sorting-hardware family: the paper's comparison-free
    PSU, or the Fig. 5 comparator baselines (Batcher bitonic, CSN);
  * ``n``         — hardware sort-window size N (area/timing scale with it);
  * ``width``     — element bit width W of the sort keys;
  * ``k``         — APP bucket count, or ``None`` for precise;
  * ``ordering``  — what the transmitted stream actually does: 'acc', 'app',
    or the data-independent baselines 'none' / 'column_major' (which have
    NO sorting hardware: zero area, zero sort latency);
  * ``descending``— sort direction of the transmit order;
  * ``codec``     — optional ``repro_torch.codec`` wire codec at the link
    egress ('bus_invert', 'gray', ...; None = uncoded) — the
    coding-vs-ordering axis, measured net of invert-line overhead and
    encoder area (DESIGN.md §11);
  * ``topology``  — optional NoC fabric ('mesh4x4', 'torus4x4', 'ring8',
    ...) on which the point is additionally evaluated per link.

— and `expand_grid` / `k_sweep` enumerate deterministic grids of valid
points for `repro_torch.dse.evaluate.evaluate_grid`.
"""

from __future__ import annotations

import dataclasses
import functools
import re

from ..core.area import (
    PSUArea,
    PSUTiming,
    bitonic_area,
    bitonic_timing,
    csn_area,
    psu_area,
    psu_timing,
)
from ..kernels import CodecVariant, Variant

__all__ = [
    "DesignPoint",
    "FAMILIES",
    "ORDERINGS",
    "expand_grid",
    "k_sweep",
    "area_reduction",
    "parse_topology",
    "topology_route_hops",
]

FAMILIES = ("psu", "bitonic", "csn")
ORDERINGS = ("none", "column_major", "acc", "app")

# the one home of the topology-name grammar: DesignPoint validation and
# parse_topology both use it, so they cannot drift
_TOPOLOGY_RE = re.compile(r"^(mesh|torus)(\d+)x(\d+)$|^ring(\d+)$")


def parse_topology(name: str):
    """'mesh4x4' | 'torus2x3' | 'ring8' -> a ``repro_torch.noc`` Topology."""
    m = _TOPOLOGY_RE.match(name)
    if m is None:
        raise ValueError(
            f"topology {name!r} does not match "
            "'mesh<R>x<C>' | 'torus<R>x<C>' | 'ring<N>'"
        )
    from ..noc import mesh, ring, torus  # deferred: keep space.py light

    if m.group(4) is not None:
        return ring(int(m.group(4)))
    builder = mesh if m.group(1) == "mesh" else torus
    return builder(int(m.group(2)), int(m.group(3)))


@functools.lru_cache(maxsize=None)
def topology_route_hops(name: str) -> int:
    """Hop count of a topology's DSE evaluation route: router 0 to the
    farthest router under XY routing — the one home of the 'how long is
    the fabric' question (``dse.evaluate``'s measurement row scaling AND
    the wormhole latency objective both read it)."""
    from ..noc import hop_count  # deferred: keep space.py light

    topo = parse_topology(name)
    return max(hop_count(topo, 0, r) for r in range(topo.num_routers))


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One sorting-unit configuration in the explored design space."""

    family: str = "psu"
    n: int = 25
    width: int = 8
    k: int | None = 4
    ordering: str = "app"
    descending: bool = False
    codec: str | None = None
    topology: str | None = None

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown family {self.family!r}; choose from {FAMILIES}"
            )
        if self.ordering not in ORDERINGS:
            raise ValueError(
                f"unknown ordering {self.ordering!r}; choose from {ORDERINGS}"
            )
        if self.n < 1 or self.width < 1:
            raise ValueError(f"need n >= 1 and width >= 1, got {self}")
        if self.ordering == "app":
            if self.k is None or not 1 <= self.k <= self.width + 1:
                raise ValueError(
                    f"'app' needs k in [1, {self.width + 1}], got k={self.k}"
                )
            if self.family != "psu":
                raise ValueError(
                    "coarse buckets are the PSU's trick: 'app' ordering "
                    f"requires family 'psu', got {self.family!r}"
                )
        elif self.k is not None:
            raise ValueError(
                f"k is only meaningful for 'app' ordering, got {self}"
            )
        if self.ordering in ("none", "column_major"):
            if self.family != "psu":
                raise ValueError(
                    f"{self.ordering!r} has no sorting hardware; use the "
                    "default family 'psu'"
                )
            if self.descending:
                raise ValueError(
                    f"descending is meaningless for {self.ordering!r}"
                )
        if self.codec is not None:
            from ..codec.schemes import CODECS  # deferred: keep space light

            if self.codec not in CODECS:
                raise ValueError(
                    f"unknown codec {self.codec!r}; registered codecs: "
                    f"{', '.join(sorted(CODECS))}"
                )
        if self.topology is not None and not _TOPOLOGY_RE.match(self.topology):
            raise ValueError(
                f"topology {self.topology!r} does not match "
                "'mesh<R>x<C>' | 'torus<R>x<C>' | 'ring<N>'"
            )

    # ------------------------------------------------------------ derived
    @property
    def label(self) -> str:
        """Compact report name, e.g. ``app-k4@N25`` or
        ``acc+bus_invert@N25``."""
        if self.ordering == "app":
            head = f"app-k{self.k}"
        elif self.family != "psu":
            head = self.family
        else:
            head = self.ordering
        tail = "-desc" if self.descending else ""
        coded = f"+{self.codec}" if self.codec else ""
        noc = f"/{self.topology}" if self.topology else ""
        return f"{head}{tail}{coded}@N{self.n}{noc}"

    @property
    def variant(self) -> Variant:
        """The stream-measurement variant for the batched BT kernel."""
        return Variant(self.ordering, self.k, self.descending)

    @property
    def codec_variant(self) -> CodecVariant:
        """The (ordering, codec) config for the single-launch codec-BT
        kernel (``repro_torch.kernels.bt_count_codecs``)."""
        if self.codec is None:
            scheme, partition = "none", None
        else:
            from ..codec.schemes import codec_by_name  # deferred

            c = codec_by_name(self.codec)
            scheme, partition = c.scheme, c.partition
        return CodecVariant(
            self.ordering, self.k, self.descending, scheme, partition
        )

    def area(self) -> PSUArea:
        """Modeled area of this point's sorting unit (um^2, DESIGN.md §6)."""
        if self.ordering in ("none", "column_major"):
            return PSUArea(popcount=0.0, sort=0.0)  # no sorting hardware
        if self.family == "bitonic":
            return bitonic_area(self.n, self.width)
        if self.family == "csn":
            return csn_area(self.n, self.width)
        return psu_area(self.n, self.width, self.k)

    def noc_hops(self) -> int | None:
        """Hops of this point's NoC evaluation route (None off-fabric)."""
        if self.topology is None:
            return None
        return topology_route_hops(self.topology)

    def timing(self) -> PSUTiming:
        """Pipelined sort timing at the paper's 500 MHz clock."""
        if self.ordering in ("none", "column_major"):
            # pass-through: no sort stage in the transmit path
            return PSUTiming(
                latency_cycles=0, throughput_elems_per_cycle=float("inf")
            )
        if self.family in ("bitonic", "csn"):
            return bitonic_timing(self.n)
        return psu_timing(self.n, self.width, self.k)


def area_reduction(point: DesignPoint) -> float:
    """Fractional area reduction vs the precise ACC-PSU at the same (N, W).

    The paper's headline comparison (APP k=4 @ N=25: 35.4 %), generalized to
    any point; negative for designs larger than the ACC-PSU (bitonic, CSN).
    """
    base = psu_area(point.n, point.width).total
    return 1.0 - point.area().total / base


def expand_grid(
    *,
    families: tuple[str, ...] = ("psu",),
    ns: tuple[int, ...] = (25,),
    widths: tuple[int, ...] = (8,),
    ks: tuple[int, ...] = (2, 4, 8),
    orderings: tuple[str, ...] = ("none", "acc", "app"),
    descendings: tuple[bool, ...] = (False,),
    codecs: tuple[str | None, ...] = (None,),
    topologies: tuple[str | None, ...] = (None,),
) -> tuple[DesignPoint, ...]:
    """Deterministic expansion of a design grid into valid points.

    Invalid combinations are skipped rather than raised (an 'app' ordering
    expands once per bucket count in ``ks``; every other ordering ignores
    ``ks``; comparator families pair only with 'acc'; the data-independent
    orderings carry no hardware so only family 'psu' and ascending order).
    Every point additionally expands over ``codecs`` (None = uncoded wire,
    or registered ``repro_torch.codec`` names — the coding-vs-ordering axis).
    Duplicates are dropped, first occurrence wins — the output order is a
    pure function of the argument order.
    """
    points: list[DesignPoint] = []
    seen: set[DesignPoint] = set()
    for topo in topologies:
        for family in families:
            for n in ns:
                for width in widths:
                    for ordering in orderings:
                        if family != "psu" and ordering != "acc":
                            continue
                        k_axis: tuple[int | None, ...]
                        if ordering == "app":
                            k_axis = tuple(k for k in ks if 1 <= k <= width + 1)
                        else:
                            k_axis = (None,)
                        for k in k_axis:
                            for desc in descendings:
                                if desc and ordering in ("none", "column_major"):
                                    continue
                                for codec in codecs:
                                    pt = DesignPoint(
                                        family=family,
                                        n=n,
                                        width=width,
                                        k=k,
                                        ordering=ordering,
                                        descending=desc,
                                        codec=codec,
                                        topology=topo,
                                    )
                                    if pt not in seen:
                                        seen.add(pt)
                                        points.append(pt)
    return tuple(points)


def k_sweep(
    n: int = 25,
    width: int = 8,
    ks: tuple[int, ...] = (2, 4, 8),
    *,
    include_baseline: bool = True,
    include_precise: bool = True,
    topology: str | None = None,
) -> tuple[DesignPoint, ...]:
    """The paper's k axis: unsorted baseline, precise ACC, and APP per k.

    This is the sweep `benchmarks/fig5_area.py` (area side) and
    `benchmarks/table1_bt.py` (BT side) ran ad hoc; `repro_torch.dse` is its one
    home in the port.
    """
    points: list[DesignPoint] = []
    if include_baseline:
        points.append(
            DesignPoint(n=n, width=width, k=None, ordering="none", topology=topology)
        )
    if include_precise:
        points.append(
            DesignPoint(n=n, width=width, k=None, ordering="acc", topology=topology)
        )
    points.extend(
        DesignPoint(n=n, width=width, k=k, ordering="app", topology=topology)
        for k in ks
    )
    return tuple(points)
