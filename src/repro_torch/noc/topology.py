"""NoC topologies: routers, directed links and coordinate maps.

Counterpart of ``repro.noc.topology``, copied (it is pure Python, but the
reference package loads JAX on import).

A topology is a grid of routers (``rows`` x ``cols``) plus a table of
*directed* links — each physical channel direction is its own link, because
bit transitions (and therefore switching power) are accounted per driven
wire.  Three families cover the paper's §V NoC setting and the companion
work's evaluation fabrics (arXiv:2509.00500):

  * ``mesh(rows, cols)``  — 2D mesh, no wraparound,
  * ``torus(rows, cols)`` — 2D torus (wraparound both dimensions),
  * ``ring(n)``           — a cycle; represented as a 1 x n torus so the
    routing layer treats all three uniformly (dimension-order steps with a
    shortest-wrap direction choice).

Link ids are stable, dense ints in builder order — the NoC simulator uses
them as rows of the batched BT measurement's (links, flits, lanes) tensor.
"""

from __future__ import annotations

import dataclasses
import functools

__all__ = ["Topology", "mesh", "torus", "ring"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A router grid plus its directed link table.

    ``wrap`` distinguishes torus/ring (shortest-direction wraparound steps)
    from mesh (monotone steps only).
    """

    kind: str  # 'mesh' | 'torus' | 'ring'
    rows: int
    cols: int
    wrap: bool
    links: tuple[tuple[int, int], ...]  # directed (src, dst) router pairs

    @property
    def num_routers(self) -> int:
        return self.rows * self.cols

    @property
    def num_links(self) -> int:
        return len(self.links)

    def coords(self, router: int) -> tuple[int, int]:
        """(row, col) of a router id."""
        if not 0 <= router < self.num_routers:
            raise ValueError(f"router {router} outside 0..{self.num_routers - 1}")
        return divmod(router, self.cols)

    def router(self, row: int, col: int) -> int:
        """Router id at (row, col); wraps for torus/ring coordinates."""
        if self.wrap:
            row, col = row % self.rows, col % self.cols
        if not (0 <= row < self.rows and 0 <= col < self.cols):
            raise ValueError(f"({row}, {col}) outside {self.rows}x{self.cols} grid")
        return row * self.cols + col

    @functools.cached_property
    def _link_ids(self) -> dict[tuple[int, int], int]:
        return {pair: i for i, pair in enumerate(self.links)}

    def link_id(self, src: int, dst: int) -> int:
        """Dense id of the directed link src -> dst."""
        lid = self._link_ids.get((src, dst))
        if lid is None:
            raise ValueError(f"no link {src} -> {dst} in {self.kind} topology")
        return lid

    def row_routers(self, row: int) -> tuple[int, ...]:
        """All routers in one grid row (the weight-broadcast multicast set)."""
        return tuple(row * self.cols + c for c in range(self.cols))

    def column_routers(self, col: int) -> tuple[int, ...]:
        """All routers in one grid column (a shard's PE placement in the
        fleet decode workload, ``noc.adapters.fleet_decode_flows``)."""
        if not 0 <= col < self.cols:
            raise ValueError(f"column {col} outside 0..{self.cols - 1}")
        return tuple(r * self.cols + col for r in range(self.rows))

    @functools.cached_property
    def link_table(self):
        """The directed link endpoints as one (num_links, 2) int32 numpy
        array — the O(1)-per-lookup form the fleet-scale report builders
        index instead of unpacking ``links`` tuples link by link."""
        import numpy as np

        if not self.links:
            return np.zeros((0, 2), np.int32)
        return np.asarray(self.links, np.int32)


def _grid_links(rows: int, cols: int, wrap: bool) -> tuple[tuple[int, int], ...]:
    """Directed neighbor links in deterministic (router, +col, -col, +row,
    -row) order; wraparound duplicates (2-cycles on 2-long wrapped dims)
    are deduplicated."""
    links: dict[tuple[int, int], None] = {}
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            steps = []
            if cols > 1:
                if c + 1 < cols:
                    steps.append((r, c + 1))
                elif wrap:
                    steps.append((r, 0))
                if c - 1 >= 0:
                    steps.append((r, c - 1))
                elif wrap:
                    steps.append((r, cols - 1))
            if rows > 1:
                if r + 1 < rows:
                    steps.append((r + 1, c))
                elif wrap:
                    steps.append((0, c))
                if r - 1 >= 0:
                    steps.append((r - 1, c))
                elif wrap:
                    steps.append((rows - 1, c))
            for rr, cc in steps:
                links.setdefault((u, rr * cols + cc), None)
    return tuple(links)


def mesh(rows: int, cols: int) -> Topology:
    """2D mesh: 2*(rows*(cols-1) + cols*(rows-1)) directed links."""
    if rows < 1 or cols < 1 or rows * cols < 2:
        raise ValueError(f"mesh needs >= 2 routers, got {rows}x{cols}")
    return Topology("mesh", rows, cols, False, _grid_links(rows, cols, False))


def torus(rows: int, cols: int) -> Topology:
    """2D torus: wraparound in both dimensions."""
    if rows < 2 or cols < 2:
        raise ValueError(f"torus needs both dims >= 2, got {rows}x{cols}")
    return Topology("torus", rows, cols, True, _grid_links(rows, cols, True))


def ring(n: int) -> Topology:
    """n-router cycle (a 1 x n torus; both directions are present)."""
    if n < 3:
        raise ValueError(f"ring needs >= 3 routers, got {n}")
    return Topology("ring", 1, n, True, _grid_links(1, n, True))
