"""Pareto analysis over area × BT-reduction × latency.

Counterpart of ``repro.dse.pareto`` (pure Python).

The paper's central result is a trade: the APP-PSU gives up 0.92 pp of BT
reduction (19.50 % vs 20.42 %) to buy a 35.4 % area reduction.  This module
generalizes that two-point comparison into proper dominance analysis:

  * an :class:`Objective` is a named value-to-MINIMIZE extracted from an
    :class:`~repro_torch.dse.evaluate.Evaluation` (maximized metrics are negated,
    as `bt_reduction` is in the defaults);
  * ``pareto_front`` keeps the non-dominated points — a point is dominated
    when some other point is no worse on every objective and strictly
    better on at least one;
  * ``knee_point`` picks the front's best-balanced point: objectives are
    normalized to [0, 1] over the front and the point closest (Euclidean)
    to the per-objective ideal wins.

Default objectives: sorting-unit area (um^2, down), BT reduction (up),
sort latency per window (ns, down).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

from .evaluate import Evaluation

__all__ = [
    "Objective",
    "DEFAULT_OBJECTIVES",
    "AREA_BT_OBJECTIVES",
    "AREA_BT_LATENCY_OBJECTIVES",
    "dominates",
    "pareto_front",
    "knee_point",
]


class Objective(NamedTuple):
    """A named scalar to minimize over evaluations."""

    name: str
    fn: Callable[[Evaluation], float]


DEFAULT_OBJECTIVES: tuple[Objective, ...] = (
    Objective("area_um2", lambda e: e.area_um2),
    Objective("neg_bt_reduction", lambda e: -e.bt_reduction),
    Objective("latency_ns", lambda e: e.latency_ns),
)

# The paper's Fig. 5 trade as a plane: area vs BT reduction only.  On the
# measured conv streams the knee of this front is the paper's own k=4
# choice (asserted in tests/test_dse.py).
AREA_BT_OBJECTIVES: tuple[Objective, ...] = DEFAULT_OBJECTIVES[:2]

# The fleet-scale plane (DESIGN.md §17): area vs BT reduction vs
# END-TO-END latency — sort window plus the point's NoC traversal under
# the wormhole/contention model (``Evaluation.total_latency_ns``).  For
# point-to-point designs it degrades gracefully to the sort latency, so
# mixed grids rank on one consistent axis; the knee on the reference
# fleet grid is pinned in tests/test_dse.py.
AREA_BT_LATENCY_OBJECTIVES: tuple[Objective, ...] = (
    *AREA_BT_OBJECTIVES,
    Objective("total_latency_ns", lambda e: e.total_latency_ns),
)


def _values(e: Evaluation, objectives: Sequence[Objective]) -> tuple[float, ...]:
    return tuple(float(obj.fn(e)) for obj in objectives)


def dominates(
    a: Evaluation,
    b: Evaluation,
    objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
) -> bool:
    """True when ``a`` is no worse than ``b`` everywhere and better somewhere."""
    va, vb = _values(a, objectives), _values(b, objectives)
    return all(x <= y for x, y in zip(va, vb)) and any(
        x < y for x, y in zip(va, vb)
    )


def pareto_front(
    evals: Sequence[Evaluation],
    objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
) -> tuple[Evaluation, ...]:
    """The non-dominated subset of ``evals``, in input order.

    Objective-value ties survive together (neither dominates the other), so
    duplicated design points stay on the front rather than being silently
    merged.
    """
    evals = tuple(evals)
    return tuple(
        e
        for e in evals
        if not any(dominates(o, e, objectives) for o in evals if o is not e)
    )


def knee_point(
    front: Sequence[Evaluation],
    objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
) -> Evaluation:
    """The front's best-balanced point: min normalized distance to the ideal.

    Each objective is scaled to [0, 1] over the front (constant objectives
    contribute 0); the ideal is the componentwise minimum.  Deterministic:
    ties resolve to the earliest point in ``front`` order.
    """
    front = tuple(front)
    if not front:
        raise ValueError("empty front")
    table = [_values(e, objectives) for e in front]
    lo = [min(col) for col in zip(*table)]
    hi = [max(col) for col in zip(*table)]
    span = [h - l if h > l else 1.0 for l, h in zip(lo, hi)]

    def dist(values: tuple[float, ...]) -> float:
        return sum(((v - l) / s) ** 2 for v, l, s in zip(values, lo, span))

    best = min(range(len(front)), key=lambda i: dist(table[i]))
    return front[best]
