# The design-space exploration subsystem (counterpart of repro.dse,
# DESIGN.md §10): the paper evaluates two points (ACC, APP k=4); this layer
# maps the whole space.
#   space.py    - DesignPoint (family/N/W/k/ordering/topology) + grids
#   evaluate.py - grid x workload -> joined BT/area/timing/power records;
#                 every stream, NoC route link and (ordering, codec) config
#                 rides ONE repro_torch.kernels.bt_count_axes call per key
#                 width; grid_launch_count reads the bt_axes launch counter
#   pareto.py   - dominance filtering + knee selection over
#                 area x BT-reduction x latency
#   report.py   - JSON / CSV artifacts
from .evaluate import Evaluation, Workload, evaluate_grid, grid_launch_count
from .pareto import (
    AREA_BT_LATENCY_OBJECTIVES,
    AREA_BT_OBJECTIVES,
    DEFAULT_OBJECTIVES,
    Objective,
    dominates,
    knee_point,
    pareto_front,
)
from .report import point_record, to_records, write_csv, write_json
from .space import (
    FAMILIES,
    ORDERINGS,
    DesignPoint,
    area_reduction,
    expand_grid,
    k_sweep,
    parse_topology,
    topology_route_hops,
)

__all__ = [
    "DesignPoint",
    "FAMILIES",
    "ORDERINGS",
    "expand_grid",
    "k_sweep",
    "area_reduction",
    "Workload",
    "Evaluation",
    "evaluate_grid",
    "grid_launch_count",
    "parse_topology",
    "topology_route_hops",
    "Objective",
    "DEFAULT_OBJECTIVES",
    "AREA_BT_OBJECTIVES",
    "AREA_BT_LATENCY_OBJECTIVES",
    "dominates",
    "pareto_front",
    "knee_point",
    "point_record",
    "to_records",
    "write_json",
    "write_csv",
]
