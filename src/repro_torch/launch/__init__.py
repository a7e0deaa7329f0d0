# Launch layer (counterpart of repro.launch): meshes, sharding rules,
# dry-run cases, the rule-placed train step (step.py) with its
# tensor-parallel "model" axis (tp.py, tp_model.py), placed serving
# (serve.py), the GPipe pipeline (pipeline.py) and the meta-tensor dry run
# (dryrun.py).
from .mesh import axis_size, dp_axes, make_production_mesh, make_smoke_mesh
from .sharding import (
    batch_shardings,
    cache_shardings,
    opt_shardings,
    param_spec,
    params_shardings,
)
from .specs import DryrunCase, build_case

__all__ = [
    "make_production_mesh",
    "make_smoke_mesh",
    "dp_axes",
    "axis_size",
    "param_spec",
    "params_shardings",
    "opt_shardings",
    "batch_shardings",
    "cache_shardings",
    "build_case",
    "DryrunCase",
]
