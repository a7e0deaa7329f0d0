"""Multi-pod dry run on meta tensors (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles every (architecture x input-shape) cell
on 512 forced host devices and reads XLA's memory and cost analyses and
its collective schedule.  torch has no counterpart of that compile, so the
port's dry run is a meta-tensor sweep: for each cell on the production
mesh (16x16, or 2x16x16 with ``--multipod``) it records

  * the per-device bytes of the step's arguments under the sharding rules
    (each leaf's bytes over the product of the axes its spec splits);
  * the step's global FLOPs, counted by ``FlopCounterMode`` while the
    port's own step (train step, prefill or decode) runs on ``meta``
    tensors, and an even split of them per device;
  * ``model_flops_global`` (``repro_torch.roofline``).

  * for the dense, vlm, MoE, ssm, hybrid and encoder-decoder families, the
    collectives one device issues: the cell's placed step (``launch/step.py``'s
    ``reduce_gradients`` and ZeRO-1's gathers) or placed prefill / decode
    (``launch/serve.py``) runs on the ``meta`` blocks of rank 0 over
    stand-in groups of the mesh's sizes (``launch/tp.py``: recorded, not
    issued), so ``collective_ops`` holds the port's own schedule and the
    roofline its collective term (``"collectives_modelled": True``).  The
    train step is not microbatched there: a microbatched step sends the
    same bytes in more calls.

The dense and MoE cells include those whose rules split attention's
contraction (granite-moe-3b-a800m's 24 heads on the 16 x 16 mesh); the
ssm and hybrid cells (mamba2-370m, zamba2-1.2b) split the SSD projections
on their contraction and the SSM heads over "model", and ``long_500k``'s
one request splits zamba2's KV sequence over "data" (SP: its decode merges
attention over the data ranks); whisper-medium's cells split the encoder's
and the decoder's self- and cross-attention on heads, its prefill encoding
the frames and its decode reading the cross cache on the rank's kv heads;
internvl2-26b's serving cells run the dense family's splits behind its
1,024 patch embeddings, which its prefill puts in front of the text.  The
placed step's FSDP gathers are not built yet (a train cell of an FSDP
config, internvl2-26b's and qwen3-moe-30b-a3b's; their serving cells are
not FSDP-placed, as ``param_spec`` applies FSDP in "train" mode only):
those records say ``"collectives_modelled": False``, with the reason, and
carry no collective ops.  The memory floor is the argument bytes alone
(activations are not counted).  The stand-in groups need no process group:
torch's ``fake`` backend would build a 256-rank ``DeviceMesh`` in one
process, but it lives in ``torch.testing._internal``, a private module
whose presence on the card's torch nothing here checks, while the
operators' own record needs nothing beyond the port.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

__all__ = ["run_cell", "argument_bytes_per_device", "placed_collectives", "collectives_reason",
           "main"]


def _split(spec, axes: dict) -> int:
    from .sharding import spec_axes

    return math.prod(axes[a] for a in spec_axes(spec))


def argument_bytes_per_device(args, shardings, mesh) -> int:
    """Bytes of every argument leaf on one device under ``shardings``
    (trees of ``NamedSharding`` matching ``args``)."""
    from .._tree import leaves
    from .mesh import mesh_axes

    axes = mesh_axes(mesh)
    total = 0
    for tree, sh in zip(args, shardings):
        for t, s in zip(leaves(tree), leaves(sh)):
            total += t.numel() * t.element_size() // _split(s.spec, axes)
    return total


def placed_collectives(case, mesh) -> list[dict]:
    """The collectives one device of ``mesh`` (a production ``AbstractMesh``)
    issues in the placed counterpart of ``case``, a dense, vlm, MoE, ssm,
    hybrid or encoder-decoder cell: recorded
    while it runs on rank 0's ``meta`` blocks over stand-in groups."""
    from .. import _collectives
    from .._tree import leaves, tree_map
    from ..optim import AdamWConfig
    from ..roofline.collect import record_collectives
    from . import serve, tp_model
    from .step import block, reduce_gradients, zero1_gather
    from .tp import axis_group

    cfg, s = case.cfg, case.shape
    in_sh, _ = case.shardings(mesh)
    args = tree_map(block, case.args, in_sh)
    with record_collectives() as ops:
        if case.kind == "train":
            params, opt_state, batch = args
            dp = in_sh[2]["labels"].spec[0] or ()
            reduce_gradients(cfg, AdamWConfig(total_steps=10_000),
                             tp_model.make_plan(cfg, mesh, "train"),
                             axis_group(mesh, dp if isinstance(dp, tuple) else (dp,)), params,
                             batch, opt_state.step)
            for p, ps, ms in zip(leaves(params), leaves(in_sh[0]), leaves(in_sh[1].m)):
                gathered = zero1_gather(p, ps.placements(), ms.placements(), mesh)
                if gathered:
                    _collectives.note("all-gather", gathered[0], size=gathered[1])
        else:
            plan = tp_model.make_plan(cfg, mesh, "serve")
            mode = serve.kv_mode(cfg, mesh, s.global_batch, s.seq_len)
            sp = serve.sp_group(cfg, mesh, s.global_batch, s.seq_len)
            if case.kind == "prefill":
                serve.prefill(args[0], plan, args[1]["tokens"], s.seq_len, mode, sp,
                              args[1].get("frames"), args[1].get("patches"))
            else:
                serve.decode_step(args[0], plan, args[1], args[2], mode, sp)
    return ops


def collectives_reason(case, mesh) -> str | None:
    """Why the placed schedule of ``case`` on ``mesh`` is not modelled, or
    None: the rules' splits the tensor-parallel forward does not run, or
    the FSDP placement of a train cell (``param_spec`` places an FSDP
    config's serving cells as any other)."""
    from .tp_model import unsupported

    cfg = case.cfg
    train = case.kind == "train"
    return (unsupported(cfg, mesh, "train" if train else "serve")
            or (f"{cfg.name}: FSDP placement is not run by the placed step's dry run"
                if cfg.fsdp and train else None))


def _collective_fields(case, mesh) -> dict:
    """The record's collective keys: the placed schedule of a cell the
    tensor-parallel forward runs, else none, with the reason."""
    from ..roofline.collect import summarize_collectives

    reason = collectives_reason(case, mesh)
    if reason:
        return {"collectives": {}, "collective_ops": [], "collectives_modelled": False,
                "collectives_reason": reason}
    ops = placed_collectives(case, mesh)
    return {"collectives": summarize_collectives(ops), "collective_ops": ops,
            "collectives_modelled": True,
            "collective_source": "the port's placed step / prefill / decode on meta blocks "
                                 "over stand-in groups (launch/tp.py)"}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    verbose: bool = True,
    cfg_overrides: dict | None = None,
    mesh_shape: tuple[int, int] | None = None,  # logical remesh of the pod
) -> dict:
    """The meta-tensor dry run of one cell: per-device argument bytes under
    the rules, the step's FLOPs and the model FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..configs import arch_shapes
    from ..roofline.analysis import model_flops_global
    from ..roofline.collect import wire_bytes
    from .mesh import AbstractMesh
    from .specs import build_case

    mesh_desc = "2x16x16" if multi_pod else "16x16"
    if shape_name not in arch_shapes(arch):
        return {"arch": arch, "shape": shape_name, "status": "skipped", "mesh": mesh_desc,
                "reason": "long_500k skipped for full-attention archs (DESIGN.md §4)"}
    if mesh_shape is not None:
        mesh = AbstractMesh(tuple(mesh_shape), ("data", "model"))
        mesh_desc = f"{mesh_shape[0]}x{mesh_shape[1]}"
    elif multi_pod:
        mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    else:
        mesh = AbstractMesh((16, 16), ("data", "model"))

    t0 = time.monotonic()
    case = build_case(arch, shape_name, **(cfg_overrides or {}))
    in_sh, _ = case.shardings(mesh)
    arg_bytes = argument_bytes_per_device(case.args, in_sh, mesh)
    with FlopCounterMode(display=False) as counter:
        case.fn(*case.args)
    flops = float(counter.get_total_flops())
    shape = case.shape
    rec = {
        "arch": arch, "shape": shape_name, "kind": case.kind, "mesh": mesh_desc,
        "num_devices": mesh.size, "status": "ok",
        "argument_bytes_per_device": int(arg_bytes),
        "peak_bytes_per_device": int(arg_bytes),
        "peak_source": "argument bytes under the sharding rules (activations not counted)",
        "global_flops": flops,
        "hlo_flops_per_device": flops / mesh.size,
        "cost_source": "torch.FlopCounterMode on meta tensors, split evenly per device",
        "params": int(case.cfg.param_count()),
        "active_params": int(case.cfg.active_param_count()),
    }
    rec.update(_collective_fields(case, mesh))
    rec["model_flops_global"] = model_flops_global(rec, shape.seq_len, shape.global_batch,
                                                   case.cfg)
    rec["seconds"] = round(time.monotonic() - t0, 2)
    if verbose:
        print(f"--- {arch} x {shape_name} [{mesh_desc}] {rec['kind']}")
        print(f"    argument bytes/device {arg_bytes / 2**30:.3f} GiB; FLOPs global "
              f"{flops:.4e} (model {rec['model_flops_global']:.4e}, ratio "
              f"{rec['model_flops_global'] / flops if flops else 0:.3f}); {rec['seconds']} s")
        if rec["collectives_modelled"]:
            print(f"    collectives/device {rec['collectives']}; wire "
                  f"{wire_bytes(rec['collective_ops']) / 2**30:.3f} GiB")
        else:
            print(f"    collectives not modelled: {rec['collectives_reason']}")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON records")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--profile", choices=["baseline", "optimized"], default="baseline",
                    help="optimized = the reference's §Perf profiles")
    args = ap.parse_args()

    from ..configs import all_cells
    from . import specs

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multipod] if not args.both_meshes else [False, True]
    failures = 0
    for multi in meshes:
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}"
            out_path = os.path.join(args.out, tag + ".json") if args.out else None
            if out_path and args.skip_existing and os.path.exists(out_path):
                print(f"skip existing {tag}")
                continue
            try:
                over, mesh_shape = None, None
                if args.profile == "optimized":
                    over, mesh_shape, mb = specs.OPTIMIZED_PROFILES.get(
                        (arch, shape), ({}, None, None))
                    if mb:
                        specs.TRAIN_MICROBATCHES[arch] = mb
                    if multi:
                        mesh_shape = None  # remeshes are single-pod profiles
                rec = run_cell(arch, shape, multi, cfg_overrides=over, mesh_shape=mesh_shape)
            except Exception as e:  # a failing cell is a bug: record + count
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if multi else "16x16",
                       "status": "failed", "error": f"{type(e).__name__}: {e}"}
                failures += 1
            if out_path:
                os.makedirs(args.out, exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
