"""The collective schedule of a smoke cell on a small mesh, two ways.

* The port's: ``repro_torch.launch.dryrun.placed_collectives``, the placed
  step, prefill or decode run on one device's ``meta`` blocks over
  stand-in groups of the mesh's sizes.
* The reference's: ``repro.roofline.collect_from_compiled`` of the cell
  jitted with the reference's shardings and compiled for as many forced
  host devices as the mesh has (in a subprocess: the device-count flag
  must not reach this one).

The mesh is ("data", "model") of ``--mesh`` (2 x 4 by default).  On 2 x 8
the smoke configs' 4 heads do not divide "model" while their ``d_model``
64 does, so attention splits on its contraction (``wq`` on its input
``d``, ``wo`` on its output ``d``).

Both read the same cell (``build_case`` with the smoke config's fields) and
print, per kind, the count and the result bytes of one device's
collectives, and the ring wire bytes.  GSPMD picks its own schedule, so the
two need not agree in kind or count.

    PYTHONPATH=src python experiments/tp_schedule.py [--arch internlm2-1.8b] [--shape train_4k ...]
    PYTHONPATH=src python experiments/tp_schedule.py --arch granite-moe-3b-a800m
    PYTHONPATH=src python experiments/tp_schedule.py --arch granite-moe-3b-a800m --mesh 2x8
    PYTHONPATH=src python experiments/tp_schedule.py --arch zamba2-1.2b --shape decode_32k long_500k
    PYTHONPATH=src python experiments/tp_schedule.py --arch whisper-medium \
        --shape decode_32k prefill_32k
    PYTHONPATH=src python experiments/tp_schedule.py --arch internvl2-26b --shape train_4k
    PYTHONPATH=src python experiments/tp_schedule.py --arch qwen3-moe-30b-a3b --shape train_4k

The last two are the FSDP train cells: the port all-gathers each data-split
leaf over "data" a layer at a time and reduce-scatters its gradient (its
microbatches' records carry their count as ``trip``); the reference's CPU
compile expresses the gradient's scatter as an all-reduce and a slice, so
its schedule has no reduce-scatter.

An encoder-decoder cell's frames come from ``build_case`` in both packages
(the stub frontend's 1,500 frames a request), so whisper-medium's smoke
overrides are passed as they are.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = """
    import json, sys
    import jax
    from repro.launch.specs import build_case
    from repro.roofline.collect import collect_from_compiled
    arch, shapes, over = sys.argv[1], sys.argv[2].split(","), json.loads(sys.argv[3])
    dims = tuple(json.loads(sys.argv[4]))
    if "moe" in over:
        from repro.models.config import MoEConfig
        over["moe"] = MoEConfig(**over["moe"])
    if "ssm" in over:
        from repro.models.config import SSMConfig
        over["ssm"] = SSMConfig(**over["ssm"])
    mesh = jax.make_mesh(dims, ("data", "model"))
    out = {}
    for shape in shapes:
        case = build_case(arch, shape, **over)
        in_sh, out_sh = case.shardings(mesh)
        with mesh:
            compiled = jax.jit(case.fn, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=case.donate).lower(*case.args).compile()
        rec = collect_from_compiled(arch=arch, shape=shape, kind=case.kind,
                                    mesh_desc="x".join(map(str, dims)),
                                    num_devices=dims[0] * dims[1], compiled=compiled, cfg=case.cfg)
        out[shape] = {"collectives": rec["collectives"], "wire": rec["wire_bytes_per_device"]}
    print(json.dumps(out))
"""


def smoke_overrides(arch: str) -> dict:
    from repro_torch.configs import get_config, smoke_config

    full, sm = get_config(arch), smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full, f.name)}


def port_schedule(arch: str, shape: str, over: dict, dims: tuple) -> dict:
    from repro_torch.launch import build_case, dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline import summarize_collectives, wire_bytes

    ops = dryrun.placed_collectives(build_case(arch, shape, **over),
                                    AbstractMesh(dims, ("data", "model")))
    return {"collectives": summarize_collectives(ops), "wire": wire_bytes(ops)}


def reference_schedule(arch: str, shapes: list[str], over: dict, dims: tuple) -> dict:
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={dims[0] * dims[1]}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), arch,
                          ",".join(shapes), json.dumps(over, default=dataclasses.asdict),
                          json.dumps(dims)],
                         capture_output=True, text=True, env=env, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--shape", nargs="+", default=["train_4k", "prefill_32k", "decode_32k"])
    ap.add_argument("--mesh", default="2x4", help="the (data, model) mesh, as DxM")
    args = ap.parse_args()
    dims = tuple(int(x) for x in args.mesh.split("x"))
    over = smoke_overrides(args.arch)
    ref = reference_schedule(args.arch, args.shape, over, dims)
    for shape in args.shape:
        port = port_schedule(args.arch, shape, over, dims)
        for who, rec in (("port", port), ("reference", ref[shape])):
            kinds = ", ".join(f"{k} {v['count']} x / {v['bytes']} B"
                              for k, v in sorted(rec["collectives"].items()))
            print(f"{args.arch} (smoke) x {shape} [{args.mesh}] {who}: {kinds}; wire "
                  f"{rec['wire']:.0f} B/device")


if __name__ == "__main__":
    main()
