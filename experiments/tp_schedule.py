"""The collective schedule of a dense or MoE smoke cell on a 2 x 4 mesh, two ways.

* The port's: ``repro_torch.launch.dryrun.placed_collectives``, the placed
  step, prefill or decode run on one device's ``meta`` blocks over
  stand-in groups of the mesh's sizes.
* The reference's: ``repro.roofline.collect_from_compiled`` of the cell
  jitted with the reference's shardings and compiled for 8 forced host
  devices (in a subprocess: the device-count flag must not reach this one).

Both read the same cell (``build_case`` with the smoke config's fields) and
print, per kind, the count and the result bytes of one device's
collectives, and the ring wire bytes.  GSPMD picks its own schedule, so the
two need not agree in kind or count.

    PYTHONPATH=src python experiments/tp_schedule.py [--arch internlm2-1.8b] [--shape train_4k ...]
    PYTHONPATH=src python experiments/tp_schedule.py --arch granite-moe-3b-a800m
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
    if "moe" in over:
        from repro.models.config import MoEConfig
        over["moe"] = MoEConfig(**over["moe"])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for shape in shapes:
        case = build_case(arch, shape, **over)
        in_sh, out_sh = case.shardings(mesh)
        with mesh:
            compiled = jax.jit(case.fn, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=case.donate).lower(*case.args).compile()
        rec = collect_from_compiled(arch=arch, shape=shape, kind=case.kind, mesh_desc="2x4",
                                    num_devices=8, compiled=compiled, cfg=case.cfg)
        out[shape] = {"collectives": rec["collectives"], "wire": rec["wire_bytes_per_device"]}
    print(json.dumps(out))
"""


def smoke_overrides(arch: str) -> dict:
    from repro_torch.configs import get_config, smoke_config

    full, sm = get_config(arch), smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full, f.name)}


def port_schedule(arch: str, shape: str, over: dict) -> dict:
    from repro_torch.launch import build_case, dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline import summarize_collectives, wire_bytes

    ops = dryrun.placed_collectives(build_case(arch, shape, **over),
                                    AbstractMesh((2, 4), ("data", "model")))
    return {"collectives": summarize_collectives(ops), "wire": wire_bytes(ops)}


def reference_schedule(arch: str, shapes: list[str], over: dict) -> dict:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), arch,
                          ",".join(shapes), json.dumps(over, default=dataclasses.asdict)],
                         capture_output=True, text=True, env=env, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--shape", nargs="+", default=["train_4k", "prefill_32k", "decode_32k"])
    args = ap.parse_args()
    over = smoke_overrides(args.arch)
    ref = reference_schedule(args.arch, args.shape, over)
    for shape in args.shape:
        port = port_schedule(args.arch, shape, over)
        for who, rec in (("port", port), ("reference", ref[shape])):
            kinds = ", ".join(f"{k} {v['count']} x / {v['bytes']} B"
                              for k, v in sorted(rec["collectives"].items()))
            print(f"{args.arch} (smoke) x {shape} [2x4] {who}: {kinds}; wire "
                  f"{rec['wire']:.0f} B/device")


if __name__ == "__main__":
    main()
