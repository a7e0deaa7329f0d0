"""How far mamba2-370m's placed float32 gradient lies from the one-process one.

Two gloo processes sharing one GPU run two placed float32 steps of
mamba2-370m at full width on a (1, 2) mesh (``launch/step.py``: the SSD
block split on its heads over "model"), 4 x 256 tokens of ``train()``'s
batches, each saving its gradient blocks and, after the first step, its
parameter blocks.  This process then takes the one-process gradient
(``train.step.value_and_grad``) at the same parameters before each step
and prints the largest difference of each leaf relative to its largest
element, beside the same figure between two one-process gradients that
differ only in the GEMM library (cuBLAS against cuBLASLt): the float32
noise floor of this backward.

    python experiments/ssd_grad_floor.py            # one CUDA device
    DEVICE=cpu python experiments/ssd_grad_floor.py  # smoke size, no floor

Writes its blocks under ``build/ssd_grad_floor/``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "ssd_grad_floor"
DEVICE = os.environ.get("DEVICE", "cuda")
FULL = DEVICE == "cuda"
ARCH, STEPS = "mamba2-370m", 2


def _setup():
    cfg = cs._ssd_cfg(ARCH, FULL, dtype="float32")
    tf = dict(cs.TRAIN_FULL) if FULL else dict(cs.TRAIN_FULL, seq_len=64, global_batch=4)
    data = cs.SyntheticLMDataset(cs.DataConfig(vocab=cfg.vocab, seq_len=tf["seq_len"],
                                               global_batch=tf["global_batch"], seed=tf["seed"]))
    return cfg, tf, data


def rank_main(rank: int, world: int, port: int) -> None:
    """One rank: build its placed state in turn, run STEPS placed steps,
    save its gradient blocks and its parameter blocks after step 0."""
    import torch.distributed as dist

    from repro_torch import _obs_hooks
    from repro_torch.launch.step import make_placed_train_step, place_state

    dev = torch.device(DEVICE)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = cs.launch.make_smoke_mesh(device=dev.type)
    cfg, tf, data = _setup()
    for turn in range(world):
        if turn == rank:
            host = cs.tree_map(lambda t: t.cpu(), cs.init_params(
                cfg, torch.Generator(device=dev).manual_seed(tf["seed"]), dev))
            params = cs._to_card(host, dev)
            del host
            p, o = place_state(cfg, mesh, params)
            del params
        dist.barrier()
    step = make_placed_train_step(cfg, cs.optim.AdamWConfig(warmup_steps=1, total_steps=10),
                                  mesh)
    grads, losses = [], []
    _obs_hooks.TAP = SimpleNamespace(tap=lambda kind, payload: grads.append(
        [g.detach().cpu().clone() for g in cs.tree_leaves(payload["grads"])]))
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.global_batch(i).items()}
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        if i == 0:  # the local blocks: a DTensor gather over gloo is not needed here
            torch.save([x.to_local().cpu() for x in cs.tree_leaves(p)],
                       OUT / f"params1_rank{rank}.pt")
    torch.save({"grads": grads, "losses": losses}, OUT / f"grads_rank{rank}.pt")
    dist.destroy_process_group()


def _worst(pairs) -> list:
    """The six largest max |a - b| / max |a| of (path, a, b) leaves."""
    out = sorted(((float((b - a).abs().max() / a.abs().max().clamp_min(1e-30)), q)
                  for q, a, b in pairs), reverse=True)
    return [(f"{e:.3g}", q) for e, q in out[:6]]


def main() -> None:
    from repro_torch._tree import leaves_with_path, unflatten_like
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import params_shardings
    from repro_torch.train.step import make_loss_fn, value_and_grad

    OUT.mkdir(parents=True, exist_ok=True)
    port = cs._free_port()
    logs = [open(OUT / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port)],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    codes = [pr.wait(timeout=900) for pr in procs]
    if any(codes):
        raise SystemExit(f"ranks exited {codes}: see {OUT}/rank*.log")
    dev = torch.device(DEVICE)
    cfg, tf, data = _setup()
    mesh = AbstractMesh((1, 2), ("data", "model"))
    plan = tp_model.make_plan(cfg, mesh)
    shapes = cs.param_shapes(cfg)
    specs = [sh.spec for sh in cs.tree_leaves(params_shardings(cfg, mesh, shapes))]
    paths = [q for q, _ in leaves_with_path(shapes)]
    dims = [next((d for d, e in enumerate(sp) if e == "model"), None) for sp in specs]
    ranks = [torch.load(OUT / f"grads_rank{r}.pt") for r in range(2)]
    blocks1 = [torch.load(OUT / f"params1_rank{r}.pt") for r in range(2)]
    print(f"{ARCH} placed losses: {ranks[0]['losses']}")
    base = cs.init_params(cfg, torch.Generator(device=dev).manual_seed(tf["seed"]), dev)
    after = unflatten_like(base, [
        (torch.cat([blocks1[0][i], blocks1[1][i]], dim=d) if d is not None
         else blocks1[0][i]).to(dev) for i, d in enumerate(dims)])
    for s, params in enumerate((base, after)):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.global_batch(s).items()}
        loss, g = value_and_grad(make_loss_fn(cfg), params, batch)
        placed = []
        for i, (path, d) in enumerate(zip(paths, dims)):
            parts = [r["grads"][s][i] for r in ranks]
            placed.append(torch.cat(parts, dim=d) if d is not None
                          else parts[0] + parts[1] if path in plan.partial else parts[0])
        want = [t.cpu() for t in cs.tree_leaves(g)]
        print(f"step {s}: one-process loss {float(loss):.7f} at the placed params; placed "
              f"gradient against it: {_worst(zip(paths, want, placed))}")
        if dev.type == "cuda":
            torch.backends.cuda.preferred_blas_library("cublaslt")
            _, g2 = value_and_grad(make_loss_fn(cfg), params, batch)
            torch.backends.cuda.preferred_blas_library("default")
            print(f"  one process, cuBLASLt against cuBLAS: "
                  f"{_worst(zip(paths, want, (t.cpu() for t in cs.tree_leaves(g2))))}")
            del g2
        del g


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
