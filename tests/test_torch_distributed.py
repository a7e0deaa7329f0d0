"""repro_torch's distribution layer over gloo process groups on the CPU.

Each group runs as separate processes (``file://`` rendezvous in the
test's directory, one CPU thread each) that write their results for this
process to compare:

* the rule-placed train step (``launch.step``, tensor-parallel over
  "model") over 4 ranks, 2 "data" x 2 "model", on the smoke internlm2-1.8b
  at float32: plain, ZeRO-1, FSDP and int8_ef-compressed.  Loss and grad
  norm within 1e-5 relative of the one-process port step on the whole
  batch; each rank's gradient block, before any reduction, within 1e-5 of
  the one-process gradient of its rows (relative to the leaf's largest
  element; under FSDP a data-split leaf's block leaves the backward
  reduce-scattered, so it is held to the gradient of every data rank's
  rows, summed); the params within 1e-5 of the one-process AdamW applied to the
  gradient assembled from those blocks, within 2e-4 of the one-process
  step's params (AdamW's elementwise scaling), and within the reference's 5e-3
  (``tests/test_distributed.py``) of its jitted one-device step on the same
  weights; every rank ends with the same params.  The int8_ef step takes
  two steps, held to an answer worked out apart from the step on each
  rank's blocks: its gradient blocks (the tap), summed over "model" where
  partial, averaged through ``compressed_psum`` over the "data" group,
  clipped by the global norm and applied by ``optim``'s AdamW (grad norms,
  params, m, v and each rank's error buffer within 1e-5 relative).
* ``compressed_psum`` over 2 ranks, bit-exact with the reference's
  ``shard_map`` over 2 host devices (run in its own process with the
  device-count flag, which this process must not see: ``conftest.py``):
  sums and each rank's error buffer, for none / bf16 / int8_ef, a
  subnormal block, and the egress-ordered wire.
* ``kernels.bt_count_axes_sharded`` over 2 ranks, with 7 links (an odd
  count: one padding link), jagged ``valid``, activity windows on and
  off and a chunked case: bit-exact with the port's and the reference's
  unsharded ``bt_count_axes``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import draw_params
from repro import kernels as rk
from repro.configs import smoke_config as rsmoke_config
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import init as ropt_init
from repro.train import make_train_step as rmake_train_step
from repro_torch import kernels as tk
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
REL_TOL = 1e-5  # placed step vs the one-process port step
# params vs the one-process step's params: AdamW divides each element by its
# own magnitude, so a tiny cancelling gradient element (near the optimizer's
# eps) carries its float32 summation noise into the update (test_torch_tp.py)
PARAM_TOL = 2e-4
REF_TOL = 5e-3  # vs the reference's jitted step (tests/test_distributed.py)
LR = RAdamWConfig().peak_lr

STEP = {"arch": "internlm2-1.8b", "overrides": {"d_model": 64, "n_heads": 4, "n_kv_heads": 4,
                                                "dtype": "float32"},
        "batch": 8, "seq": 32, "seed": 0}
VARIANTS = {"plain": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
COMPRESSED_STEPS = 2

PSUM = {"m": 1000, "m_ordered": 1024, "block": 64}
AXES = {"links": 7, "p": 40, "n": 16, "valid": [40, 33, 0, 40, 17, 40, 5],
        "grid": [("none",), ("acc",), ("app", 4), ("acc", None, False, "bus_invert", 2),
                 ("none", None, False, "gray")]}


def _run_ranks(tmp: Path, script: str, world: int) -> None:
    """Run ``script`` as ``world`` processes (argv: rank, world, dir); the
    workers import this module for its input builders."""
    path = tmp / "worker.py"
    path.write_text(textwrap.dedent(script))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(world), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            p.kill()
    assert not errs, "\n".join(errs)


def step_inputs():
    cfg = smoke_config(STEP["arch"], **STEP["overrides"])
    params = draw_params(cfg, np.random.default_rng(STEP["seed"]))
    rng = np.random.default_rng(STEP["seed"] + 1)
    batch = {k: rng.integers(0, cfg.vocab, (STEP["batch"], STEP["seq"]), dtype=np.int32)
             for k in ("tokens", "labels")}
    return cfg, params, batch


_STEP_WORKER = """
    import sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out + "/store", rank=rank,
                            world_size=world)
    import copy, dataclasses
    from types import SimpleNamespace
    from test_torch_distributed import COMPRESSED_STEPS, STEP, VARIANTS, compressed_steps, step_inputs
    from repro_torch import _obs_hooks, optim
    from repro_torch._tree import leaves
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.launch.step import gather, make_placed_train_step, place_state
    from repro_torch.roofline import record_collectives

    mesh = _device_mesh((2, 2), ("data", "model"), "cpu")
    cfg0, params_np, batch_np = step_inputs()
    ocfg = optim.AdamWConfig(total_steps=10, warmup_steps=1)
    res = {}
    runs = [(name, over, None) for name, over in VARIANTS.items()]
    runs.append(("int8_ef", {}, optim.CompressionConfig(mode="int8_ef", block=64)))
    for name, over, comp in runs:
        cfg = dataclasses.replace(cfg0, **over)
        params = params_from_numpy(copy.deepcopy(params_np), "cpu")  # updated in place
        p, o = place_state(cfg, mesh, params)
        step = make_placed_train_step(cfg, ocfg, mesh, compression=comp)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        norms, tapped = [], []
        _obs_hooks.TAP = SimpleNamespace(tap=lambda kind, payload: tapped.append(
            [g.clone() for g in leaves(payload["grads"])]))
        with record_collectives() as ops:
            for _ in range(COMPRESSED_STEPS if comp else 1):
                p, o, m = step(p, o, batch)
                norms.append(float(m["grad_norm"]))
                res.setdefault(f"{name}/loss0", m["loss"].numpy())
        _obs_hooks.TAP = None
        for i, x in enumerate(leaves(p)):
            res[f"{name}/p{i}"] = gather(x).numpy().copy()
        for i, g in enumerate(tapped[0]):
            res[f"{name}/g{i}"] = g.numpy()
        for i, x in enumerate(leaves(o.m)):
            res[f"{name}/m_local_shape{i}"] = np.array(x.to_local().shape)
        res[f"{name}/loss"] = m["loss"].numpy()
        res[f"{name}/grad_norm"] = m["grad_norm"].numpy()
        res[f"{name}/kinds"] = np.array(sorted({op["kind"] for op in ops}))
        if comp is not None:
            res[f"{name}/grad_norms"] = np.array(norms)
            res[f"{name}/error"] = step.error.numpy().copy()
            for key, tree in (("p", p), ("m", o.m), ("v", o.v)):
                for i, x in enumerate(leaves(tree)):
                    res[f"{name}/local_{key}{i}"] = x.to_local().numpy().copy()
            want = compressed_steps(cfg, ocfg, comp, mesh, tapped)
            res.update({f"{name}/want_{k}": v for k, v in want.items()})
    np.savez(out + f"/step{rank}.npz", **res)
    dist.destroy_process_group()
"""


def compressed_steps(cfg, ocfg, comp, mesh, tapped: list) -> dict:
    """The int8_ef placed step's answer on this rank's blocks, worked out
    apart from it: the step's own gradient blocks of each step (``tapped``,
    before any reduction; the plain run holds them to the one-process
    gradient), the partial leaves summed over "model", the flat blocks
    summed over "data" by ``compressed_psum`` and divided by its size, the
    global norm (split blocks' squares summed over "model") and ``optim``'s
    AdamW leaf by leaf, COMPRESSED_STEPS times."""
    import copy

    import torch.distributed as dist

    from repro_torch.launch import tp_model
    from repro_torch.launch.sharding import params_shardings
    from repro_torch.launch.step import place
    from repro_torch.optim.adamw import step_scalars, update_leaf

    plan = tp_model.make_plan(cfg, mesh)
    _, params_np, _ = step_inputs()
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    paths = [p for p, _ in leaves_with_path(params)]
    ps = [place(x, sh).to_local().clone() for x, sh in zip(
        leaves(params), leaves(params_shardings(cfg, mesh, params)))]
    state = optim.init(ps)
    error, norms = None, []
    n_data = mesh.size(0)
    for grads in tapped[:COMPRESSED_STEPS]:
        grads = [g.clone() for g in grads]
        for path, g in zip(paths, grads):
            if path in plan.partial:
                dist.all_reduce(g, group=mesh.get_group("model"))
        flat = torch.cat([g.reshape(-1) for g in grads])
        error = torch.zeros_like(flat) if error is None else error
        total, error = optim.compressed_psum(flat, error, comp, mesh.get_group("data"))
        mean, at, parts = total / n_data, 0, []
        for g in grads:
            parts.append(mean[at: at + g.numel()].view(g.shape))
            at += g.numel()
        split = torch.stack([torch.sum(torch.square(g)) for g, p in zip(parts, paths)
                             if p in plan.split]).sum()
        dist.all_reduce(split, group=mesh.get_group("model"))
        whole = torch.stack([torch.sum(torch.square(g)) for g, p in zip(parts, paths)
                             if p not in plan.split]).sum()
        s = step_scalars(ocfg, parts, state, gnorm=torch.sqrt(split + whole))
        for p, g, m, v in zip(ps, parts, state.m, state.v):
            update_leaf(ocfg, s, p, g, m, v, donate=True)
        state = state._replace(step=s["step"])
        norms.append(float(s["grad_norm"]))
    out = {"grad_norms": np.array(norms), "error": error.numpy()}
    for key, xs in (("p", ps), ("m", state.m), ("v", state.v)):
        out.update({f"local_{key}{i}": x.numpy() for i, x in enumerate(xs)})
    return out


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placed_step")
    _run_ranks(tmp, _STEP_WORKER, 4)
    return [dict(np.load(tmp / f"step{r}.npz")) for r in range(4)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _one_process(over: dict):
    import dataclasses

    cfg, params_np, batch_np = step_inputs()
    cfg = dataclasses.replace(cfg, **over)
    params = params_from_numpy(params_np, "cpu")
    ocfg = optim.AdamWConfig(total_steps=10, warmup_steps=1)
    p, _, m = make_train_step(cfg, ocfg)(params, optim.init(params),
                                         {k: torch.from_numpy(v) for k, v in batch_np.items()})
    return [x.numpy() for x in leaves(p)], m


def _row_grads(cfg, params_np, batch_np, rows: slice) -> list:
    from repro_torch.train.step import make_loss_fn, value_and_grad

    params = params_from_numpy(params_np, "cpu")
    _, g = value_and_grad(make_loss_fn(cfg), params, {k: torch.from_numpy(v[rows])
                                                       for k, v in batch_np.items()})
    return leaves(g)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_placed_step_matches_one_process_step(step_run, name):
    import dataclasses

    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import params_shardings

    res = step_run[0]
    want, m = _one_process(VARIANTS[name])
    assert _rel(res[f"{name}/loss"], m["loss"].numpy()) < REL_TOL
    assert _rel(res[f"{name}/grad_norm"], m["grad_norm"].numpy()) < REL_TOL
    cfg, params_np, batch_np = step_inputs()
    cfg = dataclasses.replace(cfg, **VARIANTS[name])
    mesh = AbstractMesh((2, 2), ("data", "model"))
    plan = tp_model.make_plan(cfg, mesh)
    params = params_from_numpy(params_np, "cpu")
    specs = [sh.spec for sh in leaves(params_shardings(cfg, mesh, params))]
    rows = STEP["batch"] // 2
    per_data = [_row_grads(cfg, params_np, batch_np, slice(d * rows, (d + 1) * rows))
                for d in range(2)]
    grads = []
    for i, (path, spec) in enumerate(zip([p for p, _ in leaves_with_path(params)], specs)):
        dim = next((k for k, e in enumerate(spec) if e == "model"), None)
        assembled = []
        for d in range(2):
            blocks = [torch.from_numpy(step_run[2 * d + j][f"{name}/g{i}"]) for j in range(2)]
            whole = torch.cat(blocks, dim) if dim is not None else (
                blocks[0] + blocks[1] if path in plan.partial else blocks[0])
            assembled.append(whole)
        if "data" in spec:  # FSDP: each data rank's block of the sum over "data"
            data_dim = spec.index("data")
            whole = torch.cat(assembled, data_dim)
            summed = per_data[0][i] + per_data[1][i]
            assert float((whole - summed).abs().max()) <= REL_TOL * float(summed.abs().max()), path
            grads.append(whole / 2)
            continue
        for d in range(2):
            tol = REL_TOL * float(per_data[d][i].abs().max())
            assert float((assembled[d] - per_data[d][i]).abs().max()) <= tol, (d, path)
        grads.append((assembled[0] + assembled[1]) / 2)
    ps = leaves(params)
    optim.update(optim.AdamWConfig(total_steps=10, warmup_steps=1), grads, optim.init(ps), ps,
                 donate=True)
    for i, (w, one) in enumerate(zip(ps, want)):
        assert _rel(res[f"{name}/p{i}"], w.numpy()) < REL_TOL, i
        assert _rel(res[f"{name}/p{i}"], one) < PARAM_TOL, i


def test_placed_step_matches_reference_step(step_run):
    cfg, params_np, batch_np = step_inputs()
    rcfg = rsmoke_config(STEP["arch"], **STEP["overrides"])
    params = jax.tree.map(jnp.asarray, params_np)
    step = rmake_train_step(rcfg, RAdamWConfig(total_steps=10, warmup_steps=1))
    p, _, m = jax.jit(step)(params, ropt_init(params), jax.tree.map(jnp.asarray, batch_np))
    for name in VARIANTS:
        res = step_run[0]
        assert abs(float(res[f"{name}/loss"]) - float(m["loss"])) < REF_TOL
        for i, w in enumerate(jax.tree.leaves(p)):
            assert np.abs(res[f"{name}/p{i}"] - np.asarray(w)).max() < REF_TOL, (name, i)


def test_placed_step_ranks_agree_and_shard_their_state(step_run):
    for r in range(1, 4):
        for k, v in step_run[0].items():
            if "/p" in k or k.endswith("loss"):
                np.testing.assert_array_equal(step_run[r][k], v)
    cfg, params_np, _ = step_inputs()
    shapes = [np.array(x.shape) for x in leaves(params_from_numpy(params_np, "cpu"))]
    res = step_run[0]
    n = len(shapes)
    # plain: m/v as the params (the "model" split only); ZeRO-1 halves more
    # leaves over "data"; FSDP's params are split over both axes
    plain = sum(int(np.prod(res[f"plain/m_local_shape{i}"])) for i in range(n))
    zero1 = sum(int(np.prod(res[f"zero1/m_local_shape{i}"])) for i in range(n))
    fsdp = sum(int(np.prod(res[f"fsdp/m_local_shape{i}"])) for i in range(n))
    whole = sum(int(np.prod(s)) for s in shapes)
    assert zero1 < plain < whole and fsdp < plain
    # the tensor-parallel step gathers no "model"-split leaf: plain only
    # all-reduces; ZeRO-1 gathers its updated params over "data"; FSDP
    # gathers its leaves over "data" a layer at a time and reduce-scatters
    # their gradients (tests/test_torch_fsdp.py holds the schedule)
    assert set(res["plain/kinds"]) == {"all-reduce"}
    assert set(res["zero1/kinds"]) == {"all-gather", "all-reduce"}
    assert set(res["fsdp/kinds"]) == {"all-gather", "reduce-scatter", "all-reduce"}


def test_compressed_placed_step(step_run):
    assert float(step_run[0]["int8_ef/loss0"]) == float(step_run[0]["plain/loss"])
    for res in step_run:
        assert float(np.abs(res["int8_ef/error"]).max()) > 0
        keys = [k.split("/want_")[1] for k in res if k.startswith("int8_ef/want_")]
        assert len(keys) == 2 + 3 * sum(k.startswith("plain/p") for k in res)
        for key in keys:
            assert _rel(res[f"int8_ef/{key}"], res[f"int8_ef/want_{key}"]) < REL_TOL, key
        # its first gradient blocks are the plain step's, which
        # test_placed_step_matches_one_process_step holds to the one-process port
        for i in range(sum(k.startswith("plain/p") for k in res)):
            np.testing.assert_array_equal(res[f"int8_ef/g{i}"], res[f"plain/g{i}"])


# ------------------------------------------------------------------ compressed_psum


def psum_inputs(rank: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(100 + rank)
    g = (rng.standard_normal(m) * rng.lognormal(0, 2, m)).astype(np.float32)
    e = (0.01 * rng.standard_normal(m)).astype(np.float32)
    b = PSUM["block"]
    if rank == 0:
        g[:b] = np.float32(1e-39)  # a subnormal block
    else:
        g[b: 2 * b] = e[b: 2 * b] = np.float32(7e-39)  # subnormal inputs, normal sum
    return g, e


def psum_perm() -> tuple[np.ndarray, np.ndarray]:
    from repro_torch.traffic import egress_permutation

    w8 = np.random.default_rng(7).integers(-128, 128, PSUM["m_ordered"], dtype=np.int8)
    perm, inv = egress_permutation(torch.from_numpy(w8), packet=64)
    return perm.numpy(), inv.numpy()


PSUM_CASES = ("none", "bf16", "int8_ef", "int8_ef_ordered")

_PSUM_WORKER = """
    import sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out + "/store", rank=rank,
                            world_size=world)
    from test_torch_distributed import AXES, PSUM, PSUM_CASES, axes_inputs, psum_inputs, psum_perm
    from repro_torch import kernels, optim
    group = dist.group.WORLD
    res = {}
    perm, inv = (torch.from_numpy(a) for a in psum_perm())
    for case in PSUM_CASES:
        ordered = case.endswith("ordered")
        g, e = psum_inputs(rank, PSUM["m_ordered"] if ordered else PSUM["m"])
        cfg = optim.CompressionConfig(mode=case.replace("_ordered", ""), block=PSUM["block"],
                                      use_egress_ordering=ordered)
        kw = {"perm": perm, "inv_perm": inv} if ordered else {}
        s, ne = optim.compressed_psum(torch.from_numpy(g), torch.from_numpy(e), cfg, group, **kw)
        res[case + "/sum"], res[case + "/error"] = s.numpy(), ne.numpy()
    x, w, valid, configs = axes_inputs()
    for act in (None, 3):
        for chunk in (None, 16):
            r = kernels.bt_count_axes_sharded(x, w, valid, configs, activity_windows=act,
                                              chunk_packets=chunk, group=group)
            tag = f"axes/{act}/{chunk}"
            for i, t in enumerate([r] if act is None else r):
                res[f"{tag}/{i}"] = t.numpy()
    np.savez(out + f"/psum{rank}.npz", **res)
    dist.destroy_process_group()
"""

_PSUM_REFERENCE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.optim import CompressionConfig, compressed_psum
    from test_torch_distributed import PSUM, PSUM_CASES, psum_inputs, psum_perm
    out = sys.argv[3]
    mesh = jax.make_mesh((2,), ("data",))
    perm, inv = (jnp.asarray(a) for a in psum_perm())
    res = {}
    for case in PSUM_CASES:
        ordered = case.endswith("ordered")
        m = PSUM["m_ordered"] if ordered else PSUM["m"]
        g, e = (np.stack(x) for x in zip(*(psum_inputs(r, m) for r in range(2))))
        cfg = CompressionConfig(mode=case.replace("_ordered", ""), block=PSUM["block"],
                                use_egress_ordering=ordered)
        def f(g, e):
            s, ne = compressed_psum(g[0], e[0], cfg, ("data",), *((perm, inv) if ordered else ()))
            return s[None], ne[None]
        with mesh:
            s, ne = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                                      out_specs=(P("data"), P("data"))))(g, e)
        res[case + "/sum"], res[case + "/error"] = np.asarray(s), np.asarray(ne)
    np.savez(out + "/reference.npz", **res)
"""


def axes_inputs():
    rng = np.random.default_rng(11)
    shape = (AXES["links"], AXES["p"], AXES["n"])
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int32))
    w = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int32))
    configs = tuple(tk.CodecVariant(*c) for c in AXES["grid"])
    return x, w, torch.tensor(AXES["valid"]), configs


@pytest.fixture(scope="module")
def psum_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    _run_ranks(tmp, _PSUM_WORKER, 2)
    ref = tmp_path_factory.mktemp("psum_reference")
    script = ref / "reference.py"
    script.write_text(textwrap.dedent(_PSUM_REFERENCE))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, str(script), "0", "1", str(ref)], capture_output=True,
                         text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [dict(np.load(tmp / f"psum{r}.npz")) for r in range(2)], dict(
        np.load(ref / "reference.npz"))


@pytest.mark.parametrize("case", PSUM_CASES)
def test_compressed_psum_over_gloo_matches_reference_shard_map(psum_run, case):
    ranks, ref = psum_run
    for r in range(2):
        np.testing.assert_array_equal(ranks[r][case + "/sum"], ref[case + "/sum"][r])
        np.testing.assert_array_equal(ranks[r][case + "/error"].view(np.int32),
                                      ref[case + "/error"][r].view(np.int32))


@pytest.mark.parametrize("act", [None, 3])
def test_sharded_link_axis_matches_unsharded(psum_run, act):
    ranks, _ = psum_run
    x, w, valid, configs = axes_inputs()
    want = tk.bt_count_axes(x, w, valid, configs, activity_windows=act)
    want = [want] if act is None else list(want)
    ref = rk.bt_count_axes(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(valid.numpy()),
                           tuple(rk.CodecVariant(*c) for c in AXES["grid"]),
                           activity_windows=act)
    ref = [ref] if act is None else list(ref)
    for chunk in (None, 16):
        for r in range(2):
            for i, (a, b) in enumerate(zip(want, ref)):
                got = ranks[r][f"axes/{act}/{chunk}/{i}"]
                np.testing.assert_array_equal(got, a.numpy())
                np.testing.assert_array_equal(got, np.asarray(b))


def test_sharded_link_axis_without_a_group_is_the_unsharded_table():
    x, w, valid, configs = axes_inputs()
    assert torch.equal(tk.bt_count_axes_sharded(x, w, valid, configs),
                       tk.bt_count_axes(x, w, valid, configs))
    empty = tk.bt_count_axes_sharded(x[:0], w[:0], valid[:0], configs, activity_windows=2)
    assert empty.bt.shape == (0, len(configs), 3) and empty.toggles.shape[0] == 0
    with pytest.raises(ValueError, match="expected"):
        tk.bt_count_axes_sharded(x[0])
