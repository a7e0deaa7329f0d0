"""repro_torch's attention contraction split over "model" on the CPU: where
"model" divides ``d_model`` but not the heads, the rules split ``wq`` on
its input ``d`` and ``wo`` on its output ``d`` and keep ``wk`` / ``wv``
whole (``launch/tp_model.py``'s ``contracted_qkv`` / ``contracted_out``),
run by the placed step (``step.py``), placed serving (``serve.py``) and the
dry run.

* The plan read from the rules (an ``AbstractMesh``, no group) for every
  case below and for granite-moe-3b-a800m's baseline 16 x 16 cells: the
  contraction split, whole kv, ``local`` the whole config, ``wq`` / ``wo``
  split, no partial attention leaf.
* gloo groups of 2 and 4 ranks (separate processes, ``_run_ranks`` of
  ``test_torch_distributed.py``), smoke configs whose heads the axis does
  not divide: internlm2-1.8b with 3 heads (``d_model`` 48) on (1, 2),
  granite-moe-3b-a800m with 3 heads on (1, 2) and (2, 2) and with 6 heads
  (``d_model`` 96) on (1, 4), qwen3-4b (qk-norm, ``head_dim`` 16, so the
  heads' width 96 is not ``d_model`` 64) with 6 heads on (1, 4).  Two
  placed steps at float32:

  - each rank's gradient block, before any reduction (averaged over
    "data": a MoE's load-balance means are the whole batch's), within
    ``TOL`` of the one-process gradient; losses and grad norms within
    ``TOL``; params within ``PARAM_TOL`` of the one-process step and within
    ``UPDATE_TOL`` of the one-process AdamW of the assembled gradient
    (``test_torch_tp.py`` gives the reasons);
  - the gradients of ``wk``, ``wv``, ``q_norm`` and ``k_norm`` whole on
    every rank, not summed (each rank runs the whole core on the whole
    ``q``); ``wq`` / ``wo`` blocks 1/m of the whole;
  - the step's recorded collectives equal to ``chip_smoke.cp_collectives``,
    the closed form phase 3k holds the card's 16 ranks to, plus the
    data-parallel mean;
  - granite's (2, 2) step within 5e-3 of the reference's own GSPMD step (a
    subprocess with 4 forced host devices), updates compared relative to
    the reference's largest update.

  The placed greedy ``generate`` with the cache split on its sequence
  (split-K, every query head on every rank) and whole: tokens equal to the
  one-process port's, log-probabilities and the prefill's and a decode
  step's logits within ``TOL``; a decode step's collectives equal to the
  closed form.
* The meta dry run of the smoke internlm2-1.8b's and granite's cells on a
  (2, 8) stand-in mesh, where their 4 heads split the contraction:
  modelled, with the queries' float32 sum recorded once a layer.
"""

import copy
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import cp_collectives, draw_params
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import build_case, dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import param_shapes
from repro_torch.train import make_train_step
from repro_torch.train.step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = 1e-5  # gradients, losses, grad norms, logits: summation order only
UPDATE_TOL = 1e-6  # params vs the one-process AdamW on the assembled gradient
PARAM_TOL = 2e-4  # params vs the one-process step (AdamW's elementwise scaling)
REF_TOL = 5e-3  # vs the reference's GSPMD step (tests/test_distributed.py)
GRAD_FLOOR = 1e-6  # 100 x AdamW's eps: the updates compared with the reference's
STEPS = 2
BATCH, SEQ = 8, 32
INTERNLM, GRANITE, QWEN = "internlm2-1.8b", "granite-moe-3b-a800m", "qwen3-4b"
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)
H3 = {"n_heads": 3, "n_kv_heads": 1, "d_model": 48}
H6 = {"n_heads": 6, "n_kv_heads": 2, "d_model": 96}
Q6 = {"n_heads": 6, "n_kv_heads": 2}

# (arch, mesh, overrides): heads that "model" does not divide, d_model that it does
STEP_CASES = [(INTERNLM, (1, 2), H3), (GRANITE, (1, 2), H3), (GRANITE, (2, 2), H3),
              (GRANITE, (1, 4), H6), (QWEN, (1, 4), Q6)]
# (arch, mesh, overrides, new tokens, the cache's placement): prompts of 8, so
# a cache of 12 splits 2 and 4 ways on its sequence and one of 11 does not
SERVE_CASES = [(INTERNLM, (1, 2), H3, 3, "whole"), (GRANITE, (1, 2), H3, 4, "seq"),
               (GRANITE, (1, 4), H6, 3, "whole"), (QWEN, (1, 4), Q6, 4, "seq")]
SERVE_BATCH, SERVE_PROMPT = 2, 8
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
WHOLE = ("wk", "wv", "q_norm", "k_norm")  # replicated leaves whose use is whole


def _tag(arch: str, mesh: tuple, over: dict) -> str:
    extra = "".join(f"-{k}{v}" for k, v in sorted(over.items()))
    return f"{arch}{extra}@{'x'.join(map(str, mesh))}"


def step_inputs(arch: str, over: dict):
    cfg = smoke_config(arch, dtype="float32", **over)
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
             for k in ("tokens", "labels")}
    return cfg, params, batch


def serve_inputs(arch: str, over: dict):
    cfg = smoke_config(arch, dtype="float32", **over)
    params = draw_params(cfg, np.random.default_rng(0))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                                                dtype=np.int32)
    return cfg, params, prompts


def _ops_arrays(ops: list) -> dict:
    return {"kinds": np.array([o["kind"] for o in ops]),
            "bytes": np.array([o["bytes"] for o in ops], dtype=np.int64),
            "groups": np.array([o["group"] for o in ops], dtype=np.int64)}


# ------------------------------------------------------------------ the ranks' work


def _placed_steps(arch, shape, over, mesh) -> dict:
    from repro_torch import _obs_hooks
    from repro_torch.launch.step import gather, make_placed_train_step, place_state
    from repro_torch.roofline import record_collectives

    tag = _tag(arch, shape, over)
    cfg, params_np, batch_np = step_inputs(arch, over)
    params = params_from_numpy(params_np, "cpu")
    p, o = place_state(cfg, mesh, params)
    step = make_placed_train_step(cfg, OCFG, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    tapped, losses, norms = [], [], []
    _obs_hooks.TAP = SimpleNamespace(tap=lambda kind, payload: tapped.append(
        [g.clone() for g in leaves(payload["grads"])]))
    try:
        for i in range(STEPS):
            with record_collectives() as ops:
                p, o, m = step(p, o, batch)
            if i == 0:
                first = ops
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        _obs_hooks.TAP = None
    out = {f"{tag}/losses": np.array(losses), f"{tag}/grad_norms": np.array(norms)}
    for i, x in enumerate(leaves(p)):
        out[f"{tag}/p{i}"] = gather(x).numpy()
        out[f"{tag}/pshape{i}"] = np.array(x.to_local().shape)
    for s, gs in enumerate(tapped):
        for i, g in enumerate(gs):
            out[f"{tag}/g{s}_{i}"] = g.numpy()
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(first).items()})
    return out


@torch.no_grad()
def _placed_serve(arch, shape, over, new, mesh) -> dict:
    from repro_torch.launch import serve as ps
    from repro_torch.roofline import record_collectives

    tag = _tag(arch, shape, over) + f"/{new}"
    cfg, params_np, prompts_np = serve_inputs(arch, over)
    local = ps.shard_params(cfg, mesh, params_from_numpy(params_np, "cpu"))
    prompts = torch.from_numpy(prompts_np)
    res = ps.generate(local, cfg, mesh, prompts, new)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    max_len = SERVE_PROMPT + new
    mode = ps.kv_mode(cfg, mesh, SERVE_BATCH, max_len)
    logits, cache = ps.prefill(local, plan, prompts, max_len, mode)
    with record_collectives() as ops:
        step_logits, _ = ps.decode_step(local, plan, cache, res.tokens[:, :1].to(torch.int32),
                                        mode)
    out = {f"{tag}/tokens": res.tokens.numpy(), f"{tag}/logprobs": res.logprobs.numpy(),
           f"{tag}/prefill": logits.numpy(), f"{tag}/decode": step_logits.numpy(),
           f"{tag}/mode": np.array(mode), f"{tag}/kshape": np.array(cache["k"].shape)}
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(ops).items()})
    return out


def run_rank(world: int) -> dict:
    """Everything one rank of a ``world``-rank gloo group computes."""
    from repro_torch.launch.mesh import _device_mesh

    out = {}
    for shape in MESHES[world]:
        mesh = _device_mesh(shape, ("data", "model"), "cpu")
        for arch, m, over in STEP_CASES:
            if m == shape:
                out.update(_placed_steps(arch, m, over, mesh))
        for arch, m, over, new, _ in SERVE_CASES:
            if m == shape:
                out.update(_placed_serve(arch, m, over, new, mesh))
    return out


_WORKER = """
    import sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out + "/store", rank=rank,
                            world_size=world)
    from test_torch_cp import run_rank
    np.savez(out + f"/rank{rank}.npz", **run_rank(world))
    dist.destroy_process_group()
"""

_REFERENCE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.launch.sharding import batch_shardings, opt_shardings, params_shardings
    from repro.optim import AdamWConfig
    from repro.optim import init as opt_init
    from repro.train import make_loss_fn, make_train_step
    from test_torch_cp import GRANITE, H3, STEPS, step_inputs
    out = sys.argv[1]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = smoke_config(GRANITE, dtype="float32", **H3)
    _, params, batch = step_inputs(GRANITE, H3)
    params = jax.tree.map(jnp.asarray, params)
    batch = jax.tree.map(jnp.asarray, batch)
    opt = opt_init(params)
    shape = lambda t: jax.eval_shape(lambda: t)
    p_sh = params_shardings(cfg, mesh, shape(params))
    o_sh = opt_shardings(cfg, mesh, shape(opt), shape(params))
    b_sh = batch_shardings(cfg, mesh, {k: shape(v) for k, v in batch.items()})
    step = jax.jit(make_train_step(cfg, AdamWConfig(total_steps=10, warmup_steps=1)),
                   in_shardings=(p_sh, o_sh, b_sh))
    grad = jax.jit(jax.grad(make_loss_fn(cfg)), in_shardings=(p_sh, b_sh))
    res, losses = {}, []
    with mesh:
        for i, g in enumerate(jax.tree.leaves(grad(params, batch))):
            res[f"g{i}"] = np.asarray(g)
        for _ in range(STEPS):
            # the step's outputs come back as the compiler placed them; put
            # them where the next call's in_shardings say (values unchanged)
            params, opt = jax.device_put((params, opt), (p_sh, o_sh))
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
    res["losses"] = np.array(losses)
    for i, x in enumerate(jax.tree.leaves(params)):
        res[f"p{i}"] = np.asarray(x)
    np.savez(out + "/reference.npz", **res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]} and the reference's results."""
    from test_torch_distributed import _run_ranks

    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"cp{world}")
        _run_ranks(tmp, _WORKER, world)
        out[world] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    ref = tmp_path_factory.mktemp("cp_reference")
    (ref / "reference.py").write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    run = subprocess.run([sys.executable, str(ref / "reference.py"), str(ref)],
                         capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    return out, dict(np.load(ref / "reference.npz"))


def _rank_results(ranks, shape) -> list:
    """The results of the ranks of ``shape``'s group, in rank order (rank =
    data index x m + model index)."""
    return ranks[0][shape[0] * shape[1]]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _abstract(shape) -> AbstractMesh:
    return AbstractMesh(tuple(shape), ("data", "model"))


def _plan(cfg, shape, mode="train"):
    return tp_model.make_plan(cfg, _abstract(shape), mode)


def _name(path: str) -> str:
    return path.rsplit("['", 1)[-1].rstrip("']")


def _model_dim(spec):
    return next((d for d, e in enumerate(spec)
                 if e is not None and "model" in (e if isinstance(e, tuple) else (e,))), None)


def _specs(cfg, shape) -> list:
    from repro_torch.launch.sharding import params_shardings

    return [sh.spec for sh in leaves(params_shardings(cfg, _abstract(shape), param_shapes(cfg)))]


def _block(x: np.ndarray, spec, shape, model_index: int) -> np.ndarray:
    """Model rank ``model_index``'s block of ``x`` under ``spec``."""
    idx = [slice(None)] * x.ndim
    d = _model_dim(spec)
    if d is not None:
        n = x.shape[d] // shape[1]
        idx[d] = slice(model_index * n, (model_index + 1) * n)
    return x[tuple(idx)]


def _grads_np(cfg, params_np, batch_np) -> dict:
    """path -> the one-process gradient of the whole batch, in leaf order."""
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    _, g = value_and_grad(make_loss_fn(cfg), params, batch)
    return {p: x.numpy() for p, x in leaves_with_path(g)}


def _one_process_steps(cfg, params_np, batch_np):
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    step = make_train_step(cfg, OCFG, donate=True)
    state, losses, norms = optim.init(params), [], []
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return [x.numpy() for x in leaves(params)], losses, norms


def _model_blocks(res, tag: str, i: int, shape, s: int = 0) -> list:
    """Leaf ``i``'s step-``s`` gradient block of each "model" rank, before
    any reduction, averaged over the "data" ranks (the mean of the rows'
    gradients is the whole batch's; a MoE's load-balance means are the whole
    batch's on every data rank)."""
    dn, mn = shape
    return [sum(res[d * mn + m][f"{tag}/g{s}_{i}"] for d in range(dn)) / dn for m in range(mn)]


def _assembled_grads(res, tag: str, cfg, shape, s: int) -> list:
    """Step ``s``'s whole gradient, leaf by leaf, from the ranks' blocks: a
    split leaf's blocks concatenated, a whole leaf's taken once (no leaf is
    partial under the contraction split)."""
    grads = []
    for i, spec in enumerate(_specs(cfg, shape)):
        blocks = _model_blocks(res, tag, i, shape, s)
        dim = _model_dim(spec)
        g = np.concatenate(blocks, axis=dim) if dim is not None else blocks[0]
        grads.append(torch.from_numpy(np.ascontiguousarray(g)))
    return grads


_STEP_IDS = [_tag(a, m, o) for a, m, o in STEP_CASES]
_SERVE_IDS = [f"{_tag(a, m, o)}-{mode}" for a, m, o, _, mode in SERVE_CASES]


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_plan_reads_the_contraction_split(arch, shape, over):
    cfg = smoke_config(arch, **over)
    m = shape[1]
    assert cfg.n_heads % m and cfg.d_model % m == 0
    for mode in ("train", "serve"):
        assert tp_model.unsupported(cfg, _abstract(shape), mode) is None
        p = _plan(cfg, shape, mode)
        assert (p.attn, p.kv, p.kv_index, p.local) == ("contraction", "whole", None, cfg)
        attn = {_name(x) for x in p.split if "['attn']" in x}
        assert attn == {"wq", "wo"}
        assert not any("['attn']" in x for x in p.partial)
    specs = dict(zip([x for x, _ in leaves_with_path(param_shapes(cfg))], _specs(cfg, shape)))
    assert _model_dim(specs["['layers']['attn']['wq']"]) == 1  # (L, d, H, D): its input d
    assert _model_dim(specs["['layers']['attn']['wo']"]) == 3  # (L, H, D, d): its output d


def test_granite_baseline_cells_take_the_contraction_split():
    """granite-moe-3b-a800m's 24 heads on the baseline 16 x 16 mesh (1,536
    divides 16, 24 does not): each of its three cells is planned and its
    collectives are modelled."""
    cfg = get_config(GRANITE)
    mesh = _abstract((16, 16))
    for mode in ("train", "serve"):
        assert tp_model.unsupported(cfg, mesh, mode) is None
        p = _plan(cfg, (16, 16), mode)
        assert (p.attn, p.kv, p.experts, p.partial) == ("contraction", "whole", (0, 3),
                                                         frozenset())
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert dryrun.collectives_reason(build_case(GRANITE, shape), mesh) is None


# ------------------------------------------------------------------ gloo groups


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_cp_step_matches_one_process_step(ranks, arch, shape, over):
    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch, over)
    want, losses, norms = _one_process_steps(cfg, params_np, batch_np)
    for r in res:
        assert _rel(r[f"{tag}/losses"], losses) < TOL
        assert _rel(r[f"{tag}/grad_norms"], norms) < TOL
        for i, w in enumerate(want):
            assert _rel(r[f"{tag}/p{i}"], w) < PARAM_TOL, i
    g = _grads_np(cfg, params_np, batch_np)
    for i, (path, spec) in enumerate(zip(g, _specs(cfg, shape))):
        for m, got in enumerate(_model_blocks(res, tag, i, shape)):
            block = _block(g[path], spec, shape, m)
            assert got.shape == block.shape
            assert float(np.abs(got - block).max()) <= TOL * float(np.abs(g[path]).max()), path


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_cp_step_update_follows_its_gradient(ranks, arch, shape, over):
    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(arch, over)
    ps = leaves(params_from_numpy(copy.deepcopy(params_np), "cpu"))
    state = optim.init(ps)
    for s in range(STEPS):
        _, state, _ = optim.update(OCFG, _assembled_grads(res, tag, cfg, shape, s), state, ps,
                                   donate=True)
    for r in res:
        for i, x in enumerate(ps):
            assert _rel(r[f"{tag}/p{i}"], x.numpy()) < UPDATE_TOL, i


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_cp_whole_leaves_are_not_summed(ranks, arch, shape, over):
    """``wk``, ``wv``, ``q_norm`` and ``k_norm``: each rank's gradient is the
    whole one-process gradient (it runs the whole core on the whole ``q``),
    not a share to be summed over "model"; ``wq`` and ``wo`` hold 1/m."""
    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch, over)
    plan = _plan(cfg, shape)
    g = _grads_np(cfg, params_np, batch_np)
    m = shape[1]
    seen = set()
    for i, (path, x) in enumerate(leaves_with_path(param_shapes(cfg))):
        if "['attn']" not in path:
            continue
        name = _name(path)
        for r in res:
            local = tuple(r[f"{tag}/pshape{i}"])
            assert math.prod(local) * (m if name in ("wq", "wo") else 1) == x.numel(), path
        if name in WHOLE:
            seen.add(name)
            assert path not in plan.partial and path not in plan.split
            tol = TOL * float(np.abs(g[path]).max())
            assert float(np.abs(g[path]).max()) > 0, path
            for part in _model_blocks(res, tag, i, shape):
                assert float(np.abs(part - g[path]).max()) <= tol, path
    assert seen == set(WHOLE) if cfg.qk_norm else seen == {"wk", "wv"}


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_cp_step_collectives_closed_form(ranks, arch, shape, over):
    """``chip_smoke.cp_collectives`` over "model", plus the data-parallel
    mean (each leaf's block, the loss) and a MoE's load-balance means."""
    tag = _tag(arch, shape, over)
    cfg = smoke_config(arch, dtype="float32", **over)
    plan = _plan(cfg, shape)
    dn, m = shape
    want = list(cp_collectives(cfg, plan, BATCH // dn, SEQ))
    if dn > 1:
        for path, x in leaves_with_path(param_shapes(cfg)):
            want.append(("all-reduce", x.numel() * 4 // (m if path in plan.split else 1), dn))
        want.append(("all-reduce", 4, dn))
        if cfg.family == "moe":
            want += [("all-reduce", 2 * cfg.moe.num_experts * 4, dn)] * cfg.n_layers
    want = sorted(want)
    for r in _rank_results(ranks, shape):
        got = sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                         r[f"{tag}/ops_groups"].tolist()))
        assert got == want


def test_cp_step_matches_reference_gspmd_step(ranks):
    """Granite's placed step on (2, 2) against the reference's GSPMD step on
    the same mesh: losses and params within ``REF_TOL``; the first step's
    gradient, put together from the ranks' blocks, within ``REF_TOL`` of the
    reference's ``jax.grad`` relative to each leaf's largest element; each
    param's update ``p - p0`` within ``REF_TOL`` of the reference's largest
    update of that leaf (two AdamW steps move a param by about 2 lr, so the
    params' own bound would not see a wrong gradient), at the elements whose
    first gradient is at least ``GRAD_FLOOR``: AdamW's first update
    ``g / (|g| + eps)`` turns the float32 summation noise of a cancelling
    element near eps into a different update (here an expert ``down``
    element of 2e-8: the one-process port's own update misses the
    reference's by 6e-3 of the largest there, by 1.4e-4 above the floor)."""
    _, ref = ranks
    shape = (2, 2)
    tag = _tag(GRANITE, shape, H3)
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(GRANITE, H3)
    p0 = [x.numpy() for x in leaves(params_from_numpy(params_np, "cpu"))]
    assert f"g{len(p0)}" not in ref
    for i, got in enumerate(_assembled_grads(res, tag, cfg, shape, 0)):
        want = ref[f"g{i}"]
        assert float(np.abs(want).max()) > 0, i
        assert _rel(got.numpy(), want) < REF_TOL, i
    for r in res:
        assert np.abs(r[f"{tag}/losses"] - ref["losses"]).max() < REF_TOL
        for i, x0 in enumerate(p0):
            assert np.abs(r[f"{tag}/p{i}"] - ref[f"p{i}"]).max() < REF_TOL, i
            keep = np.abs(ref[f"g{i}"]) >= GRAD_FLOOR
            assert keep.any(), i
            du, dr = r[f"{tag}/p{i}"] - x0, ref[f"p{i}"] - x0
            assert np.abs(du - dr)[keep].max() < REF_TOL * np.abs(dr).max(), i
        assert f"{tag}/p{len(p0)}" not in r and f"p{len(p0)}" not in ref


@pytest.mark.parametrize("arch,shape,over,new,mode", SERVE_CASES, ids=_SERVE_IDS)
def test_placed_generate_matches_one_process(ranks, arch, shape, over, new, mode):
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import generate

    tag = _tag(arch, shape, over) + f"/{new}"
    res = _rank_results(ranks, shape)
    cfg, params_np, prompts_np = serve_inputs(arch, over)
    params = params_from_numpy(params_np, "cpu")
    prompts = torch.from_numpy(prompts_np)
    ref = generate(params, cfg, prompts, new)
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, SERVE_PROMPT + new)
        step_logits, _ = decode_step(params, cfg, cache, ref.tokens[:, :1].to(torch.int32))
    whole_k = tuple(cache["k"].shape)
    for r in res:
        assert str(r[f"{tag}/mode"]) == mode
        np.testing.assert_array_equal(r[f"{tag}/tokens"], ref.tokens.numpy())
        assert float(np.abs(r[f"{tag}/logprobs"] - ref.logprobs.numpy()).max()) <= TOL
        k = tuple(r[f"{tag}/kshape"])  # every kv head, all or 1/m of the positions
        assert k == tuple(n // shape[1] if d == 2 and mode == "seq" else n
                          for d, n in enumerate(whole_k))
    for key, want in (("prefill", logits), ("decode", step_logits)):
        got = np.concatenate([r[f"{tag}/{key}"] for r in res], axis=-1)
        assert _rel(got, want.numpy()) <= TOL, key


@pytest.mark.parametrize("arch,shape,over,new,mode", SERVE_CASES, ids=_SERVE_IDS)
def test_decode_collectives_closed_form(ranks, arch, shape, over, new, mode):
    tag = _tag(arch, shape, over) + f"/{new}"
    cfg = smoke_config(arch, dtype="float32", **over)
    want = cp_collectives(cfg, _plan(cfg, shape, "serve"), SERVE_BATCH, 1, mode)
    for r in _rank_results(ranks, shape):
        got = sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                         r[f"{tag}/ops_groups"].tolist()))
        assert got == want


# ------------------------------------------------------------------ the meta dry run


CP_CELLS = [(a, s) for a in (INTERNLM, GRANITE) for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CP_CELLS, ids=[f"{a}-{s}" for a, s in CP_CELLS])
def test_meta_dryrun_cp_smoke_cells_model_collectives(arch, shape):
    from repro_torch import roofline
    from test_torch_tp import _smoke_overrides

    over = _smoke_overrides(arch)
    case = build_case(arch, shape, **over)
    cfg = case.cfg
    assert cfg.n_heads % 8 and cfg.d_model % 8 == 0
    assert _plan(cfg, (2, 8)).attn == "contraction"
    rec = dryrun.run_cell(arch, shape, False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 8))
    assert rec["status"] == "ok" and rec["collectives_modelled"] is True
    assert set(rec["collectives"]) == {"all-reduce", "all-gather"}
    sp = SHAPES[shape]
    assert roofline.analyse(rec, sp.seq_len, sp.global_batch, cfg).collective_s > 0
    # the queries' float32 sum over the 8 "model" ranks, once a layer, of one
    # device's rows (the batch splits over the two "data" ranks); the
    # vocab-split embedding's sum has the same size (H x D = d here) where
    # the cell's embedding is float32 (the train step's params)
    tokens = sp.global_batch // 2 * (1 if shape == "decode_32k" else sp.seq_len)
    assert cfg.n_heads * cfg.resolved_head_dim == cfg.d_model
    qsum = [op for op in rec["collective_ops"]
            if op["bytes"] == tokens * cfg.d_model * 4
            and op["kind"] == "all-reduce" and op["group"] == 8]
    embed32 = case.args[0]["embed"].element_size() == 4
    assert len(qsum) == cfg.n_layers + (_plan(cfg, (2, 8)).embed == "vocab" and embed32)
