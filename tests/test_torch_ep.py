"""repro_torch's expert parallelism over "model" on the CPU: the MoE
family's plan and block (``launch/tp_model.py``), the placed step
(``step.py``), placed serving (``serve.py``) and the dry run's MoE cells.

* One rank, in process (a one-rank gloo group and a (1, 1) mesh): the
  expert-parallel forward, loss, two placed steps and the placed greedy
  ``generate`` of the smoke granite-moe-3b-a800m and qwen3-moe-30b-a3b are
  bitwise equal to ``models.forward`` / ``lm_loss``,
  ``train.make_train_step``'s two steps and ``serve.generate``.
* The plan read from the rules (an ``AbstractMesh``, no group): the expert
  range and the router split at m = 2, 4, 8, the padded experts of each
  rank, the reason given for a ``d_ff`` split of the experts, and
  attention's contraction split of granite's baseline 16 x 16.
* gloo groups of 2 and 4 ranks (separate processes, ``_run_ranks`` of
  ``test_torch_distributed.py``): the smoke granite on (1, 2) (kv heads
  split), (2, 2) and (1, 4) (kv heads replicated; rank 3 holds only padded
  experts), the smoke qwen3-moe (FSDP in training, "data" of one rank) on
  (1, 2) and (1, 4).  On every rank:

  - the routing of a fixed input (``tp_model.moe_route``: expert choices,
    capacity slots, kept choices) equal to ``models.moe.route``'s, and the
    rank's expert buffers within 1e-6 of the one-process buffers' block of
    experts, capacity-bounded and dropless;
  - two placed steps at float32: each rank's gradient block, before any
    reduction, within ``TOL`` = 1e-5 of the one-process gradient of its
    rows, losses and grad norms within ``TOL``, the parameters within 1e-6
    of the one-process AdamW of the gradient assembled from the blocks and
    within ``PARAM_TOL`` = 2e-4 of the one-process step
    (``test_torch_tp.py`` gives the reasons);
  - the router's gradient blocks, put together over "model", within 1e-5
    of the one-process router gradient: whole, through ``copy_to_model`` of
    the routing's outputs (the trap ``tp_model``'s docstring describes);
  - a split leaf's parameter and gradient blocks 1/m of the whole; a
    whole leaf's gradient whole on every rank;
  - the step's and a decode's recorded collectives equal to a closed form
    (the dense part of ``test_torch_tp.py``'s, and per MoE layer the
    router's gather and the backward sum of ``top_p``);
  - granite's step within 5e-3 of the reference's own GSPMD step on the
    same (2, 2) mesh (a subprocess with 4 forced host devices): losses,
    params, the first gradient relative to each leaf's largest element and
    each param's update relative to the reference's largest update.

  The placed greedy ``generate`` on (1, 2) and (1, 4) for both configs:
  tokens equal to the one-process port's, log-probabilities and the
  prefill's and a decode step's logits within 1e-5.
* The meta dry run of the MoE smoke cells on a 2 x 4 stand-in mesh:
  granite's three cells and qwen3-moe's three modelled; qwen3-moe's train
  cell is FSDP-placed (EP x FSDP, 4 microbatches), its schedule equal to
  ``chip_smoke.fsdp_collectives``.
"""

import copy
import dataclasses
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

from chip_smoke import draw_params
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import build_case, dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.specs import TRAIN_MICROBATCHES
from repro_torch.models import moe as _moe
from repro_torch.train import make_train_step
from repro_torch.train.step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = 1e-5  # gradients, losses, grad norms, logits: summation order only
BUFFER_TOL = 1e-6  # a rank's expert buffers vs the one-process buffers' block
UPDATE_TOL = 1e-6  # params vs the one-process AdamW on the assembled gradient
PARAM_TOL = 2e-4  # params vs the one-process step (AdamW's elementwise scaling)
REF_TOL = 5e-3  # vs the reference's GSPMD step (tests/test_distributed.py)
STEPS = 2
BATCH, SEQ = 8, 32
GRANITE, QWEN = "granite-moe-3b-a800m", "qwen3-moe-30b-a3b"
ARCHS = (GRANITE, QWEN)
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)
ROUTE_BATCH = 4  # rows of the fixed routing input: 4 x 32 tokens, 4 groups of 32

STEP_CASES = [(GRANITE, (1, 2)), (GRANITE, (2, 2)), (GRANITE, (1, 4)), (QWEN, (1, 2)),
              (QWEN, (1, 4))]
# (arch, mesh, new tokens, the cache's placement): prompts of 8, so a cache
# of 12 splits 4 ways on its sequence and one of 11 does not
SERVE_CASES = [(GRANITE, (1, 2), 4, "heads"), (GRANITE, (1, 4), 4, "seq"),
               (QWEN, (1, 2), 4, "heads"), (QWEN, (1, 4), 3, "whole")]
SERVE_BATCH, SERVE_PROMPT = 2, 8
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}


def _tag(arch: str, mesh: tuple) -> str:
    return f"{arch}@{'x'.join(map(str, mesh))}"


def step_inputs(arch: str):
    cfg = smoke_config(arch, dtype="float32")
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
             for k in ("tokens", "labels")}
    return cfg, params, batch


def serve_inputs(arch: str):
    cfg = smoke_config(arch, dtype="float32")
    params = draw_params(cfg, np.random.default_rng(0))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                                                dtype=np.int32)
    return cfg, params, prompts


def route_input(cfg) -> np.ndarray:
    return np.random.default_rng(3).standard_normal((ROUTE_BATCH, SEQ, cfg.d_model),
                                                    dtype=np.float32)


def _ops_arrays(ops: list) -> dict:
    return {"kinds": np.array([o["kind"] for o in ops]),
            "bytes": np.array([o["bytes"] for o in ops], dtype=np.int64),
            "groups": np.array([o["group"] for o in ops], dtype=np.int64)}


# ------------------------------------------------------------------ the ranks' work


@torch.no_grad()
def _routing(arch, shape, mesh) -> dict:
    """Layer 0's routing and expert buffers of a fixed input on this rank."""
    from repro_torch.launch import serve as ps
    from repro_torch.models.transformer import _layer

    tag = _tag(arch, shape)
    cfg, params_np, _ = step_inputs(arch)
    local = ps.shard_params(cfg, mesh, params_from_numpy(params_np, "cpu"))
    plan = tp_model.make_plan(cfg, mesh, "serve")
    x = torch.from_numpy(route_input(cfg))
    out = {f"{tag}/experts": np.array(plan.experts)}
    for dropless in (False, True):
        r, _, expert_in = tp_model.moe_dispatch(_layer(local["layers"], 0)["moe"], x, plan,
                                                   dropless)
        for k in ("top_e", "pos", "keep", "top_p"):
            out[f"{tag}/{dropless}/{k}"] = getattr(r, k).numpy()
        out[f"{tag}/{dropless}/expert_in"] = expert_in.numpy()
    return out


def _placed_steps(arch, shape, mesh) -> dict:
    from repro_torch import _obs_hooks
    from repro_torch.launch.step import gather, make_placed_train_step, place_state
    from repro_torch.roofline import record_collectives

    tag = _tag(arch, shape)
    cfg, params_np, batch_np = step_inputs(arch)
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
def _placed_serve(arch, shape, new, mesh) -> dict:
    from repro_torch.launch import serve as ps
    from repro_torch.roofline import record_collectives

    tag = _tag(arch, shape) + f"/{new}"
    cfg, params_np, prompts_np = serve_inputs(arch)
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
           f"{tag}/mode": np.array(mode)}
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(ops).items()})
    return out


def run_rank(world: int) -> dict:
    """Everything one rank of a ``world``-rank gloo group computes."""
    from repro_torch.launch.mesh import _device_mesh

    out = {}
    for shape in MESHES[world]:
        mesh = _device_mesh(shape, ("data", "model"), "cpu")
        for arch, m in STEP_CASES:
            if m == shape:
                out.update(_routing(arch, m, mesh))
                out.update(_placed_steps(arch, m, mesh))
        for arch, m, new, _ in SERVE_CASES:
            if m == shape:
                out.update(_placed_serve(arch, m, new, mesh))
    return out


_WORKER = """
    import sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out + "/store", rank=rank,
                            world_size=world)
    from test_torch_ep import run_rank
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
    from test_torch_ep import GRANITE, STEPS, step_inputs
    out = sys.argv[3]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = smoke_config(GRANITE, dtype="float32")
    _, params, batch = step_inputs(GRANITE)
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
        tmp = tmp_path_factory.mktemp(f"ep{world}")
        _run_ranks(tmp, _WORKER, world)
        out[world] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    ref = tmp_path_factory.mktemp("ep_reference")
    (ref / "reference.py").write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    run = subprocess.run([sys.executable, str(ref / "reference.py"), "0", "1", str(ref)],
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


def _specs(cfg, shape) -> list:
    from repro_torch.launch.sharding import params_shardings
    from repro_torch.models import param_shapes

    return [sh.spec for sh in leaves(params_shardings(cfg, _abstract(shape), param_shapes(cfg)))]


def _model_dim(spec):
    return next((d for d, e in enumerate(spec)
                 if e is not None and "model" in (e if isinstance(e, tuple) else (e,))), None)


def _block(x: np.ndarray, spec, shape, model_index: int) -> np.ndarray:
    """Model rank ``model_index``'s block of ``x`` under ``spec``."""
    idx = [slice(None)] * x.ndim
    d = _model_dim(spec)
    if d is not None:
        n = x.shape[d] // shape[1]
        idx[d] = slice(model_index * n, (model_index + 1) * n)
    return x[tuple(idx)]


def _grads_np(cfg, params_np, batch_np, rows) -> dict:
    """path -> the one-process gradient of the batch's ``rows``."""
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    local = {k: torch.from_numpy(v[rows]) for k, v in batch_np.items()}
    _, g = value_and_grad(make_loss_fn(cfg), params, local)
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


_STEP_IDS = [_tag(a, m) for a, m in STEP_CASES]


def _model_blocks(res, tag: str, i: int, shape) -> list:
    """Leaf ``i``'s step-1 gradient block of each "model" rank, before any
    reduction, averaged over the "data" ranks: the load-balance loss's means
    are the whole batch's, so one data rank's gradient is not that of a
    one-process loss on its rows, but their mean is the whole batch's."""
    dn, mn = shape
    return [sum(res[d * mn + m][f"{tag}/g0_{i}"] for d in range(dn)) / dn for m in range(mn)]


# ------------------------------------------------------------------ one rank, in process


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import _device_mesh

    tmp = tmp_path_factory.mktemp("ep_one_rank")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        yield _device_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_one_process_step_bitwise(one_rank, arch):
    from repro_torch.launch import serve as ps
    from repro_torch.launch.step import make_placed_train_step, place_state
    from repro_torch.models import forward, lm_loss
    from repro_torch.serve import generate

    cfg, params_np, batch_np = step_inputs(arch)
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    plan = tp_model.make_plan(cfg, one_rank)
    assert plan.experts == (0, cfg.moe.padded_experts) and plan.split == frozenset()
    h, aux = tp_model.forward(params, plan, batch["tokens"])
    want_h, want_aux = forward(params, cfg, tokens=batch["tokens"])
    assert torch.equal(h, want_h) and torch.equal(aux, want_aux) and float(aux) > 0
    loss = tp_model.make_loss_fn(plan)(params, batch)
    assert torch.equal(loss, lm_loss(params, cfg, want_h, batch["labels"]) + want_aux)
    p, o = place_state(cfg, one_rank, params)
    step = make_placed_train_step(cfg, OCFG, one_rank)
    got = []
    for _ in range(STEPS):
        p, o, m = step(p, o, batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    want, losses, norms = _one_process_steps(cfg, params_np, batch_np)
    assert got == list(zip(losses, norms))
    for a, b in zip(leaves(p), want):
        assert torch.equal(a.to_local(), torch.from_numpy(b))
    _, sp, prompts = serve_inputs(arch)
    whole = params_from_numpy(sp, "cpu")
    res = ps.generate(ps.shard_params(cfg, one_rank, whole), cfg, one_rank,
                      torch.from_numpy(prompts), 4)
    ref = generate(whole, cfg, torch.from_numpy(prompts), 4)
    assert torch.equal(res.tokens, ref.tokens) and torch.equal(res.logprobs, ref.logprobs)


# ------------------------------------------------------------------ the plan


def _padded_by_rank(cfg, m: int) -> list:
    """How many of each rank's experts are padded ones."""
    e, real = cfg.moe.padded_experts, cfg.moe.num_experts
    n = e // m
    return [sum(x >= real for x in range(r * n, (r + 1) * n)) for r in range(m)]


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_reads_the_expert_split_from_the_rules(arch):
    cfg = get_config(arch)
    e = cfg.moe.padded_experts
    for m in (2, 4, 8):
        plan = _plan(cfg, (1, m))
        assert plan.experts == (0, e // m)  # a stand-in group is rank 0
        names = {p.rsplit("['", 1)[-1].rstrip("']") for p in plan.split if "['moe']" in p}
        assert names == {"router", "gate", "up", "down"}
        assert not any("['moe']" in p or "mlp_norm" in p for p in plan.partial)
        specs = dict(zip([p for p, _ in leaves_with_path(cfg_shapes(cfg))], _specs(cfg, (1, m))))
        assert _model_dim(specs["['layers']['moe']['router']"]) == 2  # (L, d, E): its columns
        assert _model_dim(specs["['layers']['moe']['gate']"]) == 1  # (L, E, d, ff): experts
    assert _plan(cfg, (2, 1)).experts == (0, e) and _plan(cfg, (2, 1)).split == frozenset()


def cfg_shapes(cfg):
    from repro_torch.models import param_shapes

    return param_shapes(cfg)


def test_padded_experts_by_rank_and_the_reasons():
    # granite pads 40 experts to 48: on 16 ranks of 3, ranks 14 and 15 hold
    # padded experts only and rank 13 one real one
    assert _padded_by_rank(get_config(GRANITE), 16) == [0] * 13 + [2, 3, 3]
    assert _padded_by_rank(smoke_config(GRANITE), 4) == [0, 0, 1, 2]
    assert _padded_by_rank(smoke_config(GRANITE), 2) == [0, 3]
    assert _padded_by_rank(get_config(QWEN), 16) == [0] * 16
    # 5 experts, unpadded, on 2 ranks: the rules split the experts' d_ff
    five = smoke_config(GRANITE, moe=dataclasses.replace(smoke_config(GRANITE).moe,
                                                          pad_experts_to=None))
    reason = tp_model.unsupported(five, _abstract((1, 2)))
    assert "experts' d_ff" in reason and "expert axis" in reason
    with pytest.raises(ValueError, match="experts' d_ff"):
        _plan(five, (1, 2))
    # granite's 24 heads on the baseline 16 x 16: attention's contraction;
    # on the optimized profile's 32 x 8 the heads split
    assert tp_model.unsupported(get_config(GRANITE), _abstract((16, 16))) is None
    assert _plan(get_config(GRANITE), (16, 16)).attn == "contraction"
    assert tp_model.unsupported(get_config(GRANITE), _abstract((32, 8))) is None
    assert _plan(get_config(GRANITE), (32, 8)).attn == "heads"
    assert tp_model.unsupported(get_config(QWEN), _abstract((16, 16)), "serve") is None


# ------------------------------------------------------------------ gloo groups


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=_STEP_IDS)
def test_routing_equals_the_one_process_routing(ranks, arch, shape):
    tag = _tag(arch, shape)
    cfg = smoke_config(arch, dtype="float32")
    _, params_np, _ = step_inputs(arch)
    lp = {k: torch.from_numpy(v[0]) for k, v in params_np["layers"]["moe"].items()}
    x = torch.from_numpy(route_input(cfg))
    e, m = cfg.moe.padded_experts, shape[1]
    for dropless in (False, True):
        r = _moe.route(lp["router"], x, cfg, dropless)
        dispatch, _ = _moe.dispatch_combine(r, 0, e, x.dtype)
        whole = torch.einsum("gsec,gsd->gecd", dispatch, r.xg).numpy()
        for rank, res in enumerate(_rank_results(ranks, shape)):
            lo, hi = res[f"{tag}/experts"]
            assert (lo, hi) == ((rank % m) * e // m, (rank % m + 1) * e // m)
            for k in ("top_e", "pos", "keep", "top_p"):
                np.testing.assert_array_equal(res[f"{tag}/{dropless}/{k}"],
                                              getattr(r, k).numpy(), err_msg=k)
            got = res[f"{tag}/{dropless}/expert_in"]
            assert got.shape == whole[:, lo:hi].shape
            assert float(np.abs(got - whole[:, lo:hi]).max()) <= BUFFER_TOL
            if lo >= cfg.moe.num_experts:  # padded experts only: no token
                assert not got.any()


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=_STEP_IDS)
def test_ep_step_matches_one_process_step(ranks, arch, shape):
    tag = _tag(arch, shape)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch)
    want, losses, norms = _one_process_steps(cfg, params_np, batch_np)
    for r in res:
        assert _rel(r[f"{tag}/losses"], losses) < TOL
        assert _rel(r[f"{tag}/grad_norms"], norms) < TOL
        for i, w in enumerate(want):
            assert _rel(r[f"{tag}/p{i}"], w) < PARAM_TOL, i
    plan = _plan(cfg, shape)
    g = _grads_np(cfg, params_np, batch_np, slice(None))
    for i, (path, spec) in enumerate(zip(g, _specs(cfg, shape))):
        if path in plan.partial:
            continue  # summed over "model": test_ep_step_shards_and_whole_gradients
        for m, got in enumerate(_model_blocks(res, tag, i, shape)):
            block = _block(g[path], spec, shape, m)
            assert got.shape == block.shape
            assert float(np.abs(got - block).max()) <= TOL * float(np.abs(g[path]).max()), path


def _assembled_grads(res, tag: str, cfg, shape, s: int) -> list:
    """Step ``s``'s whole gradient, leaf by leaf, from the ranks' blocks: a
    split leaf's blocks concatenated, a partial leaf's summed over "model",
    a whole leaf's taken once; then averaged over "data"."""
    specs = _specs(cfg, shape)
    paths = [p for p, _ in leaves_with_path(cfg_shapes(cfg))]
    partial = _plan(cfg, shape).partial
    dn, mn = shape
    grads = []
    for i, (spec, path) in enumerate(zip(specs, paths)):
        per_data = []
        for d in range(dn):
            blocks = [torch.from_numpy(res[d * mn + m][f"{tag}/g{s}_{i}"]) for m in range(mn)]
            dim = _model_dim(spec)
            if dim is not None:
                per_data.append(torch.cat(blocks, dim=dim))
            elif path in partial:
                per_data.append(sum(blocks[1:], blocks[0]))
            else:
                per_data.append(blocks[0])
        g = sum(per_data[1:], per_data[0])
        grads.append(g / dn if dn > 1 else g)
    return grads


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=_STEP_IDS)
def test_ep_step_update_follows_its_gradient(ranks, arch, shape):
    """The parameters are the one-process AdamW of the gradient assembled
    here from the ranks' blocks."""
    tag = _tag(arch, shape)
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(arch)
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    ps = leaves(params)
    state = optim.init(ps)
    for s in range(STEPS):
        grads = _assembled_grads(res, tag, cfg, shape, s)
        _, state, _ = optim.update(OCFG, grads, state, ps, donate=True)
    for r in res:
        for i, x in enumerate(ps):
            assert _rel(r[f"{tag}/p{i}"], x.numpy()) < UPDATE_TOL, i


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=_STEP_IDS)
def test_router_gradient_is_whole(ranks, arch, shape):
    """The router's blocks, put together over "model", are the one-process
    router gradient of the rows: ``copy_to_model`` of ``xg`` and ``top_p``
    sums each rank's share of the logits' gradient.  Its expert blocks are
    the experts' own gradients: zero on a rank holding padded experts."""
    tag = _tag(arch, shape)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch)
    paths = [p for p, _ in leaves_with_path(cfg_shapes(cfg))]
    i = paths.index("['layers']['moe']['router']")
    gi = paths.index("['layers']['moe']['gate']")
    want = _grads_np(cfg, params_np, batch_np, slice(None))["['layers']['moe']['router']"]
    got = np.concatenate(_model_blocks(res, tag, i, shape), axis=-1)
    assert float(np.abs(want).max()) > 0
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())
    for r in res:
        if r[f"{tag}/experts"][0] >= cfg.moe.num_experts:
            assert not r[f"{tag}/g0_{gi}"].any()


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=_STEP_IDS)
def test_ep_step_shards_and_whole_gradients(ranks, arch, shape):
    """A split leaf's param and gradient blocks are 1/m of the whole (the
    experts and the router among them); no MoE leaf is partial; a whole
    leaf's gradient is whole on every rank."""
    tag = _tag(arch, shape)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch)
    plan = _plan(cfg, shape)
    m = shape[1]
    g = _grads_np(cfg, params_np, batch_np, slice(None))
    assert {p for p in plan.split if "['moe']" in p} == {
        f"['layers']['moe']['{k}']" for k in ("router", "gate", "up", "down")}
    assert not any("['moe']" in p for p in plan.partial)
    for i, (path, x) in enumerate(leaves_with_path(cfg_shapes(cfg))):
        for r in res:
            local = tuple(r[f"{tag}/pshape{i}"])
            assert tuple(r[f"{tag}/g0_{i}"].shape) == local, path
            split = path in plan.split
            assert math.prod(local) * (m if split else 1) == x.numel(), path
            assert r[f"{tag}/g0_{i}"].nbytes * (m if split else 1) == x.numel() * 4, path
        tol = TOL * float(np.abs(g[path]).max())
        parts = _model_blocks(res, tag, i, shape)
        if path in plan.partial:  # a partial sum on each rank: the sum is whole
            assert float(np.abs(sum(parts[1:], parts[0]) - g[path]).max()) <= tol, path
        elif path not in plan.split:  # whole on every rank, not m times
            for part in parts:
                assert float(np.abs(part - g[path]).max()) <= tol, path
            for r in res[1:]:
                np.testing.assert_array_equal(r[f"{tag}/p{i}"], res[0][f"{tag}/p{i}"])


def _moe_layer_ops(cfg, rows: int, m: int) -> list:
    """Per MoE layer, on top of a dense layer's: the router's gather and the
    backward sum of ``top_p`` (float32 at this dtype)."""
    return [("all-gather", cfg.d_model * cfg.moe.padded_experts * 4, m),
            ("all-reduce", rows * SEQ * cfg.moe.top_k * 4, m)]


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=_STEP_IDS)
def test_ep_step_collectives_closed_form(ranks, arch, shape):
    """Per MoE layer: attention's forward and backward all-reduces, the
    combine's all-reduce and ``copy_to_model``'s backward sum of ``xg``
    (the dense form's four), the router's gather and the sum of ``top_p``;
    over "data", the load-balance loss's means; then the embedding, head,
    loss, partial leaves, norm and the data-parallel mean of
    ``test_torch_tp.py``'s closed form."""
    from test_torch_tp import _step_closed_form

    tag = _tag(arch, shape)
    cfg = smoke_config(arch, dtype="float32")
    rows = BATCH // shape[0]
    want = _step_closed_form(cfg, shape, _plan(cfg, shape))
    if shape[1] > 1:
        want += _moe_layer_ops(cfg, rows, shape[1]) * cfg.n_layers
    if shape[0] > 1:  # the load-balance loss's two means over "data"
        want += [("all-reduce", 2 * cfg.moe.num_experts * 4, shape[0])] * cfg.n_layers
    want = sorted(want)
    for r in _rank_results(ranks, shape):
        got = sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                         r[f"{tag}/ops_groups"].tolist()))
        assert got == want


def test_ep_step_matches_reference_gspmd_step(ranks):
    """Granite's placed step on (2, 2) against the reference's GSPMD step on
    the same mesh: the losses and the params within ``REF_TOL``; the first
    step's gradient, put together from the ranks' blocks, within
    ``REF_TOL`` of the reference's ``jax.grad`` relative to each leaf's
    largest element; each param's update ``p - p0`` within ``REF_TOL`` of
    the reference's largest update of that leaf.  Two AdamW steps move a
    param by about 2 lr, so the params' own bound would not see a wrong
    gradient (the router's, say, zero, flipped or 1/m of the whole)."""
    _, ref = ranks
    shape = (2, 2)
    tag = _tag(GRANITE, shape)
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(GRANITE)
    p0 = [x.numpy() for x in leaves(params_from_numpy(params_np, "cpu"))]
    ref_grads = [ref[f"g{i}"] for i in range(len(p0))]
    assert f"g{len(p0)}" not in ref
    for i, (got, want) in enumerate(zip(_assembled_grads(res, tag, cfg, shape, 0), ref_grads)):
        assert float(np.abs(want).max()) > 0, i
        assert _rel(got.numpy(), want) < REF_TOL, i
    for r in res:
        assert np.abs(r[f"{tag}/losses"] - ref["losses"]).max() < REF_TOL
        for i, x0 in enumerate(p0):
            assert np.abs(r[f"{tag}/p{i}"] - ref[f"p{i}"]).max() < REF_TOL, i
            assert _rel(r[f"{tag}/p{i}"] - x0, ref[f"p{i}"] - x0) < REF_TOL, i
        assert f"{tag}/p{len(p0)}" not in r and f"p{len(p0)}" not in ref


@pytest.mark.parametrize("arch,shape,new,mode", SERVE_CASES,
                         ids=[f"{a}@{m[1]}-{mode}" for a, m, _, mode in SERVE_CASES])
def test_placed_generate_matches_one_process(ranks, arch, shape, new, mode):
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import generate

    tag = _tag(arch, shape) + f"/{new}"
    res = _rank_results(ranks, shape)
    cfg, params_np, prompts_np = serve_inputs(arch)
    params = params_from_numpy(params_np, "cpu")
    prompts = torch.from_numpy(prompts_np)
    ref = generate(params, cfg, prompts, new)
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, SERVE_PROMPT + new)
        step_logits, _ = decode_step(params, cfg, cache, ref.tokens[:, :1].to(torch.int32))
    for r in res:
        assert str(r[f"{tag}/mode"]) == mode
        np.testing.assert_array_equal(r[f"{tag}/tokens"], ref.tokens.numpy())
        assert float(np.abs(r[f"{tag}/logprobs"] - ref.logprobs.numpy()).max()) <= TOL
    for key, want in (("prefill", logits), ("decode", step_logits)):
        got = np.concatenate([r[f"{tag}/{key}"] for r in res], axis=-1)
        assert _rel(got, want.numpy()) <= TOL, key


@pytest.mark.parametrize("arch,shape,new,mode", SERVE_CASES,
                         ids=[f"{a}@{m[1]}-{mode}" for a, m, _, mode in SERVE_CASES])
def test_decode_collectives_closed_form(ranks, arch, shape, new, mode):
    """Per layer: attention's and the combine's all-reduces and the
    router's gather (split-K adds the queries' gather, a MAX and a SUM);
    the embedding's all-reduce."""
    tag = _tag(arch, shape) + f"/{new}"
    cfg = smoke_config(arch, dtype="float32")
    m, b, f = shape[1], SERVE_BATCH, 4
    hd = cfg.resolved_head_dim
    per_layer = [("all-reduce", b * cfg.d_model * f, m)] * 2 + [
        ("all-gather", cfg.d_model * cfg.moe.padded_experts * f, m)]
    if mode == "seq":
        rep = cfg.n_heads // cfg.n_kv_heads
        per_layer += [("all-gather", b * cfg.n_heads * hd * f, m),
                      ("all-reduce", b * cfg.n_kv_heads * rep * f, m),
                      ("all-reduce", b * cfg.n_kv_heads * rep * (hd + 1) * f, m)]
    want = sorted([("all-reduce", b * cfg.d_model * f, m)] + per_layer * cfg.n_layers)
    for r in _rank_results(ranks, shape):
        got = sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                         r[f"{tag}/ops_groups"].tolist()))
        assert got == want


# ------------------------------------------------------------------ the meta dry run


MOE_CELLS = [(GRANITE, s) for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    (QWEN, s) for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", MOE_CELLS, ids=[f"{a}-{s}" for a, s in MOE_CELLS])
def test_meta_dryrun_moe_smoke_cells_model_collectives(arch, shape):
    from repro_torch import roofline
    from test_torch_tp import _smoke_overrides

    over = _smoke_overrides(arch)
    rec = dryrun.run_cell(arch, shape, False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 4))
    assert rec["status"] == "ok" and rec["collectives_modelled"] is True
    sp = SHAPES[shape]
    cfg = build_case(arch, shape, **over).cfg
    fsdp = cfg.fsdp and sp.kind == "train"
    assert set(rec["collectives"]) == {"all-reduce", "all-gather"} | (
        {"reduce-scatter"} if fsdp else set())
    assert roofline.analyse(rec, sp.seq_len, sp.global_batch, cfg).collective_s > 0
    # one router gather of d x E a layer (bf16), over the 4 "model" ranks;
    # under FSDP twice a layer (the recompute) in each of the cell's
    # microbatches, and the schedule is the closed form's
    mb = TRAIN_MICROBATCHES[arch] if fsdp else 1
    gathers = [op for op in rec["collective_ops"] if op["kind"] == "all-gather"
               and op["bytes"] == cfg.d_model * cfg.moe.padded_experts * 2 and op["group"] == 4]
    assert sum(op["trip"] for op in gathers) == cfg.n_layers * (2 * mb if fsdp else 1)
    if fsdp:
        from chip_smoke import fsdp_collectives

        plan = _plan(cfg, (2, 4))
        got = sorted((o["kind"], o["bytes"], o["group"]) for o in rec["collective_ops"]
                     for _ in range(o["trip"]))
        assert got == fsdp_collectives(cfg, plan, sp.global_batch // 2, sp.seq_len, mb)
        return
    # the activation all-reduces over "model" of one device's rows
    tokens = sp.global_batch // 2 * (1 if shape == "decode_32k" else sp.seq_len)
    acts = [op for op in rec["collective_ops"]
            if op["bytes"] == tokens * cfg.d_model * 2 and op["group"] == 4]
    assert len(acts) >= (4 if shape == "train_4k" else 2) * cfg.n_layers
