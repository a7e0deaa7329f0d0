"""repro_torch's tensor-parallel "model" axis on the CPU (``launch/tp.py``,
``tp_model.py``, the placed step ``step.py``, placed serving ``serve.py``
and the dry run's collective term).

* One rank, in process (a one-rank gloo group and a (1, 1) mesh): the
  operators return their input; the tensor-parallel forward, loss and two
  placed steps of the smoke internlm2-1.8b, qwen3-4b and gemma-7b are
  bitwise equal to ``models.forward`` / ``lm_loss`` and
  ``train.make_train_step``'s, and the placed greedy ``generate`` to
  ``serve.generate``.
* The plan read from the rules (an ``AbstractMesh``, no group): head and
  kv-head splits, the replicated kv of GQA, the partial leaves, the ``d``
  split of a vocabulary the axis does not divide, attention's contraction
  split on a wide axis, the vlm family's plan, and the reasons given for
  what the forward does not run.
* gloo groups of 2 and 4 ranks (separate processes, ``_run_ranks`` of
  ``test_torch_distributed.py``): meshes (1, 2), (2, 2) and (1, 4) on the
  smoke internlm2-1.8b (kv heads split at m = 2, replicated at m = 4),
  qwen3-4b (``qk_norm``) and gemma-7b (tied, ``head_dim`` 32), and
  internlm2-1.8b with a 258-token vocabulary on (1, 4) (``embed`` and
  ``head`` split on d).  Two placed steps at float32:

  - each rank's gradient block, before any reduction, against the
    one-process gradient of its rows, and the losses and grad norms, within
    ``TOL`` = 1e-5 (a summation-order difference only);
  - the parameters within 1e-6 of the one-process AdamW applied to the
    gradient assembled from the ranks' blocks in the test (partial leaves
    summed over "model", the mean over "data"), and within ``PARAM_TOL`` =
    2e-4 of the one-process step's parameters: AdamW divides each element
    by its own magnitude, so an element whose gradient is tiny and
    cancels (~1e-7 after clipping, near the optimizer's eps) carries the
    few-percent summation noise of its float32 gradient into its update;
  - the reference's own GSPMD step on the same (2, 2) mesh (its own
    subprocess with 4 forced host devices, as ``tests/test_distributed.py``)
    within its 5e-3;
  - a "model"-split leaf's parameter and gradient blocks are 1/m of the
    whole; a partial leaf's gradients differ across the model ranks and sum
    to the whole; a whole leaf's (a norm) equals the whole on every rank;
  - the step's recorded collectives equal a closed form (per layer two
    forward and two backward activation all-reduces; the embedding's; the
    head's backward; the vocab-parallel loss's MAX and SUM; the partial
    leaves; the norm; the data-parallel mean).

  The smoke granite-moe-3b-a800m with 5 unpadded experts on (1, 2), whose
  experts the rules split on their d_ff, a split the tensor-parallel
  forward does not run: the step gathers every leaf at use (an all-gather is
  recorded), each rank's gradient is the whole one-process gradient, the
  storage stays placed, losses and params as above.  (Attention's
  contraction split, where the heads do not divide "model", is
  ``tests/test_torch_cp.py``'s.)

  The placed greedy ``generate`` on (1, 2) and (1, 4): tokens equal to the
  one-process port's, log-probabilities and the prefill's and a decode
  step's logits within 1e-5, with the cache split on kv heads, on its
  sequence (split-K) and whole; a decode step's collectives equal a
  closed form.
* ``compressed_psum`` over ("pod", "data") of a (2, 2, 1) mesh, the group
  the placed step uses: int8_ef sums and error buffers, unordered and
  egress-ordered, bit-exact with the reference's ``shard_map`` over
  ("pod", "data") on 4 host devices; the placed int8_ef step's error
  buffers over two steps bit-exact with the reference's fed the step's own
  gradients.
* The meta dry run of each dense smoke cell on a 2 x 4 stand-in mesh has
  ``collectives_modelled: True``, collective ops and a collective term;
  so have the FSDP train cells (internvl2-26b's, qwen3-moe-30b-a3b's),
  with FSDP's reduce-scatters (``tests/test_torch_fsdp.py`` holds their
  schedule to its closed form).
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

from chip_smoke import draw_params
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import build_case, dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.config import MoEConfig
from repro_torch.launch.tp import (AxisGroup, all_reduce, copy_to_model, gather_from_model,
                                   reduce_from_model)
from repro_torch.train import make_train_step
from repro_torch.train.step import make_loss_fn, value_and_grad
from test_torch_distributed import PSUM, _run_ranks, psum_inputs, psum_perm

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = 1e-5  # gradients, losses, grad norms, logits: summation order only
UPDATE_TOL = 1e-6  # params vs the one-process AdamW on the assembled gradient
PARAM_TOL = 2e-4  # params vs the one-process step (AdamW's elementwise scaling)
REF_TOL = 5e-3  # vs the reference's GSPMD step (tests/test_distributed.py)
STEPS = 2
BATCH, SEQ = 8, 32
ARCHS = ("internlm2-1.8b", "qwen3-4b", "gemma-7b")
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)


def _tag(arch: str, mesh: tuple, over: dict | None = None) -> str:
    extra = "".join(f"-{k}{v}" for k, v in sorted((over or {}).items()))
    return f"{arch}{extra}@{'x'.join(map(str, mesh))}"


# (arch, mesh, overrides): every arch on every mesh, and a vocabulary that
# 4 does not divide
STEP_CASES = [(a, m, {}) for m in ((1, 2), (2, 2), (1, 4)) for a in ARCHS] + [
    ("internlm2-1.8b", (1, 4), {"vocab": 258})]
# (arch, mesh, new tokens, the cache's placement): prompts of 8, so a cache
# of 12 splits 4 ways on its sequence and one of 11 does not
SERVE_CASES = [("internlm2-1.8b", (1, 2), 4, "heads"), ("gemma-7b", (1, 4), 4, "heads"),
               ("internlm2-1.8b", (1, 4), 4, "seq"), ("qwen3-4b", (1, 4), 4, "seq"),
               ("internlm2-1.8b", (1, 4), 3, "whole")]
SERVE_BATCH, SERVE_PROMPT = 2, 8
# a family the tensor-parallel forward does not run (the rules split the SSD's
# in_proj / out_proj and the tied embedding), so the step gathers
# experts the axis does not divide (5, unpadded, on 2 ranks): the rules
# split the experts' d_ff, which the tensor-parallel forward does not run
GATHER_CASE = ("granite-moe-3b-a800m", (1, 2),
               {"moe": MoEConfig(num_experts=5, top_k=2, d_ff_expert=64, capacity_factor=2.0,
                                 group_size=32, pad_experts_to=None)})
POD_STEP = ("internlm2-1.8b", {"d_model": 64, "n_heads": 4, "n_kv_heads": 4})
POD_BLOCK = 64
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}


def step_inputs(arch: str, over: dict | None = None):
    cfg = smoke_config(arch, dtype="float32", **(over or {}))
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
           f"{tag}/mode": np.array(mode), f"{tag}/kshape": np.array(cache["k"].shape)}
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(ops).items()})
    return out


def _pod(rank: int) -> dict:
    """compressed_psum over the ("pod", "data") group of a (2, 2, 1) mesh, and
    two int8_ef placed steps on it."""
    from repro_torch import _obs_hooks
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.launch.step import make_placed_train_step, place_state
    from repro_torch.launch.tp import axis_group

    mesh = _device_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    dp = axis_group(mesh, ("pod", "data"))
    out = {"pod/index": np.array(dp.index)}
    perm, inv = (torch.from_numpy(a) for a in psum_perm())
    for ordered in (False, True):
        g, e = psum_inputs(dp.index, PSUM["m_ordered"] if ordered else PSUM["m"])
        cfg = optim.CompressionConfig(mode="int8_ef", block=PSUM["block"],
                                      use_egress_ordering=ordered)
        kw = {"perm": perm, "inv_perm": inv} if ordered else {}
        s, ne = optim.compressed_psum(torch.from_numpy(g), torch.from_numpy(e), cfg, dp.group,
                                      **kw)
        out[f"pod/{ordered}/sum"], out[f"pod/{ordered}/error"] = s.numpy(), ne.numpy()
    arch, over = POD_STEP
    cfg, params_np, batch_np = step_inputs(arch, over)
    params = params_from_numpy(params_np, "cpu")
    p, o = place_state(cfg, mesh, params)
    step = make_placed_train_step(cfg, OCFG, mesh, compression=optim.CompressionConfig(
        mode="int8_ef", block=POD_BLOCK))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    flats = []
    _obs_hooks.TAP = SimpleNamespace(tap=lambda kind, payload: flats.append(
        torch.cat([g.reshape(-1) for g in leaves(payload["grads"])])))
    try:
        for s in range(STEPS):
            p, o, _ = step(p, o, batch)
            out[f"pod/step{s}/flat"] = flats[-1].numpy()
            out[f"pod/step{s}/error"] = step.error.numpy().copy()
    finally:
        _obs_hooks.TAP = None
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
        for arch, m, new, _ in SERVE_CASES:
            if m == shape:
                out.update(_placed_serve(arch, m, new, mesh))
        if GATHER_CASE[1] == shape:
            out.update(_placed_steps(*GATHER_CASE, mesh))
    if world == 4:
        out.update(_pod(torch.distributed.get_rank()))
    return out


_WORKER = """
    import sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out + "/store", rank=rank,
                            world_size=world)
    from test_torch_tp import run_rank
    np.savez(out + f"/rank{rank}.npz", **run_rank(world))
    dist.destroy_process_group()
"""

_REFERENCE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import smoke_config
    from repro.launch.sharding import batch_shardings, opt_shardings, params_shardings
    from repro.optim import AdamWConfig, CompressionConfig, compressed_psum
    from repro.optim import init as opt_init
    from repro.train import make_train_step
    from test_torch_tp import (ARCHS, POD_BLOCK, STEPS, psum_inputs, psum_perm, PSUM,
                               step_inputs)
    out, pods = sys.argv[3], sys.argv[4]
    res = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch in ARCHS:
        cfg = smoke_config(arch, dtype="float32")
        _, params, batch = step_inputs(arch)
        params = jax.tree.map(jnp.asarray, params)
        batch = jax.tree.map(jnp.asarray, batch)
        opt = opt_init(params)
        shape = lambda t: jax.eval_shape(lambda: t)
        p_sh = params_shardings(cfg, mesh, shape(params))
        o_sh = opt_shardings(cfg, mesh, shape(opt), shape(params))
        b_sh = batch_shardings(cfg, mesh, {k: shape(v) for k, v in batch.items()})
        step = jax.jit(make_train_step(cfg, AdamWConfig(total_steps=10, warmup_steps=1)),
                       in_shardings=(p_sh, o_sh, b_sh))
        losses = []
        with mesh:
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
        res[arch + "/losses"] = np.array(losses)
        for i, x in enumerate(jax.tree.leaves(params)):
            res[f"{arch}/p{i}"] = np.asarray(x)
    pod = jax.make_mesh((2, 2), ("pod", "data"))
    perm, inv = (jnp.asarray(a) for a in psum_perm())

    def psum_over_pod(g, e, cfg, *extra):
        def f(g, e):
            s, ne = compressed_psum(g[0], e[0], cfg, ("pod", "data"), *extra)
            return s[None], ne[None]
        spec = P(("pod", "data"))
        with pod:
            s, ne = jax.jit(shard_map(f, mesh=pod, in_specs=(spec, spec),
                                      out_specs=(spec, spec)))(g, e)
        return np.asarray(s), np.asarray(ne)

    for ordered in (False, True):
        m = PSUM["m_ordered"] if ordered else PSUM["m"]
        g, e = (np.stack(x) for x in zip(*(psum_inputs(r, m) for r in range(4))))
        cfg = CompressionConfig(mode="int8_ef", block=PSUM["block"], use_egress_ordering=ordered)
        s, ne = psum_over_pod(g, e, cfg, *((perm, inv) if ordered else ()))
        res[f"pod/{ordered}/sum"], res[f"pod/{ordered}/error"] = s, ne
    ranks = [dict(np.load(pods + f"/rank{r}.npz")) for r in range(4)]
    order = np.argsort([int(r["pod/index"]) for r in ranks])
    cfg = CompressionConfig(mode="int8_ef", block=POD_BLOCK)
    err = np.zeros_like(np.stack([ranks[i]["pod/step0/flat"] for i in order]))
    for s in range(STEPS):
        flat = np.stack([ranks[i][f"pod/step{s}/flat"] for i in order])
        _, err = psum_over_pod(flat, err, cfg)
        res[f"pod/step{s}/error"] = err
    np.savez(out + "/reference.npz", **res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]} and the reference's results."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        _run_ranks(tmp, _WORKER, world)
        out[world] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    ref = tmp_path_factory.mktemp("tp_reference")
    (ref / "reference.py").write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    run = subprocess.run([sys.executable, str(ref / "reference.py"), "0", "1", str(ref),
                          str(tmp)], capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    return out, dict(np.load(ref / "reference.npz"))


def _world(shape: tuple) -> int:
    return shape[0] * shape[1]


def _rank_results(ranks, shape) -> list:
    """The results of the ranks of ``shape``'s group, in rank order (rank =
    data index x m + model index)."""
    return ranks[0][_world(shape)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _abstract(shape) -> AbstractMesh:
    return AbstractMesh(tuple(shape), ("data", "model"))


def _specs(cfg, shape) -> list:
    from repro_torch.launch.sharding import params_shardings
    from repro_torch.models import param_shapes

    return [sh.spec for sh in leaves(params_shardings(cfg, _abstract(shape), param_shapes(cfg)))]


def _block(x: np.ndarray, spec, shape, model_index: int) -> np.ndarray:
    """Model rank ``model_index``'s block of ``x`` under ``spec``."""
    idx = [slice(None)] * x.ndim
    for d, e in enumerate(spec):
        if e == "model":
            n = x.shape[d] // shape[1]
            idx[d] = slice(model_index * n, (model_index + 1) * n)
    return x[tuple(idx)]


def _grads_np(cfg, params_np, batch_np, rows) -> dict:
    """path -> the one-process gradient of the batch's ``rows``, in leaf
    order."""
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


# ------------------------------------------------------------------ one rank, in process


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import _device_mesh

    tmp = tmp_path_factory.mktemp("one_rank")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        yield _device_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_operators_on_one_rank_and_on_a_stand_in():
    from repro_torch.roofline import record_collectives

    x = torch.randn(3, 4)
    one = AxisGroup(1)
    assert copy_to_model(x, one) is x and reduce_from_model(x, one) is x
    assert gather_from_model(x, one) is x and all_reduce(x, one) is x
    stand_in = AxisGroup(4, 2)
    with pytest.raises(ValueError, match="meta tensors only"):
        all_reduce(x, stand_in)
    with record_collectives() as ops:
        y = reduce_from_model(x.to("meta"), stand_in)
        z = gather_from_model(torch.empty((2, 5, 3), device="meta"), stand_in, 1)
    assert y.shape == (3, 4) and z.shape == (2, 20, 3)
    assert ops == [{"kind": "all-reduce", "bytes": 48, "group": 4, "trip": 1},
                   {"kind": "all-gather", "bytes": 480, "group": 4, "trip": 1}]


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
    h, _ = tp_model.forward(params, plan, batch["tokens"])
    want_h, _ = forward(params, cfg, tokens=batch["tokens"])
    assert torch.equal(h, want_h)
    assert torch.equal(tp_model.loss(params, plan, h, batch["labels"]),
                       lm_loss(params, cfg, want_h, batch["labels"]))
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


def test_plan_reads_the_rules():
    def plan(arch, shape, **over):
        return tp_model.make_plan(smoke_config(arch, **over), _abstract(shape))

    def names(paths):
        return sorted(p.rsplit("['", 1)[-1].rstrip("']") for p in paths)

    p = plan("internlm2-1.8b", (1, 2))
    assert (p.attn, p.kv, p.kv_index, p.mlp, p.embed, p.head) == (
        "heads", "heads", None, True, "vocab", "vocab")
    assert p.partial == frozenset() and (p.local.n_heads, p.local.n_kv_heads) == (2, 1)
    p = plan("internlm2-1.8b", (1, 4))
    assert (p.kv, p.kv_index, names(p.partial)) == ("whole", (0,), ["wk", "wv"])
    assert names(plan("qwen3-4b", (1, 2)).partial) == ["k_norm", "q_norm"]
    assert names(plan("qwen3-4b", (1, 4)).partial) == ["k_norm", "q_norm", "wk", "wv"]
    p = plan("gemma-7b", (1, 4))
    assert (p.kv, p.head, p.partial, p.local.resolved_head_dim) == (
        "heads", "vocab", frozenset(), 32)
    # H = 12, hkv = 3 on 2 ranks: six query heads read kv heads 0 0 0 0 1 1
    p = tp_model.make_plan(smoke_config("internlm2-1.8b", n_heads=12, n_kv_heads=3,
                                        d_model=96), _abstract((1, 2)))
    assert p.kv_index == (0, 0, 0, 0, 1, 1) and p.local.n_kv_heads == 6
    p = plan("internlm2-1.8b", (1, 4), vocab=258)
    assert (p.embed, p.head) == ("d", "d")
    # 4 heads on 16 ranks, d_model 64: attention splits on its contraction
    assert tp_model.unsupported(smoke_config("internlm2-1.8b"), _abstract((16, 16))) is None
    p = plan("internlm2-1.8b", (1, 16))
    assert (p.attn, p.kv, p.local, p.partial) == ("contraction", "whole", p.cfg, frozenset())
    # the vlm family: the dense splits (tests/test_torch_vlm_tp.py runs them)
    p = plan("internvl2-26b", (1, 2))
    assert (p.attn, p.kv, p.kv_index, p.mlp, p.embed, p.head, p.partial) == (
        "heads", "heads", None, True, "vocab", "vocab", frozenset())
    assert (p.local.n_heads, p.local.n_kv_heads) == (2, 1)
    assert plan("internlm2-1.8b", (2, 1)).split == frozenset()


# ------------------------------------------------------------------ gloo groups


@pytest.mark.parametrize("arch,shape,over", STEP_CASES,
                         ids=[_tag(a, m, o) for a, m, o in STEP_CASES])
def test_tp_step_matches_one_process_step(ranks, arch, shape, over):
    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch, over)
    want, losses, norms = _one_process_steps(cfg, params_np, batch_np)
    for r in res:
        assert _rel(r[f"{tag}/losses"], losses) < TOL
        assert _rel(r[f"{tag}/grad_norms"], norms) < TOL
        for i, w in enumerate(want):
            assert _rel(r[f"{tag}/p{i}"], w) < PARAM_TOL, i
    # step 1's gradient blocks, before any reduction: the one-process
    # gradient of the rank's rows
    rows = BATCH // shape[0]
    for rank, r in enumerate(res):
        d, m = divmod(rank, shape[1])
        g = _grads_np(cfg, params_np, batch_np, slice(d * rows, (d + 1) * rows))
        plan = tp_model.make_plan(cfg, _abstract(shape))
        for i, (path, spec) in enumerate(zip(g, _specs(cfg, shape))):
            if path in plan.partial:
                continue  # test_tp_step_shards_and_partial_gradients
            got, block = r[f"{tag}/g0_{i}"], _block(g[path], spec, shape, m)
            assert got.shape == block.shape
            assert float(np.abs(got - block).max()) <= TOL * float(np.abs(g[path]).max()), path


@pytest.mark.parametrize("arch,shape,over", STEP_CASES,
                         ids=[_tag(a, m, o) for a, m, o in STEP_CASES])
def test_tp_step_update_follows_its_gradient(ranks, arch, shape, over):
    """The parameters are the one-process AdamW of the gradient assembled
    here from the ranks' blocks: blocks placed, partial leaves summed over
    "model", the mean over "data"."""
    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(arch, over)
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    ps = leaves(params)
    specs = _specs(cfg, shape)
    paths = [p for p, _ in leaves_with_path(params)]
    partial = tp_model.make_plan(cfg, _abstract(shape)).partial
    state = optim.init(ps)
    dn, mn = shape
    for s in range(STEPS):
        grads = []
        for i, (x, spec, path) in enumerate(zip(ps, specs, paths)):
            per_data = []
            for d in range(dn):
                blocks = [torch.from_numpy(res[d * mn + m][f"{tag}/g{s}_{i}"]) for m in range(mn)]
                dim = next((k for k, e in enumerate(spec) if e == "model"), None)
                if dim is not None:
                    per_data.append(torch.cat(blocks, dim=dim))
                elif path in partial:
                    per_data.append(sum(blocks[1:], blocks[0]))
                else:
                    per_data.append(blocks[0])
            g = sum(per_data[1:], per_data[0])
            grads.append(g / dn if dn > 1 else g)
        _, state, _ = optim.update(OCFG, grads, state, ps, donate=True)
    for r in res:
        for i, x in enumerate(ps):
            assert _rel(r[f"{tag}/p{i}"], x.numpy()) < UPDATE_TOL, i


def test_step_gathers_where_the_forward_does_not_split(ranks):
    """A split the tensor-parallel forward does not run (experts split on
    their d_ff): the step gathers every leaf at use and each rank of the
    "model" group computes the whole product, its storage still placed by
    the rules."""
    from repro_torch.models import param_shapes

    arch, shape, over = GATHER_CASE
    tag = _tag(arch, shape, over)
    cfg, params_np, batch_np = step_inputs(arch, over)
    assert "experts' d_ff" in tp_model.unsupported(cfg, _abstract(shape))
    want, losses, norms = _one_process_steps(cfg, params_np, batch_np)
    g = _grads_np(cfg, params_np, batch_np, slice(None))
    whole = [tuple(x.shape) for x in leaves(param_shapes(cfg))]
    specs = _specs(cfg, shape)
    assert sum("model" in tuple(sp) for sp in specs) >= 3  # embed, attention, experts
    for r in _rank_results(ranks, shape):
        assert _rel(r[f"{tag}/losses"], losses) < TOL
        assert _rel(r[f"{tag}/grad_norms"], norms) < TOL
        for i, w in enumerate(want):
            assert _rel(r[f"{tag}/p{i}"], w) < PARAM_TOL, i
        for i, (path, x) in enumerate(g.items()):
            got = r[f"{tag}/g0_{i}"]  # whole on every rank: one data rank
            assert got.shape == x.shape
            assert float(np.abs(got - x).max()) <= TOL * float(np.abs(x).max()), path
        for i, (n, sp) in enumerate(zip(whole, specs)):
            split = [m if e == "model" else 1 for e, m in zip(tuple(sp), (shape[1],) * len(n))]
            assert tuple(r[f"{tag}/pshape{i}"]) == tuple(
                d // k for d, k in zip(n, split + [1] * (len(n) - len(split)))), i
        assert "all-gather" in set(r[f"{tag}/ops_kinds"])


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_reference_gspmd_step(ranks, arch):
    _, ref = ranks
    res = _rank_results(ranks, (2, 2))
    tag = _tag(arch, (2, 2))
    for r in res:
        assert np.abs(r[f"{tag}/losses"] - ref[f"{arch}/losses"]).max() < REF_TOL
        i = 0
        while f"{arch}/p{i}" in ref:
            assert np.abs(r[f"{tag}/p{i}"] - ref[f"{arch}/p{i}"]).max() < REF_TOL, i
            i += 1
        assert f"{tag}/p{i}" not in r and i > 0


@pytest.mark.parametrize("arch,shape,over", STEP_CASES,
                         ids=[_tag(a, m, o) for a, m, o in STEP_CASES])
def test_tp_step_shards_and_partial_gradients(ranks, arch, shape, over):
    from repro_torch.models import param_shapes

    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch, over)
    plan = tp_model.make_plan(cfg, _abstract(shape))
    whole = param_shapes(cfg)
    rows = BATCH // shape[0]
    m = shape[1]
    kinds = set()
    for i, (path, x) in enumerate(leaves_with_path(whole)):
        for rank, r in enumerate(res):
            local = tuple(r[f"{tag}/pshape{i}"])
            grad = r[f"{tag}/g0_{i}"]
            assert tuple(grad.shape) == local, path
            split = path in plan.split
            assert math.prod(local) * (m if split else 1) == x.numel(), path
        for d in range(shape[0]):
            group = res[d * m: (d + 1) * m]
            g = _grads_np(cfg, params_np, batch_np, slice(d * rows, (d + 1) * rows))
            tol = TOL * float(np.abs(g[path]).max())
            if path in plan.partial:  # a partial sum on each rank: the sum is whole
                kinds.add("partial")
                parts = [r[f"{tag}/g0_{i}"] for r in group]
                assert all(float(np.abs(a - b).max()) > tol for a, b in zip(parts, parts[1:]))
                assert float(np.abs(sum(parts[1:], parts[0]) - g[path]).max()) <= tol, path
            elif path not in plan.split:  # whole on every rank, not m times
                kinds.add("whole")
                for r in group:
                    assert float(np.abs(r[f"{tag}/g0_{i}"] - g[path]).max()) <= tol, path
            # every rank of a "model" group ends with the same replicated leaf
            if path not in plan.split:
                for r in group[1:]:
                    np.testing.assert_array_equal(r[f"{tag}/p{i}"], group[0][f"{tag}/p{i}"])
    assert "whole" in kinds and (("partial" in kinds) == bool(plan.partial))


def _step_closed_form(cfg, shape, plan) -> list:
    """(kind, bytes, group) of every collective of one placed step."""
    from repro_torch.models import param_shapes

    whole = param_shapes(cfg)
    dn, m = shape
    b, f = BATCH // dn, 4  # float32
    act = b * SEQ * cfg.d_model * f
    ops = []
    if m > 1:
        ops += [("all-reduce", act, m)] * (4 * cfg.n_layers)  # attn + mlp, fwd + bwd
        if plan.embed == "vocab":
            ops.append(("all-reduce", act, m))  # the masked lookup's sum
        else:
            ops.append(("all-gather", act, m))  # the lookup's columns
        ops.append(("all-reduce", act, m))  # the head input's gradient
        if plan.head == "vocab":  # the loss: MAX, then SUM of (sum exp, gold)
            ops += [("all-reduce", b * SEQ * f, m), ("all-reduce", 2 * b * SEQ * f, m)]
        else:  # the partial logits
            ops.append(("all-reduce", b * SEQ * cfg.vocab * f, m))
        for path, x in leaves_with_path(whole):
            if path in plan.partial:
                ops.append(("all-reduce", x.numel() * f, m))
        ops.append(("all-reduce", f, m))  # the norm's split squares
    if dn > 1:
        for path, x in leaves_with_path(whole):
            ops.append(("all-reduce", x.numel() * f // (m if path in plan.split else 1), dn))
        ops.append(("all-reduce", f, dn))  # the loss
    return sorted(ops)


@pytest.mark.parametrize("arch,shape,over", STEP_CASES,
                         ids=[_tag(a, m, o) for a, m, o in STEP_CASES])
def test_tp_step_collectives_closed_form(ranks, arch, shape, over):
    tag = _tag(arch, shape, over)
    cfg = smoke_config(arch, dtype="float32", **over)
    want = _step_closed_form(cfg, shape, tp_model.make_plan(cfg, _abstract(shape)))
    for r in _rank_results(ranks, shape):
        got = sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                         r[f"{tag}/ops_groups"].tolist()))
        assert got == want


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
    whole_k = tuple(cache["k"].shape)
    for r in res:
        assert str(r[f"{tag}/mode"]) == mode
        np.testing.assert_array_equal(r[f"{tag}/tokens"], ref.tokens.numpy())
        assert float(np.abs(r[f"{tag}/logprobs"] - ref.logprobs.numpy()).max()) <= TOL
        k = tuple(r[f"{tag}/kshape"])
        split = {"heads": 3, "seq": 2, "whole": None}[mode]
        assert k == tuple(n // shape[1] if d == split else n for d, n in enumerate(whole_k))
    for key, want in (("prefill", logits), ("decode", step_logits)):
        got = np.concatenate([r[f"{tag}/{key}"] for r in res], axis=-1)
        assert _rel(got, want.numpy()) <= TOL, key


@pytest.mark.parametrize("arch,shape,new,mode", SERVE_CASES,
                         ids=[f"{a}@{m[1]}-{mode}" for a, m, _, mode in SERVE_CASES])
def test_decode_collectives_closed_form(ranks, arch, shape, new, mode):
    tag = _tag(arch, shape) + f"/{new}"
    cfg = smoke_config(arch, dtype="float32")
    m, b, f = shape[1], SERVE_BATCH, 4
    hd = cfg.resolved_head_dim
    per_layer = [("all-reduce", b * cfg.d_model * f, m)] * 2  # attention + MLP outputs
    if mode == "seq":  # the queries gathered; the split-K merge: MAX, SUM
        rep = cfg.n_heads // cfg.n_kv_heads
        per_layer += [("all-gather", b * cfg.n_heads * hd * f, m),
                      ("all-reduce", b * cfg.n_kv_heads * rep * f, m),
                      ("all-reduce", b * cfg.n_kv_heads * rep * (hd + 1) * f, m)]
    want = sorted([("all-reduce", b * cfg.d_model * f, m)] + per_layer * cfg.n_layers)
    for r in _rank_results(ranks, shape):
        got = sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                         r[f"{tag}/ops_groups"].tolist()))
        assert got == want


@pytest.mark.parametrize("ordered", [False, True])
def test_compressed_psum_over_pod_and_data_matches_reference(ranks, ordered):
    res, ref = ranks[0][4], ranks[1]
    for r in res:
        i = int(r["pod/index"])
        np.testing.assert_array_equal(r[f"pod/{ordered}/sum"], ref[f"pod/{ordered}/sum"][i])
        np.testing.assert_array_equal(r[f"pod/{ordered}/error"].view(np.int32),
                                      ref[f"pod/{ordered}/error"][i].view(np.int32))


def test_placed_step_compressed_over_pod_and_data(ranks):
    res, ref = ranks[0][4], ranks[1]
    assert sorted(int(r["pod/index"]) for r in res) == [0, 1, 2, 3]
    for r in res:
        i = int(r["pod/index"])
        for s in range(STEPS):
            assert float(np.abs(r[f"pod/step{s}/error"]).max()) > 0
            np.testing.assert_array_equal(r[f"pod/step{s}/error"].view(np.int32),
                                          ref[f"pod/step{s}/error"][i].view(np.int32))


# ------------------------------------------------------------------ the meta dry run


def _smoke_overrides(arch: str) -> dict:
    import dataclasses

    from repro_torch.configs import get_config

    full, sm = get_config(arch), smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full, f.name)}


DENSE = ("internlm2-1.8b", "qwen3-4b", "codeqwen1.5-7b", "gemma-7b")


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_dryrun_dense_smoke_cells_model_collectives(arch, shape):
    from repro_torch import roofline

    rec = dryrun.run_cell(arch, shape, False, verbose=False,
                          cfg_overrides=_smoke_overrides(arch), mesh_shape=(2, 4))
    assert rec["status"] == "ok" and rec["mesh"] == "2x4" and rec["num_devices"] == 8
    assert rec["collectives_modelled"] is True and rec["collective_ops"]
    assert set(rec["collectives"]) <= {"all-reduce", "all-gather"}
    assert all(op["group"] in (2, 4) for op in rec["collective_ops"])
    sp = SHAPES[shape]
    terms = roofline.analyse(rec, sp.seq_len, sp.global_batch,
                             build_case(arch, shape, **_smoke_overrides(arch)).cfg)
    assert terms.collective_s > 0
    # the activation all-reduces over "model" of one device's rows (the
    # batch splits over the two "data" ranks in every dense cell)
    cfg = smoke_config(arch)
    tokens = sp.global_batch // 2 * (1 if shape == "decode_32k" else sp.seq_len)
    acts = [op for op in rec["collective_ops"]
            if op["bytes"] == tokens * cfg.d_model * 2 and op["group"] == 4]
    assert len(acts) >= (4 if shape == "train_4k" else 2) * cfg.n_layers


@pytest.mark.parametrize("arch,shape,why", [("internvl2-26b", "train_4k", "FSDP"),
                                            ("qwen3-moe-30b-a3b", "train_4k", "FSDP")])
def test_meta_dryrun_other_families_say_why(arch, shape, why):
    """The train cells of the FSDP configs, once refused for ``why``, are
    modelled: FSDP's gathers over "data" and the reduce-scatters of their
    gradients beside the "model" collectives, every data-split leaf's
    gathers twice its scatters a layer (the checkpoint's recompute), and a
    collective term (their serving cells are not FSDP-placed:
    tests/test_torch_vlm_tp.py, tests/test_torch_ep.py)."""
    from repro_torch import roofline
    from repro_torch.launch.specs import TRAIN_MICROBATCHES

    over = _smoke_overrides(arch)
    rec = dryrun.run_cell(arch, shape, False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 4))
    assert rec["collectives_modelled"] is True and "collectives_reason" not in rec
    assert why == "FSDP" and set(rec["collectives"]) == {"all-gather", "all-reduce",
                                                         "reduce-scatter"}
    case = build_case(arch, shape, **over)
    plan = tp_model.make_plan(case.cfg, AbstractMesh((2, 4), ("data", "model")))
    layer = [p for p in plan.fsdp if p.startswith("['layers']")]
    top, mb, n = len(plan.fsdp) - len(layer), TRAIN_MICROBATCHES[arch], case.cfg.n_layers
    ops = rec["collective_ops"]
    # "data" is the 2-rank axis of the stand-in: its gathers are FSDP's
    assert sum(o["trip"] for o in ops if o["kind"] == "all-gather" and o["group"] == 2) == (
        mb * (2 * n * len(layer) + top))
    assert sum(o["trip"] for o in ops if o["kind"] == "reduce-scatter") == mb * (
        n * len(layer) + top)
    sp = case.shape
    assert roofline.analyse(rec, sp.seq_len, sp.global_batch, case.cfg).collective_s > 0
