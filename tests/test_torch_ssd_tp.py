"""repro_torch's SSD split over "model" and long_500k's sequence-split cache
on the CPU: the ssm and hybrid families (mamba2-370m, zamba2-1.2b) with
``in_proj`` split on its ``d_model`` rows and ``out_proj`` on its
``d_inner`` rows (``launch/tp_model.py``'s ``ssd_block`` / ``ssd_decode``),
run by the placed step (``step.py``), placed serving (``serve.py``) and the
dry run.

* The plan read from the rules (an ``AbstractMesh``, no group): both full
  configs on 16 x 16 and 32 x 8 split the SSM heads ("heads"), with their
  heads, conv channel blocks and partial leaves; the smoke configs on
  16 x 16 run the core whole ("whole") between split projections.
* gloo groups of 2 and 4 ranks (separate processes, ``_run_ranks`` of
  ``test_torch_distributed.py``), smoke configs at float32: two placed
  steps of mamba2 and zamba2 on (1, 2), (2, 2) and (1, 4), and of mamba2
  with 2 SSM heads on (1, 4) (the "whole" core):

  - each rank's gradient block, before any reduction (averaged over
    "data"), within ``TOL`` of the one-process gradient, a partial leaf's
    blocks summed over "model"; losses and grad norms within ``TOL``;
    each step's against the one-process gradient at the same params;
    params after the first step within ``PARAM_TOL`` of the one-process
    step's where the gradient's sign is steady, and after both within
    ``UPDATE_TOL`` of the one-process AdamW of the assembled gradients;
  - the partial leaves (``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
    ``d_skip``, ``norm_w`` under "heads") summed and no other leaf summed;
  - the step's recorded collectives equal to ``chip_smoke.ssd_collectives``
    plus the data-parallel mean;
  - zamba2's (2, 2) step within 5e-3 of the reference's own GSPMD step (a
    subprocess with 4 forced host devices).

  The placed greedy ``generate`` on (1, 2), (2, 2) and the "whole" case's
  (1, 4): tokens equal to the one-process port's, log-probabilities and the
  prefill's and a decode step's logits within ``TOL``; a decode step's
  collectives equal to the closed form.

  SP decode: batch 1 with a 64-position cache whose sequence the rules
  split over "data" (zamba2 on (2, 1) and (2, 2), mamba2, with no KV cache,
  on (2, 1)), each rank's blocks cut from the one-process cache at position
  30 (a 16-token prefill and 14 decode steps); four decode steps cross the
  data ranks' boundary at 32.  Logits and each rank's new cache blocks within ``TOL`` of the
  one-process ``decode_step``'s; a step's collectives equal to the closed
  form.
* The meta dry run of the smoke serving cells, ``long_500k`` included, on
  a (2, 4) stand-in mesh: modelled, the projection's sum once a layer and
  zamba2's ``long_500k`` merging attention over "data".
"""

import copy
import math
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import draw_params, ssd_collectives
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path, unflatten_like
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import build_case, dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import param_shapes
from repro_torch.models.config import SSMConfig
from repro_torch.models.ssd import ssm_dims
from repro_torch.train import make_train_step
from repro_torch.train.step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
# gradients, losses, grad norms, logits: summation order only.  Twice
# test_torch_cp.py's 1e-5: the one-process float32 gradient of the smoke
# zamba2 is itself up to 7.1e-6 of a leaf's largest element off its float64
# gradient (mamba2's 4.4e-6), so two float32 runs that sum in other orders
# differ by up to twice that (1.13e-5 measured, zamba2 on (1, 4))
TOL = 2e-5
UPDATE_TOL = 1e-6  # params vs the one-process AdamW on the assembled gradient
PARAM_TOL = 2e-4  # params vs the one-process step (AdamW's elementwise scaling)
REF_TOL = 5e-3  # vs the reference's GSPMD step (tests/test_distributed.py)
STEPS = 2
BATCH, SEQ = 8, 32  # two chunks of the smoke configs' 16
MAMBA, ZAMBA = "mamba2-370m", "zamba2-1.2b"
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)
# two SSM heads of 64: "model" = 4 divides d_model 64 and d_inner 128, not the heads
H2 = {"ssm": SSMConfig(d_state=16, head_dim=64, expand=2, n_groups=1, d_conv=4, chunk=16)}
SMALL = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w")

STEP_CASES = [(MAMBA, (1, 2), {}), (MAMBA, (2, 2), {}), (MAMBA, (1, 4), {}),
              (ZAMBA, (1, 2), {}), (ZAMBA, (2, 2), {}), (ZAMBA, (1, 4), {}),
              (MAMBA, (1, 4), H2)]
SERVE_CASES = [(MAMBA, (1, 2), {}), (ZAMBA, (1, 2), {}), (MAMBA, (2, 2), {}),
               (ZAMBA, (2, 2), {}), (MAMBA, (1, 4), H2)]
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 8, 3
SP_CASES = [(ZAMBA, (2, 1)), (ZAMBA, (2, 2)), (MAMBA, (2, 1))]
SP_LEN, SP_PROMPT, SP_AT, SP_STEPS = 64, 16, 30, 4
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}


def _tag(arch: str, mesh: tuple, over: dict) -> str:
    extra = "-h2" if over else ""
    return f"{arch}{extra}@{'x'.join(map(str, mesh))}"


def _cfg(arch: str, over: dict):
    return smoke_config(arch, dtype="float32", **over)


def step_inputs(arch: str, over: dict):
    cfg = _cfg(arch, over)
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
             for k in ("tokens", "labels")}
    return cfg, params, batch


def serve_inputs(arch: str, over: dict, batch: int = SERVE_BATCH, prompt: int = SERVE_PROMPT):
    cfg = _cfg(arch, over)
    params = draw_params(cfg, np.random.default_rng(0))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (batch, prompt), dtype=np.int32)
    return cfg, params, prompts


def _ops_arrays(ops: list) -> dict:
    return {"kinds": np.array([o["kind"] for o in ops]),
            "bytes": np.array([o["bytes"] for o in ops], dtype=np.int64),
            "groups": np.array([o["group"] for o in ops], dtype=np.int64)}


def _ops_rows(r: dict, tag: str) -> list:
    return sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                      r[f"{tag}/ops_groups"].tolist()))


@torch.no_grad()
def sp_reference(arch: str) -> dict:
    """The one-process run SP decode is held to: the prefill of a
    ``SP_PROMPT``-token prompt into a ``SP_LEN`` cache and greedy decode
    steps up to position ``SP_AT`` (the cache handed to the ranks), then
    ``SP_STEPS`` more; each of those steps' tokens, logits and new cache."""
    from repro_torch.models import decode_step, prefill

    cfg, params_np, prompts = serve_inputs(arch, {}, 1, SP_PROMPT)
    params = params_from_numpy(params_np, "cpu")
    logits, cache = prefill(params, cfg, torch.from_numpy(prompts), SP_LEN)
    out = {"tokens": [], "logits": [], "caches": []}
    for s in range(SP_AT - SP_PROMPT + SP_STEPS):
        if s == SP_AT - SP_PROMPT:
            out["cache"] = cache
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, cache = decode_step(params, cfg, cache, tok)
        if s >= SP_AT - SP_PROMPT:
            out["tokens"].append(tok)
            out["logits"].append(logits)
            out["caches"].append(cache)
    return out


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
                out = {f"{tag}/q{j}": gather(x).numpy().copy() for j, x in enumerate(leaves(p))}
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        _obs_hooks.TAP = None
    out.update({f"{tag}/losses": np.array(losses), f"{tag}/grad_norms": np.array(norms)})
    for i, x in enumerate(leaves(p)):
        out[f"{tag}/p{i}"] = gather(x).numpy()
        out[f"{tag}/pshape{i}"] = np.array(x.to_local().shape)
    for s, gs in enumerate(tapped):
        for i, g in enumerate(gs):
            out[f"{tag}/g{s}_{i}"] = g.numpy()
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(first).items()})
    return out


@torch.no_grad()
def _placed_serve(arch, shape, over, mesh) -> dict:
    from repro_torch.launch import serve as ps
    from repro_torch.roofline import record_collectives

    tag = _tag(arch, shape, over) + "/serve"
    cfg, params_np, prompts_np = serve_inputs(arch, over)
    local = ps.shard_params(cfg, mesh, params_from_numpy(params_np, "cpu"))
    prompts = torch.from_numpy(prompts_np)
    res = ps.generate(local, cfg, mesh, prompts, SERVE_NEW)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    max_len = SERVE_PROMPT + SERVE_NEW
    mode = ps.kv_mode(cfg, mesh, SERVE_BATCH, max_len)
    rows = ps.shard_batch(cfg, mesh, {"tokens": prompts})["tokens"]
    logits, cache = ps.prefill(local, plan, rows, max_len, mode)
    with record_collectives() as ops:
        step_logits, _ = ps.decode_step(local, plan, cache, res.tokens[:, :1].to(torch.int32),
                                        mode)
    out = {f"{tag}/tokens": res.tokens.numpy(), f"{tag}/logprobs": res.logprobs.numpy(),
           f"{tag}/prefill": logits.numpy(), f"{tag}/decode": step_logits.numpy(),
           f"{tag}/mode": np.array(mode)}
    for key, t in leaves_with_path(cache.get("ssm", {})):
        out[f"{tag}/ssm{key}"] = np.array(t.shape)
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(ops).items()})
    return out


@torch.no_grad()
def _placed_sp(arch, shape, mesh) -> dict:
    """Each rank's blocks of the one-process cache (``cache_shardings``),
    then SP_STEPS placed decode steps fed the one-process tokens."""
    from repro_torch._tree import tree_map
    from repro_torch.launch import serve as ps
    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.launch.step import block
    from repro_torch.roofline import record_collectives

    tag = _tag(arch, shape, {}) + "/sp"
    cfg, params_np, _ = serve_inputs(arch, {}, 1, SP_PROMPT)
    local = ps.shard_params(cfg, mesh, params_from_numpy(params_np, "cpu"))
    ref = sp_reference(arch)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    mode, sp = ps.kv_mode(cfg, mesh, 1, SP_LEN), ps.sp_group(cfg, mesh, 1, SP_LEN)
    sh = cache_shardings(cfg, mesh, ref["cache"])
    cache = tree_map(block, ref["cache"], sh)
    out = {f"{tag}/mode": np.array(mode), f"{tag}/sp": np.array(sp.size)}
    for s in range(SP_STEPS):
        with record_collectives() as ops:
            logits, cache = ps.decode_step(local, plan, cache, ref["tokens"][s], mode, sp)
        out[f"{tag}/logits{s}"] = logits.numpy()
        for key, t in leaves_with_path(cache):
            out[f"{tag}/c{s}{key}"] = t.numpy()
        if s == 0:
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
        for arch, m, over in SERVE_CASES:
            if m == shape:
                out.update(_placed_serve(arch, m, over, mesh))
        for arch, m in SP_CASES:
            if m == shape:
                out.update(_placed_sp(arch, m, mesh))
    return out


_WORKER = """
    import sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out + "/store", rank=rank,
                            world_size=world)
    from test_torch_ssd_tp import run_rank
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
    from test_torch_ssd_tp import STEPS, ZAMBA, step_inputs
    out = sys.argv[1]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = smoke_config(ZAMBA, dtype="float32")
    _, params, batch = step_inputs(ZAMBA, {})
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
        for s in range(STEPS):
            params, opt = jax.device_put((params, opt), (p_sh, o_sh))
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            if s == 0:
                for i, x in enumerate(jax.tree.leaves(params)):
                    res[f"q{i}"] = np.asarray(x)
    res["losses"] = np.array(losses)
    for i, x in enumerate(jax.tree.leaves(params)):
        res[f"p{i}"] = np.asarray(x)
    np.savez(out + "/reference.npz", **res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]} and the reference's results; the
    reference's subprocess runs beside the ranks."""
    from test_torch_distributed import _run_ranks

    ref = tmp_path_factory.mktemp("ssd_reference")
    (ref / "reference.py").write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    reference = subprocess.Popen([sys.executable, str(ref / "reference.py"), str(ref)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env)
    try:
        tmps = {world: tmp_path_factory.mktemp(f"ssd{world}") for world in (2, 4)}
        with ThreadPoolExecutor(2) as pool:  # both groups at once
            for f in [pool.submit(_run_ranks, tmp, _WORKER, w) for w, tmp in tmps.items()]:
                f.result()
        out = {w: [dict(np.load(tmp / f"rank{r}.npz")) for r in range(w)]
               for w, tmp in tmps.items()}
        _, err = reference.communicate(timeout=TIMEOUT)
    finally:
        reference.kill()
    assert reference.returncode == 0, err[-3000:]
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


def _one_process_steps(cfg, params_np, batch_np, steps: int = STEPS):
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    step = make_train_step(cfg, OCFG, donate=True)
    state, losses, norms = optim.init(params), [], []
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return [x.numpy() for x in leaves(params)], losses, norms


def _model_blocks(res, tag: str, i: int, shape, s: int = 0) -> list:
    """Leaf ``i``'s step-``s`` gradient block of each "model" rank, before
    any reduction, averaged over the "data" ranks."""
    dn, mn = shape
    return [sum(res[d * mn + m][f"{tag}/g{s}_{i}"] for d in range(dn)) / dn for m in range(mn)]


def _assembled_grads(res, tag: str, cfg, shape, s: int) -> list:
    """Step ``s``'s whole gradient, leaf by leaf, from the ranks' blocks: a
    split leaf's blocks concatenated, a partial leaf's summed, a whole
    leaf's taken once."""
    plan = _plan(cfg, shape)
    grads = []
    for i, ((path, _), spec) in enumerate(zip(leaves_with_path(param_shapes(cfg)),
                                              _specs(cfg, shape))):
        blocks = _model_blocks(res, tag, i, shape, s)
        dim = _model_dim(spec)
        if dim is not None:
            g = np.concatenate(blocks, axis=dim)
        else:
            g = sum(blocks) if path in plan.partial else blocks[0]
        grads.append(torch.from_numpy(np.ascontiguousarray(g)))
    return grads


_STEP_IDS = [_tag(a, m, o) for a, m, o in STEP_CASES]
_SERVE_IDS = [_tag(a, m, o) for a, m, o in SERVE_CASES]
_SP_IDS = [_tag(a, m, {}) for a, m in SP_CASES]


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
@pytest.mark.parametrize("mesh", [(16, 16), (32, 8)], ids=["16x16", "32x8"])
def test_full_configs_split_the_ssm_heads(arch, mesh):
    cfg = get_config(arch)
    d_inner, n_heads, hd, g, n = ssm_dims(cfg)
    m = mesh[1]
    for mode in ("train", "serve"):
        assert tp_model.unsupported(cfg, _abstract(mesh), mode) is None
        p = _plan(cfg, mesh, mode)
        assert (p.ssd, p.ssd_heads, p.ssd_split) == ("heads", (0, n_heads // m), True)
        assert p.conv == ((d_inner + 2 * g * n) % m == 0)
        assert {_name(x) for x in p.partial} == set(SMALL)
        assert all("['ssd']" in x for x in p.partial)
        assert {_name(x) for x in p.split if "['ssd']" in x} == {"in_proj", "out_proj"}
        if arch == ZAMBA:  # the shared block: 32 heads, d_ff 8,192
            assert (p.attn, p.kv, p.mlp, p.local.n_heads) == ("heads", "heads", True, 32 // m)
    assert (n_heads // m) * hd == d_inner // m  # out_proj's rows are the heads' d_inner block


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_smoke_configs_run_the_core_whole_on_16x16(arch):
    cfg = smoke_config(arch)
    assert ssm_dims(cfg)[1] % 16 and cfg.d_model % 16 == 0
    p = _plan(cfg, (16, 16))
    assert (p.ssd, p.ssd_heads, p.ssd_split, p.partial) == ("whole", None, True, frozenset())
    assert _plan(smoke_config(arch), (1, 1)).split == frozenset()


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_plan_of_each_case(arch, shape, over):
    cfg = _cfg(arch, over)
    p = _plan(cfg, shape)
    assert p.ssd == ("whole" if over else "heads")
    assert p.ssd_split and bool(p.partial) is not bool(over)


# ------------------------------------------------------------------ gloo groups


def _steady(g: np.ndarray, tol: float) -> np.ndarray:
    """The elements of a first gradient ``g`` whose sign float32's summation
    order cannot flip: at least ``tol`` of the leaf's largest element.
    AdamW's first update is about ``lr * sign(g)``, so a cancelling element
    below that moves a param by up to 2 lr between two correct runs (a
    smoke zamba2 ``embed`` element: 1.3e-6 one-process, -5.7e-7 placed,
    of a leaf whose largest is 0.2)."""
    return np.abs(g) >= tol * np.abs(g).max()


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_ssd_step_matches_one_process_step(ranks, arch, shape, over):
    """Each step's gradient blocks, loss and grad norm within ``TOL`` of the
    one-process ones at the same params (the initial ones, then the placed
    run's after its first step); the params after the first step within
    ``PARAM_TOL`` of the one-process step's where the gradient's sign is
    steady.  After a second step a flipped cancelling element has moved its
    neighbours' gradients too (zamba2's ``embed`` row, 5e-3 of the leaf's
    largest param apart), so the second step is held by its gradient here
    and by :func:`test_ssd_step_update_follows_its_gradient`."""
    from repro_torch.optim.adamw import global_norm

    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch, over)
    want, _, _ = _one_process_steps(cfg, params_np, batch_np, 1)
    plan = _plan(cfg, shape)
    paths = [x for x, _ in leaves_with_path(param_shapes(cfg))]
    before = [params_np, unflatten_like(params_np, [res[0][f"{tag}/q{i}"]
                                                    for i in range(len(paths))])]
    for step, p in enumerate(before):
        loss, g = value_and_grad(make_loss_fn(cfg), params_from_numpy(copy.deepcopy(p), "cpu"),
                                 {k: torch.from_numpy(v) for k, v in batch_np.items()})
        norm = float(global_norm(g))
        g = {x: t.numpy() for x, t in leaves_with_path(g)}
        for r in res:
            assert _rel(r[f"{tag}/losses"][step], float(loss)) < TOL, step
            assert _rel(r[f"{tag}/grad_norms"][step], norm) < TOL, step
        for i, (path, spec) in enumerate(zip(paths, _specs(cfg, shape))):
            blocks = _model_blocks(res, tag, i, shape, step)
            if path in plan.partial:
                blocks = [sum(blocks)]
            tol = TOL * float(np.abs(g[path]).max())
            for m, got in enumerate(blocks):
                block = _block(g[path], spec, shape, m)
                assert got.shape == block.shape
                assert float(np.abs(got - block).max()) <= tol, (step, path)
        if step == 0:
            steady = [_steady(g[x], TOL) for x in paths]
    for r in res:
        for i, w in enumerate(want):
            err = np.abs(r[f"{tag}/q{i}"] - w)[steady[i]]
            assert float(err.max()) < PARAM_TOL * float(np.abs(w).max()), paths[i]


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_ssd_step_update_follows_its_gradient(ranks, arch, shape, over):
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
def test_ssd_partial_leaves_are_summed_and_no_other(ranks, arch, shape, over):
    """Under "heads" each rank's gradient of a small SSD leaf is a share (its
    heads' entries, its heads' part of the B / C conv channels): not the
    whole gradient, which their sum is.  Every other replicated leaf's
    gradient is whole on every rank, and the split leaves hold 1/m."""
    tag = _tag(arch, shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(arch, over)
    plan = _plan(cfg, shape)
    g = _grads_np(cfg, params_np, batch_np)
    m = shape[1]
    seen = set()
    for i, ((path, x), spec) in enumerate(zip(leaves_with_path(param_shapes(cfg)),
                                              _specs(cfg, shape))):
        split = _model_dim(spec) is not None
        assert (path in plan.split) is split
        for r in res:
            assert math.prod(tuple(r[f"{tag}/pshape{i}"])) * (m if split else 1) == x.numel()
        if split:
            continue
        blocks = _model_blocks(res, tag, i, shape)
        tol = TOL * float(np.abs(g[path]).max())
        if path in plan.partial:
            seen.add(_name(path))
            assert float(np.abs(sum(blocks) - g[path]).max()) <= tol, path
            assert all(float(np.abs(b - g[path]).max()) > tol for b in blocks), path
        else:
            for b in blocks:
                assert float(np.abs(b - g[path]).max()) <= tol, path
    assert seen == (set() if over else set(SMALL))


@pytest.mark.parametrize("arch,shape,over", STEP_CASES, ids=_STEP_IDS)
def test_ssd_step_collectives_closed_form(ranks, arch, shape, over):
    """``chip_smoke.ssd_collectives`` over "model", plus the data-parallel
    mean (each leaf's block, the loss)."""
    tag = _tag(arch, shape, over)
    cfg = _cfg(arch, over)
    plan = _plan(cfg, shape)
    dn, m = shape
    want = list(ssd_collectives(cfg, plan, BATCH // dn, SEQ))
    if dn > 1:
        for path, x in leaves_with_path(param_shapes(cfg)):
            want.append(("all-reduce", x.numel() * 4 // (m if path in plan.split else 1), dn))
        want.append(("all-reduce", 4, dn))
    for r in _rank_results(ranks, shape):
        assert _ops_rows(r, tag) == sorted(want)


def test_zamba2_step_matches_reference_gspmd_step(ranks):
    """zamba2's placed step on (2, 2) against the reference's GSPMD step on
    the same mesh: losses and params within ``REF_TOL``; the first step's
    gradient, put together from the ranks' blocks, within ``REF_TOL`` of the
    reference's ``jax.grad`` relative to each leaf's largest element; each
    param's first update within ``REF_TOL`` of the reference's largest first
    update of that leaf, where the reference's gradient is steady at
    ``REF_TOL`` (:func:`_steady`: there the two gradients' signs agree).
    Two AdamW steps move a param by about 2 lr, so the params' own bound
    would not see a wrong gradient; the second update divides by moments
    that a cancelling element leaves near zero, so it is not compared
    elementwise (the one-process port's own second update misses the
    reference's by 2.8e-2 of the largest there)."""
    _, ref = ranks
    shape = (2, 2)
    tag = _tag(ZAMBA, shape, {})
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(ZAMBA, {})
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
            keep = _steady(ref[f"g{i}"], REF_TOL)
            du, dr = r[f"{tag}/q{i}"] - x0, ref[f"q{i}"] - x0
            assert np.abs(du - dr)[keep].max() < REF_TOL * np.abs(dr).max(), i
        assert f"{tag}/p{len(p0)}" not in r and f"p{len(p0)}" not in ref


@pytest.mark.parametrize("arch,shape,over", SERVE_CASES, ids=_SERVE_IDS)
def test_placed_generate_matches_one_process(ranks, arch, shape, over):
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.ssd import ssm_dims as dims
    from repro_torch.serve import generate

    tag = _tag(arch, shape, over) + "/serve"
    res = _rank_results(ranks, shape)
    cfg, params_np, prompts_np = serve_inputs(arch, over)
    params = params_from_numpy(params_np, "cpu")
    prompts = torch.from_numpy(prompts_np)
    ref = generate(params, cfg, prompts, SERVE_NEW)
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, SERVE_PROMPT + SERVE_NEW)
        step_logits, _ = decode_step(params, cfg, cache, ref.tokens[:, :1].to(torch.int32))
    dn, m = shape
    plan = _plan(cfg, shape, "serve")
    rows = SERVE_BATCH // dn
    for i, r in enumerate(res):
        d = i // m
        np.testing.assert_array_equal(r[f"{tag}/tokens"], ref.tokens[d * rows: (d + 1) * rows])
        assert float(np.abs(r[f"{tag}/logprobs"] - ref.logprobs[d * rows: (d + 1) * rows]
                            .numpy()).max()) <= TOL
        assert str(r[f"{tag}/mode"]) == ("none" if cfg.family == "ssm" else "heads")
        # the state on the rank's heads, the conv tail on its channel block
        _, n_heads, hd, g, n = dims(cfg)
        heads = n_heads // m if plan.ssd == "heads" else n_heads
        conv = cache["ssm"]["conv"].shape[-1] // (m if plan.conv else 1)
        assert tuple(r[f"{tag}/ssm['state']"])[2] == heads
        assert tuple(r[f"{tag}/ssm['conv']"])[-1] == conv
    for key, want in (("prefill", logits), ("decode", step_logits)):
        for d in range(dn):
            blocks = [res[d * m + j][f"{tag}/{key}"] for j in range(m)]
            got = np.concatenate(blocks, axis=-1) if plan.head == "vocab" else blocks[0]
            assert _rel(got, want[d * rows: (d + 1) * rows].numpy()) <= TOL, key


@pytest.mark.parametrize("arch,shape,over", SERVE_CASES, ids=_SERVE_IDS)
def test_decode_collectives_closed_form(ranks, arch, shape, over):
    tag = _tag(arch, shape, over) + "/serve"
    cfg = _cfg(arch, over)
    mode = "none" if cfg.family == "ssm" else "heads"
    want = ssd_collectives(cfg, _plan(cfg, shape, "serve"), SERVE_BATCH // shape[0], 1, mode)
    for r in _rank_results(ranks, shape):
        assert _ops_rows(r, tag) == want


@pytest.mark.parametrize("arch,shape", SP_CASES, ids=_SP_IDS)
def test_sp_decode_matches_one_process(ranks, arch, shape):
    """Each rank's logits (its vocabulary block) and new cache blocks after
    every step within ``TOL`` of the one-process ``decode_step``'s, as
    ``cache_shardings`` cuts them; the writes cross the data ranks' block
    boundary (positions 30-33, blocks of 32)."""
    from repro_torch.launch.sharding import cache_shardings

    tag = _tag(arch, shape, {}) + "/sp"
    res = _rank_results(ranks, shape)
    cfg = _cfg(arch, {})
    ref = sp_reference(arch)
    dn, m = shape
    plan = _plan(cfg, shape, "serve")
    assert dn == 1 or SP_AT < SP_LEN // dn < SP_AT + SP_STEPS
    for i, r in enumerate(res):
        assert int(r[f"{tag}/sp"]) == (dn if cfg.family == "hybrid" else 1)
        assert str(r[f"{tag}/mode"]) == ("heads" if cfg.family == "hybrid" else "none")
    for s in range(SP_STEPS):
        want = ref["logits"][s].numpy()
        for d in range(dn):
            blocks = [res[d * m + j][f"{tag}/logits{s}"] for j in range(m)]
            got = np.concatenate(blocks, axis=-1) if plan.head == "vocab" else blocks[0]
            assert _rel(got, want) <= TOL, s
        whole = dict(leaves_with_path(ref["caches"][s]))
        sh = dict(leaves_with_path(cache_shardings(cfg, _abstract(shape), ref["caches"][s])))
        for i, r in enumerate(res):
            d, j = divmod(i, m)
            for key, w in whole.items():
                got = r[f"{tag}/c{s}{key}"]
                want = _rank_block(w, sh[key].spec, shape, d, j).numpy()
                assert got.shape == want.shape, key
                assert float(np.abs(got - want).max()) <= TOL * max(
                    float(np.abs(w.numpy()).max()), 1e-30), (s, key)


def _rank_block(t: torch.Tensor, spec, shape, d: int, j: int) -> torch.Tensor:
    """Rank (d, j)'s block of ``t`` under ``spec`` on a (data, model) mesh."""
    idx = [slice(None)] * t.dim()
    for dim, e in enumerate(spec):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        for name in names:
            parts, at = (shape[0], d) if name == "data" else (shape[1], j)
            n = t.shape[dim] // parts
            idx[dim] = slice(at * n, (at + 1) * n)
    return t[tuple(idx)]


@pytest.mark.parametrize("arch,shape", SP_CASES, ids=_SP_IDS)
def test_sp_decode_collectives_closed_form(ranks, arch, shape):
    tag = _tag(arch, shape, {}) + "/sp"
    cfg = _cfg(arch, {})
    mode = "heads" if cfg.family == "hybrid" else "none"
    want = ssd_collectives(cfg, _plan(cfg, shape, "serve"), 1, 1, mode,
                           sp=shape[0] if cfg.family == "hybrid" else 1)
    for r in _rank_results(ranks, shape):
        assert _ops_rows(r, tag) == want


def test_sp_prefill_is_refused():
    """A batch-1 prompt whose sequence the rules split over "data": placed
    serving splits requests only (long_500k is a decode cell)."""
    from repro_torch.launch import serve as ps

    cfg = smoke_config(ZAMBA)
    with pytest.raises(ValueError, match="requests only"):
        ps.shard_batch(cfg, _abstract((2, 1)), {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


# ------------------------------------------------------------------ the meta dry run


# the serving cells: the smoke configs' 16-position chunks make train_4k's and
# prefill_32k's scans 256 and 2,048 chunks a layer, 10-16 s each on meta
# tensors; chip_smoke.py phase 3l (f) runs all eight full-width cells
SSD_CELLS = [(a, s) for a in (MAMBA, ZAMBA) for s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", SSD_CELLS, ids=[f"{a}-{s}" for a, s in SSD_CELLS])
def test_meta_dryrun_ssd_smoke_cells_model_collectives(arch, shape):
    from repro_torch import roofline
    from test_torch_tp import _smoke_overrides

    over = _smoke_overrides(arch)
    cfg = build_case(arch, shape, **over).cfg
    assert _plan(cfg, (2, 4)).ssd == "heads"
    rec = dryrun.run_cell(arch, shape, False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 4))
    assert rec["status"] == "ok" and rec["collectives_modelled"] is True
    sp = SHAPES[shape]
    assert roofline.analyse(rec, sp.seq_len, sp.global_batch, cfg).collective_s > 0
    # the projection's float32 sum over the 4 "model" ranks, once an SSD layer
    tokens = (1 if sp.kind == "decode" else sp.seq_len) * max(sp.global_batch // 2, 1)
    d_inner, n_heads, _, g, n = ssm_dims(cfg)
    width = 2 * d_inner + 2 * g * n + n_heads
    proj = [op for op in rec["collective_ops"]
            if op["bytes"] == tokens * width * 4 and op["kind"] == "all-reduce"
            and op["group"] == 4]
    assert len(proj) == cfg.n_layers
    # long_500k's one request: zamba2's KV sequence split over the 2 "data" ranks
    data = [op for op in rec["collective_ops"] if op["group"] == 2]
    assert bool(data) is (sp.kind == "train" or (shape == "long_500k" and cfg.family == "hybrid"))
