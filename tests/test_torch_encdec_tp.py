"""repro_torch's encoder-decoder split over "model" on the CPU: the audio
family (whisper-medium) with the encoder's self-attention (bidirectional),
the decoder's self-attention and its cross-attention split on heads and
every MLP on ``d_ff`` (``launch/tp_model.py``'s ``encode``, ``cross_kv``,
``cross_block`` and ``dec_layer``), run by the placed step (``step.py``),
placed serving (``serve.py``) and the dry run.

* The plan read from the rules (an ``AbstractMesh``, no group): the full
  whisper-medium on 16 x 16, 32 x 8 and 2 x 16 x 16 splits every attention
  block on heads, the MLPs on ``d_ff``, embed and head on ``d``, with no
  partial leaf; the smoke config on 16 x 16 (4 heads) would take
  attention's contraction split, which the encoder-decoder refuses.
* gloo groups of 2 and 4 ranks (separate processes, ``torch_groups.py``;
  both groups and the reference's subprocess run at once), the smoke
  whisper at float32 on (1, 2), (2, 2) and (1, 4), and with a 255-token
  vocabulary on (1, 2), so embed and head take the "d" split as
  whisper-medium's do.  Two placed steps:

  - each rank's gradient block, before any reduction (averaged over
    "data"), within ``TOL`` of the one-process gradient at the same
    params, the encoder's and the cross-attention's leaves named among
    them; losses and grad norms within ``TOL``; params after the first
    step within ``PARAM_TOL`` of the one-process step's where the
    gradient's sign is steady, and after both within ``UPDATE_TOL`` of
    the one-process AdamW of the assembled gradients;
  - no partial leaf: every replicated leaf's gradient (the norms,
    ``enc_norm`` and ``cross_norm`` among them) whole on every rank, not
    summed; the split leaves hold 1/m;
  - the step's recorded collectives equal to
    ``chip_smoke.audio_collectives`` plus the data-parallel mean;
  - the (2, 2) step within 5e-3 of the reference's own GSPMD step (a
    subprocess with 4 forced host devices).

  The placed greedy ``generate`` with frames: tokens equal to the
  one-process port's, log-probabilities and the prefill's and a decode
  step's logits within ``TOL``, each rank's cross cache the one-process
  cache's kv heads within ``TOL``; a prefill's and a decode step's
  collectives equal to the closed form.
* On a (1, 1) mesh the forward, prefill and decode are the one-process
  op sequence, bitwise.
* The meta dry run of the smoke whisper's cells on a (2, 4) stand-in mesh:
  modelled, with the closed form's counts.
"""

import copy
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import audio_collectives, draw_params
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path, unflatten_like
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import build_case, dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import param_shapes
from repro_torch.train import make_train_step
from repro_torch.train.step import make_loss_fn, value_and_grad
from torch_groups import load, ranks as start_ranks, reference, shared, tensors, wait
from torch_groups import torch_threads  # noqa: F401

TOL = 1e-5  # gradients, losses, grad norms, logits, caches: summation order only
UPDATE_TOL = 1e-6  # params vs the one-process AdamW on the assembled gradient
PARAM_TOL = 2e-4  # params vs the one-process step (AdamW's elementwise scaling)
REF_TOL = 5e-3  # vs the reference's GSPMD step (tests/test_distributed.py)
STEPS = 2
BATCH, SEQ, FRAMES = 4, 16, 12
ARCH = "whisper-medium"
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)
V255 = {"vocab": 255}  # divides no "model" axis: embed and head split on d

STEP_CASES = [((1, 2), {}), ((2, 2), {}), ((1, 4), {}), ((1, 2), V255)]
SERVE_CASES = STEP_CASES
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 8, 3
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}


def _tag(mesh: tuple, over: dict) -> str:
    extra = "".join(f"-{k}{v}" for k, v in sorted(over.items()))
    return f"{ARCH}{extra}@{'x'.join(map(str, mesh))}"


def _cfg(over: dict):
    return smoke_config(ARCH, dtype="float32", **over)


@shared
def step_inputs(over: dict):
    cfg = _cfg(over)
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
             for k in ("tokens", "labels")}
    batch["frames"] = rng.standard_normal((BATCH, FRAMES, cfg.d_model), dtype=np.float32)
    return cfg, params, batch


@shared
def serve_inputs(over: dict):
    cfg = _cfg(over)
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    frames = rng.standard_normal((SERVE_BATCH, FRAMES, cfg.d_model), dtype=np.float32)
    return cfg, params, prompts, frames


def _ops_arrays(ops: list) -> dict:
    return {"kinds": np.array([o["kind"] for o in ops]),
            "bytes": np.array([o["bytes"] for o in ops], dtype=np.int64),
            "groups": np.array([o["group"] for o in ops], dtype=np.int64)}


def _ops_rows(r: dict, tag: str) -> list:
    return sorted(zip(r[f"{tag}/ops_kinds"].tolist(), r[f"{tag}/ops_bytes"].tolist(),
                      r[f"{tag}/ops_groups"].tolist()))


# ------------------------------------------------------------------ the ranks' work


def _placed_steps(shape, over, mesh) -> dict:
    from repro_torch import _obs_hooks
    from repro_torch.launch.step import gather, make_placed_train_step, place_state
    from repro_torch.roofline import record_collectives

    tag = _tag(shape, over)
    cfg, params_np, batch_np = step_inputs(over)
    params = params_from_numpy(params_np, "cpu")
    p, o = place_state(cfg, mesh, params)
    step = make_placed_train_step(cfg, OCFG, mesh)
    batch = tensors(batch_np)
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
def _placed_serve(shape, over, mesh) -> dict:
    from repro_torch.launch import serve as ps
    from repro_torch.roofline import record_collectives

    tag = _tag(shape, over) + "/serve"
    cfg, params_np, prompts_np, frames_np = serve_inputs(over)
    local = ps.shard_params(cfg, mesh, params_from_numpy(params_np, "cpu"))
    prompts, frames = torch.tensor(prompts_np), torch.tensor(frames_np)
    res = ps.generate(local, cfg, mesh, prompts, SERVE_NEW, frames=frames)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    max_len = SERVE_PROMPT + SERVE_NEW
    mode = ps.kv_mode(cfg, mesh, SERVE_BATCH, max_len)
    rows = ps.shard_batch(cfg, mesh, {"tokens": prompts, "frames": frames})
    with record_collectives() as pre:
        logits, cache = ps.prefill(local, plan, rows["tokens"], max_len, mode,
                                   frames=rows["frames"])
    with record_collectives() as ops:
        step_logits, new = ps.decode_step(local, plan, cache, res.tokens[:, :1].to(torch.int32),
                                          mode)
    out = {f"{tag}/tokens": res.tokens.numpy(), f"{tag}/logprobs": res.logprobs.numpy(),
           f"{tag}/prefill": logits.numpy(), f"{tag}/decode": step_logits.numpy(),
           f"{tag}/mode": np.array(mode), f"{tag}/cross_k": cache["cross_k"].numpy(),
           f"{tag}/cross_v": cache["cross_v"].numpy(), f"{tag}/k": cache["k"].numpy(),
           f"{tag}/kept": np.array(new["cross_k"] is cache["cross_k"])}
    out.update({f"{tag}/ops_{k}": v for k, v in _ops_arrays(ops).items()})
    out.update({f"{tag}/pre/ops_{k}": v for k, v in _ops_arrays(pre).items()})
    return out


def run_rank(world: int) -> dict:
    """Everything one rank of a ``world``-rank gloo group computes."""
    from repro_torch.launch.mesh import _device_mesh

    out = {}
    for shape in MESHES[world]:
        mesh = _device_mesh(shape, ("data", "model"), "cpu")
        for m, over in STEP_CASES:
            if m == shape:
                out.update(_placed_steps(m, over, mesh))
        for m, over in SERVE_CASES:
            if m == shape:
                out.update(_placed_serve(m, over, mesh))
    return out


_WORKER = """
    import sys
    from test_torch_encdec_tp import run_rank
    from torch_groups import join, leave
    rank, world, out = join(sys.argv)
    leave(out + f"/rank{rank}.npz", run_rank(world))
"""

_REFERENCE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.launch.sharding import batch_shardings, opt_shardings, params_shardings
    from repro.optim import AdamWConfig
    from repro.optim import init as opt_init
    from repro.train import make_loss_fn, make_train_step
    from test_torch_encdec_tp import ARCH, STEPS, step_inputs
    out = sys.argv[1]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = smoke_config(ARCH, dtype="float32")
    _, params, batch = step_inputs({})
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
    """{world: [each rank's results]} and the reference's results: both
    groups and the reference's subprocess run at once."""
    tmps = {world: tmp_path_factory.mktemp(f"encdec{world}") for world in (2, 4)}
    ref = tmp_path_factory.mktemp("encdec_reference")
    wait([p for w, tmp in tmps.items() for p in start_ranks(tmp, _WORKER, w)] +
         [reference(ref, _REFERENCE, 4)])
    return {w: load(tmp, w) for w, tmp in tmps.items()}, dict(np.load(ref / "reference.npz"))


def _rank_results(ranks, shape) -> list:
    """The results of the ranks of ``shape``'s group, in rank order (rank =
    data index x m + model index)."""
    return ranks[0][shape[0] * shape[1]]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _abstract(shape) -> AbstractMesh:
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return AbstractMesh(tuple(shape), names)


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


def _grads_at(cfg, params_np, batch_np) -> tuple:
    """The one-process loss, grad norm and gradient (path -> array, in leaf
    order) of the whole batch at ``params_np``."""
    from repro_torch.optim.adamw import global_norm

    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    batch = tensors(batch_np)
    loss, g = value_and_grad(make_loss_fn(cfg), params, batch)
    return float(loss), float(global_norm(g)), {p: x.numpy() for p, x in leaves_with_path(g)}


@shared
def _grads_np(over: dict) -> tuple:
    """:func:`_grads_at` of the initial params."""
    return _grads_at(*step_inputs(over))


@shared
def _one_process_steps(over: dict, steps: int = STEPS):
    """The one-process port's params after ``steps`` steps."""
    cfg, params_np, batch_np = step_inputs(over)
    params = params_from_numpy(copy.deepcopy(params_np), "cpu")
    step = make_train_step(cfg, OCFG, donate=True)
    state = optim.init(params)
    batch = tensors(batch_np)
    for _ in range(steps):
        params, state, _ = step(params, state, batch)
    return [x.numpy() for x in leaves(params)]


def _model_blocks(res, tag: str, i: int, shape, s: int = 0) -> list:
    """Leaf ``i``'s step-``s`` gradient block of each "model" rank, before
    any reduction, averaged over the "data" ranks."""
    dn, mn = shape
    return [sum(res[d * mn + m][f"{tag}/g{s}_{i}"] for d in range(dn)) / dn for m in range(mn)]


def _assembled_grads(res, tag: str, cfg, shape, s: int) -> list:
    """Step ``s``'s whole gradient, leaf by leaf, from the ranks' blocks: a
    split leaf's blocks concatenated, a replicated leaf's taken once (no
    leaf is partial)."""
    grads = []
    for i, spec in enumerate(_specs(cfg, shape)):
        blocks = _model_blocks(res, tag, i, shape, s)
        dim = _model_dim(spec)
        g = np.concatenate(blocks, axis=dim) if dim is not None else blocks[0]
        grads.append(torch.from_numpy(np.ascontiguousarray(g)))
    return grads


def _steady(g: np.ndarray, tol: float) -> np.ndarray:
    """The elements of a first gradient ``g`` whose sign float32's summation
    order cannot flip: at least ``tol`` of the leaf's largest element
    (AdamW's first update is about ``lr * sign(g)``)."""
    return np.abs(g) >= tol * np.abs(g).max()


_IDS = [_tag(m, o) for m, o in STEP_CASES]


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("mesh", [(16, 16), (32, 8), (2, 16, 16)],
                         ids=["16x16", "32x8", "2x16x16"])
def test_whisper_medium_splits_every_attention_block_on_heads(mesh):
    cfg = get_config(ARCH)
    m = mesh[-1]
    for mode in ("train", "serve"):
        assert tp_model.unsupported(cfg, _abstract(mesh), mode) is None
        p = _plan(cfg, mesh, mode)
        assert (p.attn, p.kv, p.mlp, p.embed, p.head, p.partial) == (
            "heads", "heads", True, "d", "d", frozenset())
        assert (p.local.n_heads, p.local.n_kv_heads) == (16 // m, 16 // m)
        for tree in ("['enc_layers']['attn']", "['layers']['attn']", "['layers']['cross_attn']"):
            assert {_name(x) for x in p.split if x.startswith(tree)} == {"wq", "wk", "wv", "wo"}
        assert {_name(x) for x in p.split if "['mlp']" in x} == {"up", "down"}
        assert not any("norm" in _name(x) for x in p.split)


@pytest.mark.parametrize("shape,over", STEP_CASES, ids=_IDS)
def test_plan_of_each_case(shape, over):
    cfg = _cfg(over)
    p = _plan(cfg, shape)
    assert (p.attn, p.kv, p.mlp, p.partial) == ("heads", "heads", True, frozenset())
    assert (p.embed, p.head) == (("d", "d") if over else ("vocab", "vocab"))
    assert p.local.n_heads == cfg.n_heads // shape[1]


def test_contraction_split_is_refused_for_the_encoder_decoder():
    """The smoke whisper's 4 heads on 16 x 16: the rules would split
    attention on its contraction (16 divides d_model 64, not 4 heads), which
    the encoder-decoder does not run; the placed step gathers every leaf
    there, and the dry run says why."""
    from repro_torch.launch.step import make_placed_train_step
    from test_torch_tp import _smoke_overrides

    cfg = smoke_config(ARCH)
    why = tp_model.unsupported(cfg, _abstract((16, 16)))
    assert why is not None and "heads only" in why
    with pytest.raises(ValueError, match="heads only"):
        _plan(cfg, (16, 16))
    assert callable(make_placed_train_step(cfg, OCFG, _abstract((16, 16))))
    case = build_case(ARCH, "decode_32k", **_smoke_overrides(ARCH))
    assert "heads only" in dryrun.collectives_reason(case, _abstract((16, 16)))


def test_cross_cache_off_its_kv_heads_is_refused():
    """Two kv heads on a 4-rank "model" axis: the rules split the cross
    cache's frames (split-K), which placed serving does not take."""
    from repro_torch.launch import serve as ps

    cfg = smoke_config(ARCH, n_kv_heads=2)
    assert _plan(cfg, (1, 4), "serve").kv == "whole"
    with pytest.raises(ValueError, match="kv heads only"):
        ps.cross_mode(cfg, _abstract((1, 4)), 2, FRAMES)
    assert ps.cross_mode(cfg, _abstract((1, 2)), 2, FRAMES) == "heads"


def test_one_rank_forward_prefill_decode_are_the_one_process_op_sequence():
    """On a (1, 1) mesh every function runs ``models.transformer``'s op
    sequence: the hidden state, the loss, the prefill's logits and cache and
    a decode step's, bitwise."""
    from repro_torch.launch import serve as ps
    from repro_torch.models import decode_step, encdec_forward, prefill

    cfg, params_np, batch_np = step_inputs({})
    params = params_from_numpy(params_np, "cpu")
    batch = tensors(batch_np)
    plan = _plan(cfg, (1, 1))
    with torch.no_grad():
        h, _ = tp_model.forward(params, plan, batch["tokens"], batch["frames"])
        assert torch.equal(h, encdec_forward(params, cfg, batch["frames"], batch["tokens"])[0])
        assert torch.equal(tp_model.make_loss_fn(plan)(params, batch),
                           make_loss_fn(cfg)(params, batch))
        _, _, prompts, frames = serve_inputs({})
        prompts, frames = torch.tensor(prompts), torch.tensor(frames)
        splan = _plan(cfg, (1, 1), "serve")
        got, gc = ps.prefill(params, splan, prompts, 12, "heads", frames=frames)
        want, wc = prefill(params, cfg, prompts, 12, frames=frames)
        assert torch.equal(got, want)
        for key in ("k", "v", "cross_k", "cross_v", "pos"):
            assert torch.equal(gc[key], wc[key]), key
        tok = torch.argmax(want[:, -1], dim=-1)[:, None].to(torch.int32)
        got, gc = ps.decode_step(params, splan, gc, tok, "heads")
        want, wc = decode_step(params, cfg, wc, tok)
        assert torch.equal(got, want)
        for key in ("k", "v"):
            assert torch.equal(gc[key], wc[key]), key


def test_forward_needs_frames():
    cfg = _cfg({})
    params = params_from_numpy(draw_params(cfg, np.random.default_rng(0)), "cpu")
    with pytest.raises(ValueError, match="needs frames"):
        tp_model.forward(params, _plan(cfg, (1, 1)), torch.zeros((1, 4), dtype=torch.int32))


# ------------------------------------------------------------------ gloo groups


@pytest.mark.parametrize("shape,over", STEP_CASES, ids=_IDS)
def test_encdec_step_matches_one_process_step(ranks, shape, over):
    """Each step's gradient blocks, loss and grad norm within ``TOL`` of the
    one-process ones at the same params (the initial ones, then the placed
    run's after its first step), every encoder and cross-attention leaf
    among them; the params after the first step within ``PARAM_TOL`` of
    the one-process step's where the gradient's sign is steady."""
    tag = _tag(shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, batch_np = step_inputs(over)
    want = _one_process_steps(over, 1)
    paths = [x for x, _ in leaves_with_path(param_shapes(cfg))]
    after = unflatten_like(params_np, [res[0][f"{tag}/q{i}"] for i in range(len(paths))])
    held = set()
    for step in range(2):
        loss, norm, g = _grads_np(over) if step == 0 else _grads_at(cfg, after, batch_np)
        for r in res:
            assert _rel(r[f"{tag}/losses"][step], float(loss)) < TOL, step
            assert _rel(r[f"{tag}/grad_norms"][step], norm) < TOL, step
        for i, (path, spec) in enumerate(zip(paths, _specs(cfg, shape))):
            tol = TOL * float(np.abs(g[path]).max())
            assert float(np.abs(g[path]).max()) > 0, path
            for m, got in enumerate(_model_blocks(res, tag, i, shape, step)):
                block = _block(g[path], spec, shape, m)
                assert got.shape == block.shape
                assert float(np.abs(got - block).max()) <= tol, (step, path)
            held.add(path)
        if step == 0:
            steady = [_steady(g[x], TOL) for x in paths]
    names = {f"['enc_layers']['attn']['{w}']" for w in ("wq", "wk", "wv", "wo")} | {
        f"['layers']['cross_attn']['{w}']" for w in ("wq", "wk", "wv", "wo")} | {
        "['enc_norm']", "['layers']['cross_norm']", "['enc_layers']['mlp']['up']"}
    assert names <= held
    for r in res:
        for i, w in enumerate(want):
            err = np.abs(r[f"{tag}/q{i}"] - w)[steady[i]]
            assert float(err.max()) < PARAM_TOL * float(np.abs(w).max()), paths[i]


@pytest.mark.parametrize("shape,over", STEP_CASES, ids=_IDS)
def test_encdec_step_update_follows_its_gradient(ranks, shape, over):
    tag = _tag(shape, over)
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs(over)
    ps = leaves(params_from_numpy(copy.deepcopy(params_np), "cpu"))
    state = optim.init(ps)
    for s in range(STEPS):
        _, state, _ = optim.update(OCFG, _assembled_grads(res, tag, cfg, shape, s), state, ps,
                                   donate=True)
    for r in res:
        for i, x in enumerate(ps):
            assert _rel(r[f"{tag}/p{i}"], x.numpy()) < UPDATE_TOL, i


@pytest.mark.parametrize("shape,over", STEP_CASES, ids=_IDS)
def test_encdec_whole_leaves_are_not_summed(ranks, shape, over):
    """No leaf is partial: each replicated leaf (every norm, ``enc_norm`` and
    ``cross_norm`` among them) has the whole one-process gradient on every
    rank, which summing over "model" would multiply by m; the split leaves
    hold 1/m."""
    tag = _tag(shape, over)
    res = _rank_results(ranks, shape)
    cfg = step_inputs(over)[0]
    plan = _plan(cfg, shape)
    assert plan.partial == frozenset()
    g = _grads_np(over)[2]
    m = shape[1]
    whole = set()
    for i, ((path, x), spec) in enumerate(zip(leaves_with_path(param_shapes(cfg)),
                                              _specs(cfg, shape))):
        split = _model_dim(spec) is not None
        assert (path in plan.split) is split
        for r in res:
            assert math.prod(tuple(r[f"{tag}/pshape{i}"])) * (m if split else 1) == x.numel()
        if split:
            continue
        whole.add(_name(path))
        tol = TOL * float(np.abs(g[path]).max())
        for b in _model_blocks(res, tag, i, shape):
            assert float(np.abs(b - g[path]).max()) <= tol, path
            assert float(np.abs(m * b - g[path]).max()) > tol, path
    want = {"attn_norm", "mlp_norm", "cross_norm", "enc_norm", "final_norm"}
    assert whole == want


@pytest.mark.parametrize("shape,over", STEP_CASES, ids=_IDS)
def test_encdec_step_collectives_closed_form(ranks, shape, over):
    """``chip_smoke.audio_collectives`` over "model", plus the data-parallel
    mean (each leaf's block, the loss)."""
    tag = _tag(shape, over)
    cfg = _cfg(over)
    plan = _plan(cfg, shape)
    dn, m = shape
    want = list(audio_collectives(cfg, plan, BATCH // dn, SEQ, FRAMES, "train"))
    if dn > 1:
        for path, x in leaves_with_path(param_shapes(cfg)):
            want.append(("all-reduce", x.numel() * 4 // (m if path in plan.split else 1), dn))
        want.append(("all-reduce", 4, dn))
    for r in _rank_results(ranks, shape):
        assert _ops_rows(r, tag) == sorted(want)


def test_encdec_step_matches_reference_gspmd_step(ranks):
    """The placed step on (2, 2) against the reference's GSPMD step on the
    same mesh: losses and params within ``REF_TOL``; the first step's
    gradient, put together from the ranks' blocks, within ``REF_TOL`` of
    the reference's ``jax.grad`` relative to each leaf's largest element;
    each param's first update within ``REF_TOL`` of the reference's largest
    first update of that leaf, where the reference's gradient is steady at
    ``REF_TOL`` (two AdamW steps move a param by about 2 lr, so the params'
    own bound would not see a wrong gradient)."""
    _, ref = ranks
    shape = (2, 2)
    tag = _tag(shape, {})
    res = _rank_results(ranks, shape)
    cfg, params_np, _ = step_inputs({})
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


@shared
def _serve_reference(over: dict):
    """The one-process port's serving of ``serve_inputs(over)``: (config,
    tokens, log-probabilities, the prefill's logits, its caches, a decode
    step's logits)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import generate

    cfg, params_np, prompts_np, frames_np = serve_inputs(over)
    params = params_from_numpy(params_np, "cpu")
    prompts, frames = torch.tensor(prompts_np), torch.tensor(frames_np)
    ref = generate(params, cfg, prompts, SERVE_NEW, frames=frames)
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, SERVE_PROMPT + SERVE_NEW, frames=frames)
        step_logits, _ = decode_step(params, cfg, cache, ref.tokens[:, :1].to(torch.int32))
    caches = {k: cache[k].numpy() for k in ("cross_k", "cross_v", "k")}
    return (cfg, ref.tokens.numpy(), ref.logprobs.numpy(), logits.numpy(), caches,
            step_logits.numpy())


@pytest.mark.parametrize("shape,over", SERVE_CASES, ids=_IDS)
def test_placed_generate_matches_one_process(ranks, shape, over):
    """Tokens equal to ``serve.generate``'s with the same frames;
    log-probabilities, the prefill's and a decode step's logits within
    ``TOL``; each rank's self- and cross-attention caches its kv heads of
    the one-process caches, within ``TOL``, the cross cache carried through
    decode unchanged."""
    tag = _tag(shape, over) + "/serve"
    res = _rank_results(ranks, shape)
    cfg, tokens, logprobs, logits, cache, step_logits = _serve_reference(over)
    dn, m = shape
    plan = _plan(cfg, shape, "serve")
    rows = SERVE_BATCH // dn
    hk = cfg.n_kv_heads // m
    for i, r in enumerate(res):
        d, j = divmod(i, m)
        b = slice(d * rows, (d + 1) * rows)
        np.testing.assert_array_equal(r[f"{tag}/tokens"], tokens[b])
        assert float(np.abs(r[f"{tag}/logprobs"] - logprobs[b]).max()) <= TOL
        assert str(r[f"{tag}/mode"]) == "heads" and bool(r[f"{tag}/kept"])
        for key in ("cross_k", "cross_v", "k"):
            want = cache[key][:, b, :, j * hk: (j + 1) * hk]
            assert r[f"{tag}/{key}"].shape == want.shape, key
            assert _rel(r[f"{tag}/{key}"], want) <= TOL, key
    for key, want in (("prefill", logits), ("decode", step_logits)):
        for d in range(dn):
            blocks = [res[d * m + j][f"{tag}/{key}"] for j in range(m)]
            got = np.concatenate(blocks, axis=-1) if plan.head == "vocab" else blocks[0]
            assert _rel(got, want[d * rows: (d + 1) * rows]) <= TOL, key


@pytest.mark.parametrize("shape,over", SERVE_CASES, ids=_IDS)
def test_serving_collectives_closed_form(ranks, shape, over):
    """A prefill's and a decode step's recorded collectives equal to
    ``chip_smoke.audio_collectives``."""
    tag = _tag(shape, over) + "/serve"
    cfg = _cfg(over)
    plan = _plan(cfg, shape, "serve")
    rows = SERVE_BATCH // shape[0]
    decode = audio_collectives(cfg, plan, rows, 1, FRAMES, "decode")
    prefill = audio_collectives(cfg, plan, rows, SERVE_PROMPT, FRAMES, "prefill")
    for r in _rank_results(ranks, shape):
        assert _ops_rows(r, tag) == decode
        assert _ops_rows(r, f"{tag}/pre") == prefill


# ------------------------------------------------------------------ the meta dry run


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_dryrun_encdec_smoke_cells_model_collectives(shape):
    """The smoke whisper's cells on a (2, 4) stand-in mesh (4 heads on 4
    ranks: the head split), modelled, with ``audio_collectives``' count and
    bytes (train: plus the data-parallel mean over the 2 "data" ranks)."""
    from repro_torch import roofline
    from repro_torch.launch.specs import ENC_FRAMES
    from test_torch_tp import _smoke_overrides

    over = _smoke_overrides(ARCH)
    case = build_case(ARCH, shape, **over)
    cfg = case.cfg
    rec = dryrun.run_cell(ARCH, shape, False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 4))
    assert rec["status"] == "ok" and rec["collectives_modelled"] is True
    sp = SHAPES[shape]
    assert roofline.analyse(rec, sp.seq_len, sp.global_batch, cfg).collective_s > 0
    mesh = _abstract((2, 4))
    plan = tp_model.make_plan(cfg, mesh, "train" if sp.kind == "train" else "serve")
    want = list(audio_collectives(cfg, plan, sp.global_batch // 2, sp.seq_len, ENC_FRAMES,
                                  sp.kind))
    if sp.kind == "train":
        p = cfg.param_dtype
        item = torch.empty((), dtype=getattr(torch, p)).element_size()
        for path, x in leaves_with_path(param_shapes(cfg)):
            want.append(("all-reduce", x.numel() * item // (4 if path in plan.split else 1), 2))
        want.append(("all-reduce", 4, 2))
    got = sorted((o["kind"], o["bytes"], o["group"]) for o in rec["collective_ops"])
    assert got == sorted(want)
