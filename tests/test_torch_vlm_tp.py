"""repro_torch's vlm family split over "model" on the CPU: internvl2's
dense layers behind precomputed patch embeddings (``launch/tp_model.py``'s
``embed_inputs``), run by placed serving (``serve.py``), the placed step's
loss and the dry run.

* The plan read from the rules (an ``AbstractMesh``, no group): the full
  internvl2-26b's serving plan on 16 x 16, 2 x 16 x 16 and 32 x 8 (heads
  split, kv heads split at m = 8 and replicated at m = 16 with one kv head
  a rank, the MLP on ``d_ff``, embed and head on ``d``).
* On a (1, 1) mesh the forward, loss, prefill, decode and ``generate``
  with patches are the one-process op sequence, bitwise; the patches enter
  unscaled, in front of the text.
* gloo groups of 2 and 4 ranks (separate processes, ``torch_groups.py``;
  both groups and the reference's subprocess run at once), the smoke
  internvl2 (4 heads, 2 kv heads, 8 patches a request) at float32: placed
  greedy ``generate`` with patches on (1, 2) (the cache on kv heads; also
  with a 255-token vocabulary, so embed and head split on ``d`` as
  internvl2-26b's do), (2, 2) (patches
  split over "data" by their rows) and (1, 4) (kv replicated, the cache
  split on its sequence when patches + prompt + new tokens divide by 4,
  else whole; also with 6 patches, where only the patches make the length
  divide): tokens equal to the one-process port's, log-probabilities
  and the prefill's and a decode step's logits within ``TOL``, each rank's
  KV cache its block of the one-process cache within ``TOL``; a prefill's
  and a decode step's collectives equal to ``chip_smoke.vlm_collectives``.
  One placed step with patches on (1, 2) and (1, 4): the loss and each
  rank's gradient blocks (a partial leaf summed over "model") within
  ``TOL`` of ``train()``'s; its collectives equal to the closed form.
* Against the JAX package: the port's one-process ``serve.generate`` with
  ``inputs_embeds`` against ``repro.serve.loop.generate`` on the same
  numpy weights and patches; the placed prefill's logits on (2, 2) against
  the reference's GSPMD prefill on a 2 x 2 host mesh (a subprocess with 4
  forced host devices), within ``REF_TOL``.
* The meta dry run of the smoke internvl2's cells on a (2, 4) stand-in
  mesh: modelled, with the closed form's counts and bytes (its FSDP train
  cell's: ``chip_smoke.fsdp_collectives``).
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import draw_params, vlm_collectives
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import build_case, dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import param_shapes
from repro_torch.train.step import make_loss_fn, value_and_grad
from torch_groups import load, ranks as start_ranks, reference, shared, tensors, wait
from torch_groups import torch_threads  # noqa: F401

TOL = 1e-5  # placed vs one process, float32: summation order only
REF_TOL = 1e-4  # vs the JAX package (tests/test_torch_models.py's REL_TOL)
ARCH = "internvl2-26b"
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)
V255 = {"vocab": 255}  # divides no "model" axis: embed and head split on d
BATCH, TEXT = 4, 8  # a train batch's requests and text tokens (8 patches each)
SERVE_BATCH, SERVE_PROMPT = 2, 8

# (mesh, overrides, new tokens, the cache's placement): 8 patches + 8
# prompt tokens + 4 new = 20 positions split 4 ways on (1, 4); 19 do not;
# with 6 patches, 6 + 8 + 2 = 16 do, though the prompt and new tokens
# alone (10) would not
P6 = {"n_frontend_tokens": 6}
SERVE_CASES = [((1, 2), {}, 4, "heads"), ((1, 2), V255, 4, "heads"), ((2, 2), {}, 4, "heads"),
               ((1, 4), {}, 4, "seq"), ((1, 4), {}, 3, "whole"), ((1, 4), P6, 2, "seq")]
STEP_CASES = [(1, 2), (1, 4)]
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}


def _tag(mesh: tuple, over: dict, new: int | None = None) -> str:
    extra = "".join(f"-{k}{v}" for k, v in sorted(over.items()))
    return f"{ARCH}{extra}@{'x'.join(map(str, mesh))}" + (f"+{new}" if new else "")


def _cfg(over: dict):
    return smoke_config(ARCH, dtype="float32", **over)


@shared
def serve_inputs(over: dict):
    """(config, numpy weights, prompts, patches), drawn from seeds."""
    cfg = _cfg(over)
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    patches = rng.standard_normal((SERVE_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                                  dtype=np.float32)
    return cfg, params, prompts, patches


@shared
def step_inputs():
    """(config, numpy weights, a batch: tokens, patches and labels of -100
    over the patches, as ``obs.capture.train_batch`` builds them)."""
    cfg = _cfg({})
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    nf = cfg.n_frontend_tokens
    lab = rng.integers(0, cfg.vocab, (BATCH, TEXT), dtype=np.int32)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, TEXT), dtype=np.int32),
             "patches": rng.standard_normal((BATCH, nf, cfg.d_model), dtype=np.float32),
             "labels": np.pad(lab, ((0, 0), (nf, 0)), constant_values=-100)}
    return cfg, params, batch


def _ops_rows(ops: list) -> np.ndarray:
    return np.array(sorted([o["kind"] == "all-gather", o["bytes"], o["group"]] for o in ops),
                    dtype=np.int64).reshape(-1, 3)


def _closed(ops: list) -> np.ndarray:
    """(kind, bytes, group) rows as ``_ops_rows`` lays out recorded ones."""
    return np.array(sorted([k == "all-gather", b, g] for k, b, g in ops),
                    dtype=np.int64).reshape(-1, 3)


# ------------------------------------------------------------------ the ranks' work


@torch.no_grad()
def _placed_serve(shape, over, new, mesh) -> dict:
    from repro_torch.launch import serve as ps
    from repro_torch.roofline import record_collectives

    tag = _tag(shape, over, new)
    cfg, params_np, prompts_np, patches_np = serve_inputs(over)
    local = ps.shard_params(cfg, mesh, params_from_numpy(params_np, "cpu"))
    prompts, patches = torch.tensor(prompts_np), torch.tensor(patches_np)
    with record_collectives() as gen:
        res = ps.generate(local, cfg, mesh, prompts, new, patches=patches)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    max_len = cfg.n_frontend_tokens + SERVE_PROMPT + new
    mode = ps.kv_mode(cfg, mesh, SERVE_BATCH, max_len)
    rows = ps.shard_batch(cfg, mesh, {"tokens": prompts, "patches": patches})
    with record_collectives() as pre:
        logits, cache = ps.prefill(local, plan, rows["tokens"], max_len, mode,
                                   patches=rows["patches"])
    with record_collectives() as ops:
        step_logits, _ = ps.decode_step(local, plan, cache, res.tokens[:, :1].to(torch.int32),
                                        mode)
    return {f"{tag}/tokens": res.tokens.numpy(), f"{tag}/logprobs": res.logprobs.numpy(),
            f"{tag}/prefill": logits.numpy(), f"{tag}/decode": step_logits.numpy(),
            f"{tag}/mode": np.array(mode), f"{tag}/pos": cache["pos"].numpy(),
            f"{tag}/k": cache["k"].numpy(), f"{tag}/v": cache["v"].numpy(),
            f"{tag}/pre_ops": _ops_rows(pre), f"{tag}/ops": _ops_rows(ops),
            f"{tag}/gen_ops": _ops_rows(gen)}


def _placed_step(shape, mesh) -> dict:
    from repro_torch import _obs_hooks
    from repro_torch.launch.step import make_placed_train_step, place_state
    from repro_torch.roofline import record_collectives

    tag = _tag(shape, {})
    cfg, params_np, batch_np = step_inputs()
    params = params_from_numpy(params_np, "cpu")
    p, o = place_state(cfg, mesh, params)
    step = make_placed_train_step(cfg, OCFG, mesh)
    tapped = []
    _obs_hooks.TAP = SimpleNamespace(tap=lambda kind, payload: tapped.append(
        [g.clone() for g in leaves(payload["grads"])]))
    try:
        with record_collectives() as ops:
            _, _, m = step(p, o, tensors(batch_np))
    finally:
        _obs_hooks.TAP = None
    out = {f"{tag}/loss": np.array(float(m["loss"])), f"{tag}/ops": _ops_rows(ops)}
    out.update({f"{tag}/g{i}": g.numpy() for i, g in enumerate(tapped[0])})
    return out


def run_rank(world: int) -> dict:
    """Everything one rank of a ``world``-rank gloo group computes."""
    from repro_torch.launch.mesh import _device_mesh

    out = {}
    for shape in MESHES[world]:
        mesh = _device_mesh(shape, ("data", "model"), "cpu")
        for m, over, new, _ in SERVE_CASES:
            if m == shape:
                out.update(_placed_serve(m, over, new, mesh))
        if shape in STEP_CASES:
            out.update(_placed_step(shape, mesh))
    return out


_WORKER = """
    import sys
    from test_torch_vlm_tp import run_rank
    from torch_groups import join, leave
    rank, world, out = join(sys.argv)
    leave(out + f"/rank{rank}.npz", run_rank(world))
"""

# the reference's GSPMD prefill of the serving inputs on (2, 2), weights
# placed by its serving rules and the prompts and patches by its batch rules
_REFERENCE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.launch.sharding import batch_shardings, params_shardings
    from repro.models import prefill
    from test_torch_vlm_tp import ARCH, SERVE_PROMPT, serve_inputs
    out = sys.argv[1]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = smoke_config(ARCH, dtype="float32")
    _, params, prompts, patches = serve_inputs({})
    params = jax.tree.map(jnp.asarray, params)
    batch = {"tokens": jnp.asarray(prompts), "patches": jnp.asarray(patches)}
    shape = lambda t: jax.eval_shape(lambda: t)
    p_sh = params_shardings(cfg, mesh, shape(params), mode="serve")
    b_sh = batch_shardings(cfg, mesh, {k: shape(v) for k, v in batch.items()})
    max_len = cfg.n_frontend_tokens + SERVE_PROMPT + 4
    fn = jax.jit(lambda p, b: prefill(p, cfg, b["tokens"], max_len,
                                      inputs_embeds=b["patches"])[0],
                 in_shardings=(p_sh, b_sh))
    with mesh:
        logits = fn(params, batch)
    np.savez(out + "/reference.npz", prefill=np.asarray(logits))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]} and the reference's prefill: both
    groups and the reference's subprocess run at once."""
    tmps = {world: tmp_path_factory.mktemp(f"vlm{world}") for world in (2, 4)}
    ref = tmp_path_factory.mktemp("vlm_reference")
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


def _plan(cfg, shape, mode="serve"):
    return tp_model.make_plan(cfg, _abstract(shape), mode)


def _name(path: str) -> str:
    return path.rsplit("['", 1)[-1].rstrip("']")


def _model_dim(spec):
    return next((d for d, e in enumerate(spec)
                 if e is not None and "model" in (e if isinstance(e, tuple) else (e,))), None)


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16), (32, 8)],
                         ids=["16x16", "2x16x16", "32x8"])
def test_internvl2_26b_serve_plan(mesh):
    """Heads split (48 / m a rank), the MLP on ``d_ff``, embed and head on
    ``d`` (vocab 92,553 is odd); kv heads split at m = 8, replicated at m =
    16 with the one kv head a rank's three query heads read (``wk`` /
    ``wv`` partial)."""
    cfg = get_config(ARCH)
    m = mesh[-1]
    assert tp_model.unsupported(cfg, _abstract(mesh), "serve") is None
    p = _plan(cfg, mesh)
    assert (p.attn, p.mlp, p.embed, p.head, p.local.n_heads) == ("heads", True, "d", "d", 48 // m)
    if m == 16:
        assert (p.kv, p.kv_index, p.local.n_kv_heads) == ("whole", (0,), 1)
        assert sorted(_name(x) for x in p.partial) == ["wk", "wv"]
    else:
        assert (p.kv, p.kv_index, p.local.n_kv_heads, p.partial) == ("heads", None, 1,
                                                                     frozenset())
    assert {_name(x) for x in p.split if "['mlp']" in x} == {"gate", "up", "down"}
    assert {_name(x) for x in p.split if "['attn']" in x} == (
        {"wq", "wo"} if m == 16 else {"wq", "wk", "wv", "wo"})


@pytest.mark.parametrize("shape,over", [((1, 2), {}), ((1, 2), V255), ((2, 2), {}), ((1, 4), {})],
                         ids=["1x2", "1x2-vocab255", "2x2", "1x4"])
def test_plan_of_each_smoke_case(shape, over):
    """The smoke internvl2's 2 kv heads split on (1, 2) and (2, 2), whole on
    (1, 4) (rank 0's query head reads kv head 0); vocab 256 splits, 255
    does not."""
    cfg = _cfg(over)
    p = _plan(cfg, shape)
    m = shape[1]
    assert (p.attn, p.kv, p.local.n_heads) == ("heads", "heads" if m == 2 else "whole", 4 // m)
    assert p.kv_index == (None if m == 2 else (0,))
    assert (p.embed, p.head) == (("d", "d") if over else ("vocab", "vocab"))


# ------------------------------------------------------------------ one rank


def test_one_rank_forward_loss_prefill_decode_generate_are_the_one_process_op_sequence():
    """On a (1, 1) mesh: the hidden state and the loss with patches, the
    prefill's logits and cache (patches + prompt positions), a decode step
    and the greedy ``generate`` with patches, bitwise equal to
    ``models.forward`` / ``train``'s loss / ``models.prefill`` /
    ``decode_step`` / ``serve.generate`` with the patches as
    ``inputs_embeds``."""
    from repro_torch.launch import serve as ps
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.serve import generate

    cfg, params_np, batch_np = step_inputs()
    params = params_from_numpy(params_np, "cpu")
    batch = tensors(batch_np)
    mesh = _abstract((1, 1))
    plan = tp_model.make_plan(cfg, mesh)
    with torch.no_grad():
        h, _ = tp_model.forward(params, plan, batch["tokens"], patches=batch["patches"])
        want, _ = forward(params, cfg, tokens=batch["tokens"], inputs_embeds=batch["patches"])
        assert h.shape[1] == cfg.n_frontend_tokens + TEXT and torch.equal(h, want)
        assert torch.equal(tp_model.make_loss_fn(plan)(params, batch),
                           make_loss_fn(cfg)(params, batch))
        _, _, prompts, patches = serve_inputs({})
        prompts, patches = torch.tensor(prompts), torch.tensor(patches)
        max_len = cfg.n_frontend_tokens + SERVE_PROMPT + 4
        splan = tp_model.make_plan(cfg, mesh, "serve")
        got, gc = ps.prefill(params, splan, prompts, max_len, "heads", patches=patches)
        want, wc = prefill(params, cfg, prompts, max_len, inputs_embeds=patches)
        assert torch.equal(got, want) and int(gc["pos"]) == cfg.n_frontend_tokens + SERVE_PROMPT
        for key in ("k", "v", "pos"):
            assert torch.equal(gc[key], wc[key]), key
        tok = torch.argmax(want[:, -1], dim=-1)[:, None].to(torch.int32)
        got, gc = ps.decode_step(params, splan, gc, tok, "heads")
        want, wc = decode_step(params, cfg, wc, tok)
        assert torch.equal(got, want)
        for key in ("k", "v"):
            assert torch.equal(gc[key], wc[key]), key
    res = ps.generate(params, cfg, mesh, prompts, 4, patches=patches)
    ref = generate(params, cfg, prompts, 4, inputs_embeds=patches)
    assert torch.equal(res.tokens, ref.tokens) and torch.equal(res.logprobs, ref.logprobs)


def test_patches_enter_unscaled_in_front_of_the_text():
    """``embed_inputs``: the patches, cast to the compute dtype and not
    multiplied by sqrt(d_model), then the scaled text embedding."""
    cfg = smoke_config(ARCH)  # bf16 compute
    params = params_from_numpy(draw_params(cfg, np.random.default_rng(0)), "cpu")
    plan = _plan(cfg, (1, 1))
    tokens = torch.arange(6, dtype=torch.int32)[None]
    patches = torch.randn((1, cfg.n_frontend_tokens, cfg.d_model), generator=torch.Generator()
                          .manual_seed(0))
    h = tp_model.embed_inputs(params, plan, tokens, patches)
    nf = cfg.n_frontend_tokens
    assert h.dtype == torch.bfloat16 and h.shape == (1, nf + 6, cfg.d_model)
    assert torch.equal(h[:, :nf], patches.to(torch.bfloat16))
    assert torch.equal(h[:, nf:], tp_model.embed(params, plan, tokens))
    assert torch.equal(tp_model.embed_inputs(params, plan, tokens), h[:, nf:])


def test_one_process_generate_with_patches_matches_the_reference():
    """The port's ``serve.generate`` with ``inputs_embeds`` against
    ``repro.serve.loop.generate`` on the same numpy weights, prompts and
    patches: tokens equal, log-probabilities within ``REF_TOL``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as ref_smoke_config
    from repro.serve.loop import generate as ref_generate
    from repro_torch.serve import generate

    cfg, params_np, prompts, patches = serve_inputs({})
    want = ref_generate(jax.tree.map(jnp.asarray, params_np),
                        ref_smoke_config(ARCH, dtype="float32"), jnp.asarray(prompts), 4,
                        inputs_embeds=jnp.asarray(patches))
    got = generate(params_from_numpy(params_np, "cpu"), cfg, torch.tensor(prompts), 4,
                   inputs_embeds=torch.tensor(patches))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert _rel(got.logprobs.numpy(), np.asarray(want.logprobs)) <= REF_TOL


# ------------------------------------------------------------------ gloo groups


@shared
def _serve_reference(over: dict, new: int):
    """The one-process port's serving of ``serve_inputs(over)``: (config,
    tokens, log-probabilities, the prefill's logits, its K and V caches, a
    decode step's logits)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import generate

    cfg, params_np, prompts_np, patches_np = serve_inputs(over)
    params = params_from_numpy(params_np, "cpu")
    prompts, patches = torch.tensor(prompts_np), torch.tensor(patches_np)
    ref = generate(params, cfg, prompts, new, inputs_embeds=patches)
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, cfg.n_frontend_tokens + SERVE_PROMPT + new,
                                inputs_embeds=patches)
        step_logits, _ = decode_step(params, cfg, cache, ref.tokens[:, :1].to(torch.int32))
    return (cfg, ref.tokens.numpy(), ref.logprobs.numpy(), logits.numpy(),
            {k: cache[k].numpy() for k in ("k", "v")}, step_logits.numpy())


_SERVE_IDS = [_tag(m, o, n) for m, o, n, _ in SERVE_CASES]


@pytest.mark.parametrize("shape,over,new,mode", SERVE_CASES, ids=_SERVE_IDS)
def test_placed_generate_with_patches_matches_one_process(ranks, shape, over, new, mode):
    """Tokens equal to ``serve.generate``'s with the patches; log-
    probabilities, the prefill's and a decode step's logits within ``TOL``;
    each rank's prefill cache (``pos`` counting the patches) its block of
    the one-process cache within ``TOL``: its kv heads ("heads"), its
    positions ("seq") or the whole ("whole")."""
    tag = _tag(shape, over, new)
    res = _rank_results(ranks, shape)
    cfg, tokens, logprobs, logits, cache, step_logits = _serve_reference(over, new)
    dn, m = shape
    plan = _plan(cfg, shape)
    rows = SERVE_BATCH // dn
    hk = cfg.n_kv_heads // m
    length = cache["k"].shape[2] // m
    for i, r in enumerate(res):
        d, j = divmod(i, m)
        b = slice(d * rows, (d + 1) * rows)
        np.testing.assert_array_equal(r[f"{tag}/tokens"], tokens[b])
        assert float(np.abs(r[f"{tag}/logprobs"] - logprobs[b]).max()) <= TOL
        assert str(r[f"{tag}/mode"]) == mode
        assert int(r[f"{tag}/pos"]) == cfg.n_frontend_tokens + SERVE_PROMPT
        for key in ("k", "v"):
            want = cache[key][:, b]
            if mode == "heads":
                want = want[:, :, :, j * hk: (j + 1) * hk]
            elif mode == "seq":
                want = want[:, :, j * length: (j + 1) * length]
            assert r[f"{tag}/{key}"].shape == tuple(want.shape), key
            assert _rel(r[f"{tag}/{key}"], want) <= TOL, key
    for key, want in (("prefill", logits), ("decode", step_logits)):
        for d in range(dn):
            blocks = [res[d * m + j][f"{tag}/{key}"] for j in range(m)]
            got = np.concatenate(blocks, axis=-1) if plan.head == "vocab" else blocks[0]
            assert _rel(got, want[d * rows: (d + 1) * rows]) <= TOL, key


@pytest.mark.parametrize("shape,over,new,mode", SERVE_CASES, ids=_SERVE_IDS)
def test_serving_collectives_closed_form(ranks, shape, over, new, mode):
    """A prefill's (patches + prompt positions; the embedding's gather or
    sum of the prompt's only) and a decode step's recorded collectives
    equal to ``chip_smoke.vlm_collectives``; ``generate``'s, the prefill
    and each new token's greedy pick (a MAX, a MIN and a SUM across the
    vocabulary blocks) and decode step, so its cache is placed by the
    length that counts the patches."""
    tag = _tag(shape, over, new)
    cfg = _cfg(over)
    plan = _plan(cfg, shape)
    rows = SERVE_BATCH // shape[0]
    m = shape[1]
    prefill = vlm_collectives(cfg, plan, rows, SERVE_PROMPT, cfg.n_frontend_tokens, "prefill")
    decode = vlm_collectives(cfg, plan, rows, 1, 0, "decode", mode)
    greedy = ([("all-reduce", rows * 4, m), ("all-reduce", rows * 8, m),
               ("all-reduce", rows * 4, m)] if plan.head == "vocab" else [])
    # two sums a layer (three more under split-K), the embedding's, and the
    # head's partial logits under a d split
    assert len(decode) == (5 if mode == "seq" else 2) * cfg.n_layers + 1 + (plan.head == "d")
    for r in _rank_results(ranks, shape):
        np.testing.assert_array_equal(r[f"{tag}/pre_ops"], _closed(prefill))
        np.testing.assert_array_equal(r[f"{tag}/ops"], _closed(decode))
        np.testing.assert_array_equal(r[f"{tag}/gen_ops"],
                                      _closed(prefill + (greedy + decode) * new))


@shared
def _loss_and_grads() -> tuple:
    """The one-process loss and gradient (path -> array, in leaf order) of
    ``step_inputs()``."""
    cfg, params_np, batch_np = step_inputs()
    loss, g = value_and_grad(make_loss_fn(cfg), params_from_numpy(copy.deepcopy(params_np), "cpu"),
                             tensors(batch_np))
    return float(loss), {p: x.numpy() for p, x in leaves_with_path(g)}


@pytest.mark.parametrize("shape", STEP_CASES, ids=["1x2", "1x4"])
def test_placed_loss_and_gradients_with_patches_match_train(ranks, shape):
    """One placed step with patches (labels -100 over them): the loss
    within ``TOL`` of ``train()``'s; each rank's gradient block, before any
    reduction, within ``TOL`` of the one-process gradient's block (a split
    leaf), of the whole gradient (a whole leaf) or, summed over "model", of
    it (a partial leaf: ``wk`` / ``wv`` replicated on (1, 4))."""
    from repro_torch.launch.sharding import params_shardings

    tag = _tag(shape, {})
    res = _rank_results(ranks, shape)
    cfg = step_inputs()[0]
    loss, g = _loss_and_grads()
    plan = tp_model.make_plan(cfg, _abstract(shape))
    m = shape[1]
    specs = [sh.spec for sh in leaves(params_shardings(cfg, _abstract(shape), param_shapes(cfg)))]
    kinds = set()
    for i, ((path, want), spec) in enumerate(zip(g.items(), specs)):
        tol = TOL * float(np.abs(want).max())
        assert float(np.abs(want).max()) > 0, path
        blocks = [r[f"{tag}/g{i}"] for r in res]
        dim = _model_dim(spec)
        if path in plan.partial:
            kinds.add("partial")
            assert float(np.abs(sum(blocks) - want).max()) <= tol, path
            assert float(np.abs(blocks[0] - want).max()) > tol, path
        elif dim is not None:
            kinds.add("split")
            n = want.shape[dim] // m
            for j, b in enumerate(blocks):
                assert float(np.abs(b - want.take(range(j * n, (j + 1) * n), axis=dim)).max()) \
                    <= tol, path
        else:
            kinds.add("whole")
            for b in blocks:
                assert float(np.abs(b - want).max()) <= tol, path
    assert kinds == ({"split", "whole", "partial"} if m == 4 else {"split", "whole"})
    for r in res:
        assert _rel(r[f"{tag}/loss"], float(loss)) < TOL


@pytest.mark.parametrize("shape", STEP_CASES, ids=["1x2", "1x4"])
def test_placed_step_collectives_closed_form(ranks, shape):
    """``chip_smoke.vlm_collectives`` of a train step: the activations'
    sums over every position (patches too), the embedding's of the text
    positions, the vocab-parallel loss's, the partial leaves' and the
    norm's."""
    tag = _tag(shape, {})
    cfg = _cfg({})
    want = vlm_collectives(cfg, tp_model.make_plan(cfg, _abstract(shape)), BATCH, TEXT,
                           cfg.n_frontend_tokens, "train")
    for r in _rank_results(ranks, shape):
        np.testing.assert_array_equal(r[f"{tag}/ops"], _closed(want))


def test_placed_prefill_matches_reference_gspmd_prefill(ranks):
    """The placed prefill's last-position logits on (2, 2), put together
    from the ranks' vocabulary blocks and data rows, against the
    reference's GSPMD prefill of the same weights, prompts and patches on a
    2 x 2 host mesh, within ``REF_TOL``."""
    _, ref = ranks
    shape = (2, 2)
    tag = _tag(shape, {}, 4)
    res = _rank_results(ranks, shape)
    got = np.concatenate([np.concatenate([res[d * 2 + j][f"{tag}/prefill"] for j in range(2)],
                                         axis=-1) for d in range(2)], axis=0)
    assert got.shape == ref["prefill"].shape
    assert _rel(got, ref["prefill"]) <= REF_TOL


# ------------------------------------------------------------------ the meta dry run


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_meta_dryrun_vlm_smoke_cells(shape):
    """The smoke internvl2's cells on a (2, 4) stand-in mesh (4 heads on 4
    ranks, 2 kv heads replicated, the decode cache split-K), modelled, with
    ``vlm_collectives``' counts and bytes; its train cell is FSDP-placed:
    8 microbatches, each gathering every data-split leaf over "data" and
    reduce-scattering its gradient, as ``fsdp_collectives`` counts them."""
    from chip_smoke import fsdp_collectives
    from repro_torch.launch.specs import TRAIN_MICROBATCHES
    from test_torch_tp import _smoke_overrides

    over = _smoke_overrides(ARCH)
    rec = dryrun.run_cell(ARCH, shape, False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 4))
    sp = SHAPES[shape]
    assert rec["status"] == "ok" and rec["collectives_modelled"] is True
    if sp.kind == "train":
        cfg = build_case(ARCH, shape, **over).cfg
        plan = tp_model.make_plan(cfg, _abstract((2, 4)))
        assert plan.fsdp and "reduce-scatter" in rec["collectives"]
        want = fsdp_collectives(cfg, plan, sp.global_batch // 2, sp.seq_len,
                                TRAIN_MICROBATCHES[ARCH], cfg.n_frontend_tokens)
        got = sorted((o["kind"], o["bytes"], o["group"]) for o in rec["collective_ops"]
                     for _ in range(o["trip"]))
        assert got == want
        return
    case = build_case(ARCH, shape, **over)
    cfg = case.cfg
    plan = tp_model.make_plan(cfg, _abstract((2, 4)), "serve")
    nf, rows = cfg.n_frontend_tokens, sp.global_batch // 2
    if sp.kind == "prefill":
        want = vlm_collectives(cfg, plan, rows, sp.seq_len - nf, nf, "prefill")
    else:
        want = vlm_collectives(cfg, plan, rows, 1, 0, "decode", "seq")
    got = sorted((o["kind"], o["bytes"], o["group"]) for o in rec["collective_ops"])
    assert got == want
