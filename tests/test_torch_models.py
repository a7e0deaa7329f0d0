"""repro_torch.models against repro.models on the CPU.

The reference's ``init_params`` trees are carried across with
``repro_torch.convert.params_from_reference`` and the same numpy inputs go
through both packages at dtype float32.  Shapes, dtypes and integer
outputs (top-k indices, error messages) must be equal; float outputs
must agree within ``REL_TOL`` of their largest magnitude (the two
packages round the same op sequence differently only by summation
order).  The reference runs jitted where a test calls a whole model, as
its own serving and training paths do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro_torch.models as tm
from repro.configs import ARCH_NAMES, get_config, smoke_config
from repro.models import encdec_forward, forward, init_params, lm_loss, param_shapes, unembed
from repro.models.layers import attention, init_attention
from repro.models.moe import moe_block
from repro.models.ssd import ssd_scan, ssm_dims
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import (
    model_config_from_reference,
    params_from_numpy,
    params_from_reference,
)
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssd as tssd
from torch_groups import torch_threads  # noqa: F401

REL_TOL = 1e-4
FAMILY_ARCHS = {"dense": "internlm2-1.8b", "vlm": "internvl2-26b", "moe": "qwen3-moe-30b-a3b",
                "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b", "audio": "whisper-medium"}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(want - np.asarray(got, np.float64)).max() / np.abs(want).max())


def _carried(cfg, seed=2):
    params = init_params(cfg, jax.random.key(seed))
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    return params, tcfg, params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _leaves(tree, path=""):
    """(path, leaf) in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def _tree_shapes(tree):
    return {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in _leaves(tree)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shapes_match_at_full_size(arch):
    ref = jax.tree_util.tree_flatten_with_path(param_shapes(get_config(arch)))[0]
    want = {"/".join(k.key for k in path): (tuple(x.shape), str(x.dtype)) for path, x in ref}
    shapes = tm.param_shapes(tget_config(arch))
    assert _tree_shapes(shapes) == want
    assert all(t.device.type == "meta" for _, t in _leaves(shapes))  # nothing allocated


def test_init_params_scales_and_generator():
    cfg = tget_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, n_layers=2, vocab=512)
    a = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree_shapes(a) == _tree_shapes(tm.param_shapes(cfg))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))
    # dense_init: normal / sqrt(fan-in); embeddings normal x 0.02; norms ones
    for w, fan in ((a["layers"]["attn"]["wq"], 2048), (a["layers"]["attn"]["wo"], 2048),
                   (a["layers"]["mlp"]["down"], 8192), (a["head"], 2048)):
        assert abs(float(w.std()) * fan**0.5 - 1) < 0.01
    assert abs(float(a["embed"].std()) / 0.02 - 1) < 0.01
    assert bool((a["layers"]["attn_norm"] == 1).all())


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_forward_of_each_family_matches(family):
    cfg = smoke_config(FAMILY_ARCHS[family], dtype="float32")
    params, tcfg, tparams = _carried(cfg)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    if family == "audio":
        frames = rng.standard_normal((2, 8, cfg.d_model), dtype=np.float32)
        h, aux = jax.jit(encdec_forward, static_argnums=1)(params, cfg, jnp.asarray(frames),
                                                           jnp.asarray(tok))
        th, taux = tm.encdec_forward(tparams, tcfg, torch.from_numpy(frames),
                                     torch.from_numpy(tok))
    else:
        kw = {}
        if family == "vlm":
            kw["inputs_embeds"] = rng.standard_normal((2, 4, cfg.d_model), dtype=np.float32)
        fwd = jax.jit(lambda p, t, **k: forward(p, cfg, tokens=t, **k))
        h, aux = fwd(params, jnp.asarray(tok), **{k: jnp.asarray(v) for k, v in kw.items()})
        th, taux = tm.forward(tparams, tcfg, tokens=torch.from_numpy(tok),
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert th.shape == h.shape and th.dtype == torch.float32
    assert _rel(h, th) < REL_TOL
    assert abs(float(aux) - float(taux)) <= REL_TOL * max(abs(float(aux)), 1e-6)
    assert _rel(unembed(params, cfg, h), tm.unembed(tparams, tcfg, th)) < REL_TOL


@pytest.mark.parametrize("chunk", [0, 4])
def test_lm_loss_matches(chunk):
    cfg = smoke_config("qwen3-4b", dtype="float32", logits_chunk=chunk)
    params, tcfg, tparams = _carried(cfg)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    labels = rng.integers(-1, cfg.vocab, (2, 16)).astype(np.int32)
    want = float(lm_loss(params, cfg, jnp.asarray(h), jnp.asarray(labels)))
    got = float(tm.lm_loss(tparams, tcfg, torch.from_numpy(h), torch.from_numpy(labels)))
    assert abs(want - got) < REL_TOL * abs(want)


@pytest.mark.parametrize("impl", ["chunked", "chunked_skip"])
def test_chunked_attention_equals_dense_and_the_reference(impl):
    """Both chunked forms against the port's dense form and against the
    reference's same form (S = 64 > attn_chunk = 16, so the chunked path
    runs; chunked_skip's chunk floor S // 8 = 8 stays under 16)."""
    cfg = smoke_config("internlm2-1.8b", dtype="float32", attn_impl="dense")
    ap = init_attention(jax.random.key(7), cfg)
    tap = params_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    x = np.random.default_rng(8).standard_normal((2, 64, cfg.d_model), dtype=np.float32)
    pos = np.arange(64, dtype=np.int32)[None, :]
    dense = tl.attention(tap, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    c2, t2 = (dataclasses.replace(c, attn_impl=impl, attn_chunk=16) for c in (cfg, tcfg))
    got = tl.attention(tap, torch.from_numpy(x), t2, torch.from_numpy(pos))
    want = attention(ap, jnp.asarray(x), c2, jnp.asarray(pos))
    assert _rel(dense, got) < 1e-5
    assert _rel(want, got) < REL_TOL


def test_chunked_prefill_matches_the_reference():
    """A whole model's forward with chunked_skip attention over a sequence
    longer than its chunk (S = 32, chunk max(8, 32 // 8) = 8: four query
    chunks), against the reference and the port's dense form."""
    cfg = smoke_config("internlm2-1.8b", dtype="float32", attn_impl="chunked_skip",
                       attn_chunk=8)
    params, tcfg, tparams = _carried(cfg)
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    h, _ = jax.jit(lambda p, t: forward(p, cfg, tokens=t))(params, jnp.asarray(tok))
    th, _ = tm.forward(tparams, tcfg, tokens=torch.from_numpy(tok))
    assert _rel(h, th) < REL_TOL
    dense, _ = tm.forward(tparams, dataclasses.replace(tcfg, attn_impl="dense"),
                          tokens=torch.from_numpy(tok))
    assert _rel(dense, th) < 1e-5


def test_ssd_scan_matches_the_reference():
    rng = np.random.default_rng(10)
    b, s, h, p, n = 2, 32, 3, 4, 5
    xs = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, h, n), dtype=np.float32)
    h0 = rng.standard_normal((b, h, n, p), dtype=np.float32)
    for chunk, init in ((8, None), (32, h0), (4, h0)):
        y, hl = ssd_scan(*map(jnp.asarray, (xs, dt, a, bm, cm)), chunk=chunk,
                         h0=None if init is None else jnp.asarray(init))
        ty, thl = tssd.ssd_scan(*map(torch.from_numpy, (xs, dt, a, bm, cm)), chunk=chunk,
                                h0=None if init is None else torch.from_numpy(init))
        assert _rel(y, ty) < REL_TOL and _rel(hl, thl) < REL_TOL


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    for k in (1, 2, 3, 5):
        v, i = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(np.asarray(i), ti.numpy())
        np.testing.assert_array_equal(np.asarray(v), tv.numpy())


def test_moe_block_with_tied_router_matches():
    """A zero router ties every expert: the dispatch then rests on the tie
    order, the capacity cumsum and the drops."""
    cfg = smoke_config("qwen3-moe-30b-a3b", dtype="float32")
    params, tcfg, tparams = _carried(cfg)
    lp = jax.tree.map(lambda v: v[0], params["layers"]["moe"])
    lp = {**lp, "router": jnp.zeros_like(lp["router"])}
    tlp = params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")
    x = np.random.default_rng(11).standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    for dropless in (False, True):
        y, aux = moe_block(lp, jnp.asarray(x), cfg, dropless=dropless)
        ty, taux = tmoe.moe_block(tlp, torch.from_numpy(x), tcfg, dropless=dropless)
        assert _rel(y, ty) < REL_TOL
        assert abs(float(aux) - float(taux)) < 1e-6


def test_errors_carry_the_reference_messages():
    cfg = smoke_config("mamba2-370m")
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    z = np.zeros((1, 12, 2, 2), np.float32)
    args = (z, z[..., 0], np.zeros(2, np.float32), z, z)
    with pytest.raises(ValueError) as ref:
        ssd_scan(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError) as got:
        tssd.ssd_scan(*map(torch.from_numpy, args), chunk=8)
    assert str(got.value) == str(ref.value) == "seq 12 not divisible by chunk 8"
    bad = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, head_dim=48))
    tbad = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, head_dim=48))
    with pytest.raises(ValueError) as ref:
        ssm_dims(bad)
    with pytest.raises(ValueError) as got:
        tssd.ssm_dims(tbad)
    assert str(got.value) == str(ref.value)
    dcfg = model_config_from_reference(dataclasses.asdict(smoke_config("internlm2-1.8b")))
    tparams = tm.init_params(dcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prompt length 8 exceeds cache capacity 4"):
        tm.prefill(tparams, dcfg, torch.zeros((1, 8), dtype=torch.int32), 4)


def test_bfloat16_parameters_carry_across():
    """``params_from_numpy`` takes ml_dtypes bfloat16 arrays (as their
    uint16 bits): a param_dtype="bfloat16" config's reference tree carries
    across bit for bit and runs."""
    cfg = smoke_config("qwen3-4b", param_dtype="bfloat16", dtype="float32")
    params, tcfg, tparams = _carried(cfg)
    ref = jax.tree.map(np.asarray, params)
    assert ref["embed"].dtype == ml_dtypes.bfloat16
    for (path, a), (_, t) in zip(_leaves(ref), _leaves(tparams)):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(a.view(np.uint16), t.view(torch.int16).numpy().view(
            np.uint16))
    tok = np.random.default_rng(12).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    h, _ = jax.jit(lambda p, t: forward(p, cfg, tokens=t))(params, jnp.asarray(tok))
    th, _ = tm.forward(tparams, tcfg, tokens=torch.from_numpy(tok))
    assert _rel(h, th) < REL_TOL
    with pytest.raises(ValueError, match="do not fit the port's tree"):
        params_from_reference(ref, model_config_from_reference(
            dataclasses.asdict(smoke_config("qwen3-4b"))), "cpu")
