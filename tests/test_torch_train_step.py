"""repro_torch.train's step against repro.train's on the CPU.

The same weights (the reference's ``init_params`` carried across, or
``chip_smoke.draw_params``' numpy draws) and the same ``train_batch``
inputs go through both packages' ``make_train_step`` at dtype float32, for
the dense, MoE, SSM, encoder-decoder and VLM smoke configs: the loss and
``grad_norm`` agree within ``REL_TOL``, every gradient leaf within
``GRAD_TOL`` of its largest magnitude, and the updated params within
``PARAM_TOL`` absolute (AdamW's first step moves a weight by about lr, so
that is the scale a flipped near-zero gradient sign shows at); the
gradients' int8 bytes within one code on at most 1 % of the bytes.
Phase 3g's pins are held in ``tests/test_torch_train_pins.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN, kv_differ, train_inputs
from repro.configs import smoke_config
from repro.models import init_params
from repro.optim import AdamWConfig
from repro.optim import init as opt_init
from repro.traffic import int8_view
from repro.train import make_loss_fn, make_train_step
from repro_torch import optim as toptim
from repro_torch import train as ttrain
from repro_torch._tree import leaves
from repro_torch.convert import (
    model_config_from_reference,
    opt_state_from_reference,
    params_from_numpy,
    params_from_reference,
)
from repro_torch.obs import train_batch
from torch_groups import torch_threads  # noqa: F401

REL_TOL = 1e-4
GRAD_TOL = 1e-4
PARAM_TOL = 2 * AdamWConfig().peak_lr
FAMILIES = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-370m", "whisper-medium",
            "internvl2-26b"]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    return float(np.abs(a - np.asarray(b, np.float64)).max() / max(np.abs(a).max(), 1e-30))


def _grad_bytes(tree) -> np.ndarray:
    return np.concatenate([np.asarray(int8_view(x)).view(np.uint8).reshape(-1)
                           for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    cfg = smoke_config(arch, dtype="float32")
    params = init_params(cfg, jax.random.key(2))
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    batch = {k: v.numpy() for k, v in train_batch(tcfg, 2, 16, 3, "cpu").items()}
    ocfg = AdamWConfig(warmup_steps=1, total_steps=10)

    loss, grads = jax.jit(jax.value_and_grad(make_loss_fn(cfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = ttrain.step.value_and_grad(ttrain.make_loss_fn(tcfg), tparams,
                                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(loss, tloss) < REL_TOL
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(grads), leaves(tgrads)):
        assert g.shape == tuple(t.shape) and t.dtype == torch.float32, path
        assert _rel(g, t) < GRAD_TOL, (jax.tree_util.keystr(path), _rel(g, t))
    codes, share = kv_differ(_grad_bytes(jax.tree.map(np.asarray, tgrads)), _grad_bytes(grads))
    assert codes <= TRAIN["grad_codes"] and share <= TRAIN["grad_share"], (codes, share)

    new_p, new_o, m = jax.jit(make_train_step(cfg, ocfg))(
        params, opt_init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = ttrain.make_train_step(tcfg, toptim.AdamWConfig(warmup_steps=1, total_steps=10))
    tp, to, tm = tstep(tparams, toptim.init(tparams), {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(m[k], tm[k]) < REL_TOL, k
    for a, b in zip(jax.tree.leaves(new_p), leaves(tp)):
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= PARAM_TOL
    assert int(to.step) == int(new_o.step) == 1 and to.step.dtype == torch.int32
    for a, b in zip(jax.tree.leaves(new_o.m), leaves(to.m)):
        assert _rel(a, b) < GRAD_TOL
    # the step leaves its inputs as they were (donate=False)
    for a, b in zip(jax.tree.leaves(params), leaves(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_microbatches_match_reference_and_one_batch():
    """The strided split (row i -> microbatch i mod 2) in both packages,
    and against the whole batch."""
    cfg = smoke_config("internlm2-1.8b", dtype="float32")
    params = init_params(cfg, jax.random.key(5))
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    batch = {k: v.numpy() for k, v in train_batch(tcfg, 4, 16, 1, "cpu").items()}
    ocfg = AdamWConfig(warmup_steps=1, total_steps=10)
    tocfg = toptim.AdamWConfig(warmup_steps=1, total_steps=10)
    _, _, m = make_train_step(cfg, ocfg, microbatches=2)(
        params, opt_init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, tm2 = ttrain.make_train_step(tcfg, tocfg, microbatches=2)(
        tparams, toptim.init(tparams), tb)
    _, _, tm1 = ttrain.make_train_step(tcfg, tocfg)(tparams, toptim.init(tparams), tb)
    for k in ("loss", "grad_norm"):
        assert _rel(m[k], tm2[k]) < REL_TOL
        assert _rel(tm1[k], tm2[k]) < REL_TOL


def test_donated_step_updates_in_place_and_carried_opt_state():
    """``donate=True`` writes into the tensors passed in, with the values
    of the functional step; an ``OptState`` carried from the reference
    continues its step count."""
    cfg, params_np, batch = train_inputs("internlm2-1.8b")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ocfg = toptim.AdamWConfig(**TRAIN["opt"])
    p1 = params_from_numpy(params_np, "cpu")
    want, wopt, _ = ttrain.make_train_step(cfg, ocfg)(p1, toptim.init(p1), tb)
    p2 = params_from_numpy(params_np, "cpu")
    o2 = toptim.init(p2)
    got, _, _ = ttrain.make_train_step(cfg, ocfg, donate=True)(p2, o2, tb)
    for a, b, c in zip(leaves(want), leaves(got), leaves(p2)):
        assert torch.equal(a, b) and b is c
    for a, b in zip(leaves(wopt.v), leaves(o2.v)):
        assert torch.equal(a, b)
    ref = opt_init(jax.tree.map(jnp.asarray, params_np))._replace(step=jnp.int32(7))
    carried = opt_state_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    assert carried.step.dtype == torch.int32 and int(carried.step) == 7
    _, o3, _ = ttrain.make_train_step(cfg, ocfg)(params_from_numpy(params_np, "cpu"), carried, tb)
    assert int(o3.step) == 8
