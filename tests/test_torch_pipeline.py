"""repro_torch.launch.pipeline: the GPipe schedule over a 2-stage gloo
"pipe" group on the CPU equals the unpipelined stack.

Two processes (``file://`` rendezvous, one CPU thread each) run
``pipeline_apply`` over the smoke internlm2-1.8b's 8 layers (float32) as 2
stages of 4 layers on 4 microbatches, then its backward.  Held as the
reference's ``tests/test_pipeline.py`` holds its 4-device run: the output
within 1e-5 of the sequential stack's largest magnitude, and each stage's
gradient within 1e-4 x max(scale, 1) of the sequential stack's (scale:
the largest gradient magnitude), against the port's sequential stack and
the reference's (``repro.models.transformer._attn_layer`` under
``lax.scan``) on the same weights.  Each rank's other stage gets no
gradient.  ``stack_stages`` and its refusal of an uneven split are
checked in this process.
"""

import numpy as np
import pytest
import torch

from chip_smoke import draw_params
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.pipeline import stack_stages
from repro_torch.models.transformer import _attn_layer, _layer
from torch_groups import load, run_ranks, torch_threads  # noqa: F401

PIPE = {"arch": "internlm2-1.8b", "layers": 8, "stages": 2, "micro": 4, "mb": 2, "seq": 16,
        "seed": 0}
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def pipe_inputs():
    cfg = smoke_config(PIPE["arch"], n_layers=PIPE["layers"], dtype="float32")
    params = draw_params(cfg, np.random.default_rng(PIPE["seed"]))
    x = np.random.default_rng(PIPE["seed"] + 1).standard_normal(
        (PIPE["micro"], PIPE["mb"], PIPE["seq"], cfg.d_model)).astype(np.float32)
    return cfg, params["layers"], x


def stage_fn_for(cfg):
    pos = torch.arange(PIPE["seq"])[None, :]

    def stage_fn(sp, h):
        for i in range(leaves(sp)[0].shape[0]):
            h = _attn_layer(_layer(sp, i), h, cfg, pos)
        return h

    return stage_fn


_WORKER = """
    import sys
    import numpy as np, torch
    from test_torch_pipeline import pipe_inputs, stage_fn_for
    from repro_torch._tree import leaves, tree_map
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.pipeline import make_pipe_mesh, pipeline_apply, stack_stages
    from repro_torch.roofline import record_collectives
    from torch_groups import join, leave

    rank, world, out = join(sys.argv)
    cfg, layers, x = pipe_inputs()
    staged = tree_map(lambda p: p.requires_grad_(True),
                      stack_stages(params_from_numpy(layers, "cpu"), world))
    mesh = make_pipe_mesh(world, "cpu")
    with record_collectives() as ops:
        y = pipeline_apply(stage_fn_for(cfg), staged, torch.from_numpy(x), mesh)
        y.sum().backward()
    res = {"out": y.detach().numpy(), "kinds": np.array(sorted({o["kind"] for o in ops}))}
    for i, p in enumerate(leaves(staged)):
        res[f"g{i}"] = p.grad.numpy()
    leave(out + f"/pipe{rank}.npz", res)
"""


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    run_ranks(tmp, _WORKER, PIPE["stages"])
    return load(tmp, PIPE["stages"], "pipe")


def _port_sequential():
    cfg, layers, x = pipe_inputs()
    live = tree_map(lambda p: p.requires_grad_(True), params_from_numpy(layers, "cpu"))
    fn = stage_fn_for(cfg)
    out = torch.stack([fn(live, torch.from_numpy(x[i])) for i in range(PIPE["micro"])])
    out.sum().backward()
    grads = stack_stages(tree_map(lambda p: p.grad, live), PIPE["stages"])
    return out.detach().numpy(), [g.numpy() for g in leaves(grads)]


def _reference_sequential():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.configs import smoke_config as rsmoke_config
    from repro.launch.pipeline import stack_stages as rstack_stages
    from repro.models.transformer import _attn_layer as r_attn_layer

    _, layers, x = pipe_inputs()
    rcfg = rsmoke_config(PIPE["arch"], n_layers=PIPE["layers"], dtype="float32")
    pos = jnp.arange(PIPE["seq"])[None, :]

    def stage_fn(sp, h):
        h, _ = lax.scan(lambda c, lp: (r_attn_layer(lp, c, rcfg, pos), None), h, sp)
        return h

    def run(p):
        return jnp.stack([stage_fn(p, jnp.asarray(x[i])) for i in range(PIPE["micro"])])

    layers = jax.tree.map(jnp.asarray, layers)
    out = run(layers)
    grads = rstack_stages(jax.grad(lambda p: run(p).sum())(layers), PIPE["stages"])
    return np.asarray(out), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("against", ["port", "reference"])
def test_pipeline_matches_sequential_stack(pipe_run, against):
    want, want_g = _port_sequential() if against == "port" else _reference_sequential()
    scale = max(float(np.abs(g).max()) for g in want_g)
    for r, res in enumerate(pipe_run):
        err = float(np.abs(res["out"] - want).max() / np.abs(want).max())
        assert err < OUT_TOL, (r, err)
        for i, g in enumerate(want_g):
            got = res[f"g{i}"]
            # this rank's stage gets its gradient; the other stage none
            assert float(np.abs(got[r] - g[r]).max()) < GRAD_TOL * max(scale, 1.0), (r, i)
            assert not np.any(got[1 - r])


def test_pipeline_sends_and_broadcasts(pipe_run):
    for res in pipe_run:
        assert set(res["kinds"]) == {"all-reduce", "collective-permute"}


def test_stack_stages():
    _, layers, _ = pipe_inputs()
    t = params_from_numpy(layers, "cpu")
    staged = stack_stages(t, 4)
    for a, b in zip(leaves(staged), leaves(t)):
        assert a.shape == (4, 2) + tuple(b.shape[1:])
        assert torch.equal(a.reshape(b.shape), b)
    with pytest.raises(ValueError, match="not divisible"):
        stack_stages(t, 3)
