"""FSDP over "data": repro_torch's gather at use and gradient reduce-scatter
over gloo process groups on the CPU.

The reference's rules (``repro/launch/sharding.py`` ``_fsdp_spec``) split
every large leaf of an ``fsdp`` config over "data" as well as "model" in
training; GSPMD gathers such a weight at use, layer by layer inside the
remat'd scan, and reduce-scatters its gradient.  The port runs that
dataflow itself (``launch/tp.py`` ``gather_from_data``,
``launch/tp_model.py``'s ``Plan.fsdp``, ``launch/step.py``).  Held here:

* ``gather_from_data`` over 2 and 4 ranks: its forward equals an
  all-gather along the dim, its backward a SUM reduce-scatter back to the
  rank's block; on a stand-in group it records on ``meta`` tensors only.
* the plans: each data-split leaf and its dim read from the rules, never a
  layer axis; internvl2-26b's head "whole" and ``wk`` / ``wv`` split on
  "data" only on 16 x 16.
* the FSDP placed step, one gloo group of 4 ranks on (2, 2) (the smoke
  internvl2-26b with patches, the smoke qwen3-moe-30b-a3b, EP x FSDP, and
  the smoke internlm2-1.8b with ``fsdp=True``) and one of 2 on (2, 1)
  (internvl2-26b), each at 1 and 2 microbatches, from the JAX package's
  numpy weights (``place_state`` cuts them leaf by leaf, m / v made at
  block shape): loss and ``grad_norm`` within 1e-5 of the one-process port
  step, params within 2e-4 of it and within the reference's 5e-3 of its
  jitted one-device step (run here while the ranks run); each rank's
  params, m and v exactly its spec's blocks; the collectives equal to
  ``chip_smoke.fsdp_collectives`` (each data-split leaf all-gathered twice
  a layer a microbatch and reduce-scattered once, no whole-gradient
  all-reduce over "data"); a norm whose data-split squares matter.
* the meta dry run of both FSDP configs' smoke ``train_4k`` cells on a
  2 x 4 stand-in mesh: modelled, and equal to the closed form.
"""

import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import draw_params, fsdp_collectives
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun, tp_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import params_shardings, to_placements
from repro_torch.launch.specs import build_case
from repro_torch.launch.step import _region
from repro_torch.launch.tp import AxisGroup, gather_from_data
from repro_torch.models import param_shapes
from repro_torch.roofline import record_collectives
from repro_torch.train import make_train_step
from repro_torch.train.step import make_loss_fn, value_and_grad
from torch_groups import DEADLINE, load, ranks as start_ranks, shared, tensors, wait
from torch_groups import torch_threads  # noqa: F401

TOL = 1e-5  # loss and grad norm vs the one-process port step
PARAM_TOL = 2e-4  # params vs the one-process step (AdamW's elementwise scaling)
REF_TOL = 5e-3  # vs the reference's jitted step (tests/test_distributed.py)
BATCH, SEQ = 8, 32  # SEQ positions a row, a vlm's patches among them
INTERNVL, QWEN, INTERNLM = "internvl2-26b", "qwen3-moe-30b-a3b", "internlm2-1.8b"
ARCHS = (INTERNVL, QWEN, INTERNLM)
CASES = [(a, (2, 2), mb) for a in ARCHS for mb in (1, 2)] + [
    (INTERNVL, (2, 1), mb) for mb in (1, 2)]
MESHES = {4: ((2, 2),), 2: ((2, 1),)}
OCFG = optim.AdamWConfig(total_steps=10, warmup_steps=1)
GATHER_SHAPE = (3, 4, 6)  # a rank's block; gathered along each of its dims


def _tag(arch: str, shape: tuple, mb: int) -> str:
    return f"{arch}@{'x'.join(map(str, shape))}/mb{mb}"


def _cfg(arch: str):
    return smoke_config(arch, dtype="float32", fsdp=True)


@shared
def step_inputs(arch: str):
    """(config, numpy weights, a batch of BATCH rows of SEQ positions: a
    vlm's tokens behind its patches, labels -100 over the patches)."""
    cfg = _cfg(arch)
    params = draw_params(cfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    if cfg.family != "vlm":
        return cfg, params, {k: rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
                             for k in ("tokens", "labels")}
    nf = cfg.n_frontend_tokens
    lab = rng.integers(0, cfg.vocab, (BATCH, SEQ - nf), dtype=np.int32)
    return cfg, params, {
        "tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ - nf), dtype=np.int32),
        "patches": rng.standard_normal((BATCH, nf, cfg.d_model), dtype=np.float32),
        "labels": np.pad(lab, ((0, 0), (nf, 0)), constant_values=-100)}


def _ops_rows(ops: list) -> np.ndarray:
    kinds = {"all-gather": 0, "all-reduce": 1, "reduce-scatter": 2}
    return np.array(sorted([kinds[o["kind"]], o["bytes"], o["group"]] for o in ops
                           for _ in range(o["trip"])), dtype=np.int64).reshape(-1, 3)


def _closed(ops: list) -> np.ndarray:
    return _ops_rows([{"kind": k, "bytes": b, "group": g, "trip": 1} for k, b, g in ops])


# ------------------------------------------------------------------ the ranks' work


def _gather_checks(world: int) -> dict:
    """``gather_from_data`` over the whole group along each dim of a block:
    the forward against the whole tensor, the backward against the SUM of
    every rank's output gradient cut to this rank's part."""
    import torch.distributed as dist

    rank = dist.get_rank()
    g = AxisGroup(world, rank, dist.group.WORLD)
    out = {}
    for dim in range(len(GATHER_SHAPE)):
        shape = list(GATHER_SHAPE)
        shape[dim] *= world
        whole = torch.randn(shape, generator=torch.Generator().manual_seed(dim))
        block = whole.narrow(dim, rank * GATHER_SHAPE[dim], GATHER_SHAPE[dim]).clone()
        douts = [torch.randn(shape, generator=torch.Generator().manual_seed(100 + r))
                 for r in range(world)]
        x = block.requires_grad_(True)
        with record_collectives() as ops:
            y = gather_from_data(x, g, dim)
            y.backward(douts[rank])
        want = sum(douts).narrow(dim, rank * GATHER_SHAPE[dim], GATHER_SHAPE[dim])
        out[f"gather/{world}/{dim}/fwd"] = np.array(float((y.detach() - whole).abs().max()))
        out[f"gather/{world}/{dim}/bwd"] = np.array(float((x.grad - want).abs().max()))
        out[f"gather/{world}/{dim}/ops"] = _ops_rows(ops)
    return out


def _placed_step(arch: str, shape: tuple, mb: int, mesh) -> dict:
    from repro_torch import _obs_hooks
    from repro_torch.launch.step import gather, make_placed_train_step, place_state

    tag = _tag(arch, shape, mb)
    cfg, params_np, batch_np = step_inputs(arch)
    p, o = place_state(cfg, mesh, params_np)  # numpy leaves; m / v made at block shape
    step = make_placed_train_step(cfg, OCFG, mesh, microbatches=mb)
    tapped = []
    _obs_hooks.TAP = SimpleNamespace(tap=lambda kind, payload: tapped.append(
        [x.clone() for x in leaves(payload["grads"])]))
    try:
        with record_collectives() as ops:
            p, o, m = step(p, o, tensors(batch_np))
    finally:
        _obs_hooks.TAP = None
    out = {f"{tag}/loss": m["loss"].numpy(), f"{tag}/grad_norm": m["grad_norm"].numpy(),
           f"{tag}/ops": _ops_rows(ops)}
    for key, tree in (("p", p), ("m", o.m), ("v", o.v)):
        for i, x in enumerate(leaves(tree)):
            out[f"{tag}/{key}shape{i}"] = np.array(x.to_local().shape)
    for i, x in enumerate(leaves(p)):
        out[f"{tag}/p{i}"] = gather(x).numpy()
    for i, x in enumerate(tapped[0]):
        out[f"{tag}/g{i}"] = x.numpy()
    return out


def run_rank(world: int) -> dict:
    """Everything one rank of a ``world``-rank gloo group computes."""
    from repro_torch.launch.mesh import _device_mesh

    out = _gather_checks(world)
    for shape in MESHES[world]:
        mesh = _device_mesh(shape, ("data", "model"), "cpu")
        for arch, m, mb in CASES:
            if m == shape:
                out.update(_placed_step(arch, m, mb, mesh))
    return out


_WORKER = """
    import sys
    from test_torch_fsdp import run_rank
    from torch_groups import join, leave
    rank, world, out = join(sys.argv)
    leave(out + f"/rank{rank}.npz", run_rank(world))
"""


def _reference_step(arch: str, mb: int) -> tuple:
    """The reference's jitted one-device step of ``arch`` at ``mb``
    microbatches on the same numpy weights and batch: (loss, params)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as rsmoke_config
    from repro.optim import AdamWConfig as RAdamWConfig
    from repro.optim import init as ropt_init
    from repro.train import make_train_step as rmake_train_step

    _, params_np, batch_np = step_inputs(arch)
    rcfg = rsmoke_config(arch, dtype="float32", fsdp=True)
    params = jax.tree.map(jnp.asarray, params_np)
    step = jax.jit(rmake_train_step(rcfg, RAdamWConfig(total_steps=10, warmup_steps=1),
                                    microbatches=mb))
    p, _, m = step(params, ropt_init(params), jax.tree.map(jnp.asarray, batch_np))
    return float(m["loss"]), [np.asarray(x) for x in jax.tree.leaves(p)]


def _reference_steps() -> dict:
    """{(arch, microbatches): the reference's step}, compiled on threads
    (XLA's compile runs outside the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    keys = [(a, mb) for a in ARCHS for mb in (1, 2)]
    with ThreadPoolExecutor(3) as pool:
        return dict(zip(keys, pool.map(lambda k: _reference_step(*k), keys)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({world: [each rank's results]}, the reference's steps): both gloo
    groups run as separate processes while the reference compiles here,
    all within one deadline."""
    deadline = time.monotonic() + DEADLINE
    dirs = {world: tmp_path_factory.mktemp(f"fsdp{world}") for world in MESHES}
    procs = [p for w, tmp in dirs.items() for p in start_ranks(tmp, _WORKER, w)]
    try:
        ref = _reference_steps()
    finally:
        wait(procs, deadline)
    return {w: load(tmp, w) for w, tmp in dirs.items()}, ref


def _results(ranks, shape) -> list:
    """The results of ``shape``'s group, in rank order (data index x m +
    model index)."""
    return ranks[0][shape[0] * shape[1]]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _abstract(shape) -> AbstractMesh:
    return AbstractMesh(tuple(shape), ("data", "model"))


@shared
def _one_process(arch: str, mb: int):
    """The one-process port step: (params, metrics)."""
    cfg, params_np, batch_np = step_inputs(arch)
    params = params_from_numpy(params_np, "cpu")
    p, _, m = make_train_step(cfg, OCFG, microbatches=mb)(
        params, optim.init(params), tensors(batch_np))
    return [x.numpy() for x in leaves(p)], {k: v.numpy() for k, v in m.items()}


_IDS = [_tag(*c) for c in CASES]


# ------------------------------------------------------------------ the operator


@pytest.mark.parametrize("world", sorted(MESHES))
def test_gather_from_data_is_an_all_gather_and_a_reduce_scatter(ranks, world):
    for res in ranks[0][world]:
        for dim in range(len(GATHER_SHAPE)):
            assert float(res[f"gather/{world}/{dim}/fwd"]) == 0.0
            assert float(res[f"gather/{world}/{dim}/bwd"]) <= 1e-6
            whole = int(np.prod(GATHER_SHAPE)) * 4 * world
            np.testing.assert_array_equal(res[f"gather/{world}/{dim}/ops"],
                                          [[0, whole, world], [2, whole // world, world]])


def test_gather_from_data_records_on_meta_over_a_stand_in():
    g = AxisGroup(4)
    x = torch.empty((2, 3), device="meta", requires_grad=True)
    with record_collectives() as ops:
        y = gather_from_data(x, g, -1)
        y.backward(torch.empty_like(y))
    assert y.shape == (2, 12) and y.device.type == "meta" and x.grad.shape == (2, 3)
    assert [(o["kind"], o["bytes"], o["group"]) for o in ops] == [
        ("all-gather", 2 * 12 * 4, 4), ("reduce-scatter", 2 * 3 * 4, 4)]
    with pytest.raises(ValueError, match="stand-in"):
        gather_from_data(torch.zeros(2, 3), g, 0)
    one = torch.zeros(2, 3)
    assert gather_from_data(one, AxisGroup(1), 0) is one


# ------------------------------------------------------------------ the plans


def _data_dims(cfg, mesh) -> dict:
    """Leaf path -> the dim (from the end) the rules split over "data"."""
    tree = param_shapes(cfg)
    out = {}
    for (path, t), sh in zip(leaves_with_path(tree),
                             leaves(params_shardings(cfg, mesh, tree, "train"))):
        for d, e in enumerate(sh.spec):
            if e == "data":
                out[path] = d - t.dim()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_reads_the_data_split_from_the_rules(arch):
    cfg = _cfg(arch)
    shapes = dict(leaves_with_path(param_shapes(cfg)))
    for shape in ((2, 2), (2, 1), (1, 2)):
        plan = tp_model.make_plan(cfg, _abstract(shape))
        want = _data_dims(cfg, _abstract(shape)) if shape[0] > 1 else {}
        assert dict(plan.fsdp) == want and plan.fsdp_group.size == shape[0]
        assert all(d != -shapes[p].dim() for p, d in want.items() if p.startswith("['layers']"))
    # serving is never FSDP-placed
    assert not tp_model.make_plan(cfg, _abstract((2, 2)), "serve").fsdp


@pytest.mark.parametrize("arch,leaves_split", [(INTERNVL, 8), (QWEN, 10)])
def test_production_fsdp_plans(arch, leaves_split):
    """16 x 16 and 2 x 16 x 16: every large leaf split over "data" on a dim
    that is not its layer axis; internvl2-26b's head has no "model" split
    (92,553 is odd) and its 8 kv heads on 16 ranks are split over "data"
    only, so the head runs "whole" and ``wk`` / ``wv`` are partial."""
    cfg = get_config(arch)
    for shape, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        mesh = AbstractMesh(shape, names)
        plan = tp_model.make_plan(cfg, mesh)
        assert len(plan.fsdp) == leaves_split and plan.fsdp == _data_dims(cfg, mesh)
        assert plan.fsdp_group.size == 16 and plan.fsdp_rest.size == (2 if len(shape) == 3 else 1)
        if arch == INTERNVL:
            assert (plan.head, plan.kv, plan.attn) == ("whole", "whole", "heads")
            assert {p.rsplit("['", 1)[-1][:-2] for p in plan.partial} == {"wk", "wv"}
            assert "['layers']['attn']['wk']" in plan.fsdp
            assert "['layers']['attn']['wk']" not in plan.split


def test_fsdp_refused_outside_the_dense_vlm_and_moe_families():
    cfg = smoke_config("mamba2-370m", fsdp=True)
    assert "FSDP" in tp_model.unsupported(cfg, _abstract((2, 2)))
    assert tp_model.unsupported(cfg, _abstract((1, 2))) is None


# ------------------------------------------------------------------ the step


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=_IDS)
def test_fsdp_step_matches_one_process_step(ranks, arch, shape, mb):
    want, m = _one_process(arch, mb)
    tag = _tag(arch, shape, mb)
    for res in _results(ranks, shape):
        assert _rel(res[f"{tag}/loss"], m["loss"]) < TOL
        assert _rel(res[f"{tag}/grad_norm"], m["grad_norm"]) < TOL
        for i, one in enumerate(want):
            assert _rel(res[f"{tag}/p{i}"], one) < PARAM_TOL, i


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=_IDS)
def test_fsdp_step_matches_reference_step(ranks, arch, shape, mb):
    loss, params = ranks[1][arch, mb]
    tag = _tag(arch, shape, mb)
    res = _results(ranks, shape)[0]
    assert abs(float(res[f"{tag}/loss"]) - loss) < REF_TOL
    for i, w in enumerate(params):
        assert np.abs(res[f"{tag}/p{i}"] - w).max() < REF_TOL, i


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=_IDS)
def test_fsdp_state_is_each_ranks_spec_block(ranks, arch, shape, mb):
    """Each rank's params, m and v are exactly its (data, model) block of
    the spec: no rank holds a whole data-split leaf."""
    cfg, params_np, _ = step_inputs(arch)
    mesh = _abstract(shape)
    specs = [sh.spec for sh in leaves(params_shardings(cfg, mesh, params_np, "train"))]
    arrays = leaves(params_np)
    tag = _tag(arch, shape, mb)
    for r, res in enumerate(_results(ranks, shape)):
        # rank r of the ranks' (data, model) mesh sits at (r // m, r % m)
        at = SimpleNamespace(get_coordinate=lambda r=r: [r // shape[1], r % shape[1]],
                             shape=mesh.shape, axis_names=mesh.axis_names)
        for i, (x, spec) in enumerate(zip(arrays, specs)):
            want = [s.stop - s.start for s in _region(x.shape, to_placements(spec, mesh), at)]
            for key in "pmv":
                assert res[f"{tag}/{key}shape{i}"].tolist() == want, (key, i)
        local = sum(int(np.prod(res[f"{tag}/pshape{i}"])) for i in range(len(arrays)))
        assert local < sum(x.size for x in arrays) // shape[0] + sum(
            x.size for x, spec in zip(arrays, specs) if "data" not in spec)


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=_IDS)
def test_fsdp_step_collectives_closed_form(ranks, arch, shape, mb):
    """Equal to ``fsdp_collectives``: each data-split leaf all-gathered
    twice a layer a microbatch (once at the embedding and the head) and
    reduce-scattered once; no all-reduce of a whole-over-"data" gradient."""
    cfg, params_np, batch_np = step_inputs(arch)
    plan = tp_model.make_plan(cfg, _abstract(shape))
    patches = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    want = _closed(fsdp_collectives(cfg, plan, BATCH // shape[0], SEQ, mb, patches))
    tag = _tag(arch, shape, mb)
    shapes = dict(leaves_with_path(params_np))
    layer_leaves = [p for p in plan.fsdp if p.startswith("['layers']")]
    # the whole-over-"data" gradient blocks a step without the scatter would
    # all-reduce (but an activation's sum over "model" of the same size)
    act = BATCH // shape[0] // mb * SEQ * cfg.d_model * 4
    old = {shapes[p].size // (shape[1] if p in plan.split else 1) * 4 for p in plan.fsdp} - {act}
    for res in _results(ranks, shape):
        got = res[f"{tag}/ops"]
        np.testing.assert_array_equal(got, want)
        scatters = [r for r in got.tolist() if r[0] == 2]
        assert len(scatters) == mb * (cfg.n_layers * len(layer_leaves) + len(plan.fsdp)
                                      - len(layer_leaves))
        if shape[1] == 1:  # every gather is FSDP's: twice a layer leaf, once a top leaf
            per_leaf = Counter()
            for p in plan.fsdp:
                n = shapes[p].size // (cfg.n_layers if p in layer_leaves else 1)
                per_leaf[n * 4] += mb * (2 * cfg.n_layers if p in layer_leaves else 1)
            assert Counter(r[1] for r in got.tolist() if r[0] == 0) == per_leaf
        assert not [r for r in got.tolist() if r[0] == 1 and r[2] == shape[0] and r[1] in old]


def test_grad_norm_sums_the_data_split_squares(ranks):
    """On (2, 1) every large leaf is split over "data" only: the norm of a
    rank's blocks alone lies far from the whole gradient's, which the
    step's ``grad_norm`` equals."""
    arch, shape = INTERNVL, (2, 1)
    cfg, params_np, batch_np = step_inputs(arch)
    params = params_from_numpy(params_np, "cpu")
    _, grads = value_and_grad(make_loss_fn(cfg), params,
                              tensors(batch_np))
    plan = tp_model.make_plan(cfg, _abstract(shape))
    mesh = _abstract(shape)
    right, alone = 0.0, 0.0
    for (path, g), sh in zip(leaves_with_path(grads),
                             leaves(params_shardings(cfg, mesh, params, "train"))):
        sq = float(torch.sum(g.double() ** 2))
        right += sq
        region = _region(g.shape, to_placements(sh.spec, mesh), mesh)
        alone += float(torch.sum(g[region].double() ** 2)) if path in plan.fsdp else sq
    right, alone = right ** 0.5, alone ** 0.5
    assert abs(alone / right - 1) > 100 * TOL
    for res in _results(ranks, shape):
        assert _rel(res[f"{_tag(arch, shape, 1)}/grad_norm"], right) < TOL


# ------------------------------------------------------------------ the meta dry run


@pytest.mark.parametrize("arch,mb", [(INTERNVL, 8), (QWEN, 4)])
def test_meta_dryrun_fsdp_smoke_train_cells(arch, mb):
    from test_torch_tp import _smoke_overrides

    over = _smoke_overrides(arch)
    rec = dryrun.run_cell(arch, "train_4k", False, verbose=False, cfg_overrides=over,
                          mesh_shape=(2, 4))
    assert rec["status"] == "ok" and rec["collectives_modelled"] is True
    assert set(rec["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    case = build_case(arch, "train_4k", **over)
    cfg, sp = case.cfg, case.shape
    plan = tp_model.make_plan(cfg, _abstract((2, 4)))
    patches = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    want = fsdp_collectives(cfg, plan, sp.global_batch // 2, sp.seq_len, mb, patches)
    np.testing.assert_array_equal(_ops_rows(rec["collective_ops"]), _closed(want))
