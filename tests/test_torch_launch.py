"""repro_torch.launch (meshes, sharding rules, dry-run cases, the meta dry
run) and repro_torch.roofline against the reference on the CPU, in one
process and with no devices.

* Specs: every leaf of ``DryrunCase.shardings`` for all 10 archs x 4
  shapes x {16x16, 2x16x16} equals the reference's on a
  ``jax.sharding.AbstractMesh``, compared through ``_norm`` (a one-name
  tuple reads as the name, as jax normalises it); ZeRO-1 on every config,
  with ``ValueError`` where the reference raises ``DuplicateSpecError``
  (``fsdp`` configs); the reference's own cases of
  ``tests/test_sharding_rules.py`` and ``tests/test_zero1.py``.
* ``to_placements``: the DTensor placements of single, multi-axis and
  replicated specs.
* Roofline: ``analyse``, ``model_flops_global`` and
  ``wire_bytes_per_device`` on the same hand-built records; seconds are
  compared times each package's constant, since the constants differ.
* The meta dry run: two smoke cells whose FLOPs the model formula covers
  (decode) within 10 % of ``model_flops_global``, argument bytes equal to
  the reference's shard shapes; the CLI writes a record.
"""

import dataclasses
import json
import math
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import get_config as rget_config
from repro.launch import mesh as rmesh
from repro.launch.sharding import opt_shardings as ropt_shardings
from repro.launch.sharding import param_spec as rparam_spec
from repro.launch.sharding import params_shardings as rparams_shardings
from repro.launch.specs import build_case as rbuild_case
from repro.models import param_shapes as rparam_shapes
from repro.optim import init as ropt_init
from repro.roofline import analysis as ranalysis
from repro.roofline import collect as rcollect
from repro_torch import launch, roofline
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import P, opt_shardings, param_spec, params_shardings, to_placements
from repro_torch.models import param_shapes
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as opt_init
from repro_torch.roofline import analysis
from torch_groups import torch_threads  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec) -> tuple:
    """A spec as a plain tuple, a one-name tuple entry read as the name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, tuple) else e)
    return tuple(out)


def _ref_specs(tree) -> list:
    flat = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))
    return [(jax.tree_util.keystr(k), _norm(v.spec)) for k, v in flat]


def _port_specs(tree) -> list:
    return [(k, _norm(v.spec)) for k, v in leaves_with_path(tree)]


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dryrun_case_specs_match_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    for shape in SHAPES:
        want = rbuild_case(arch, shape).shardings(JAbstractMesh(sizes, names))
        got = launch.build_case(arch, shape).shardings(AbstractMesh(sizes, names))
        assert _port_specs(got) == _ref_specs(want), (arch, shape, mesh)
        assert len(_port_specs(got)) > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_zero1_specs_match_reference(arch):
    for sizes, names in MESHES.values():
        jm, pm = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
        case = launch.build_case(arch, "train_4k", zero1=True)
        if case.cfg.fsdp:
            with pytest.raises(Exception, match="duplicate"):  # DuplicateSpecError
                rbuild_case(arch, "train_4k", zero1=True).shardings(jm)
            with pytest.raises(ValueError, match="already holds 'data'"):
                case.shardings(pm)
            continue
        want = rbuild_case(arch, "train_4k", zero1=True).shardings(jm)
        got = case.shardings(pm)
        assert _port_specs(got) == _ref_specs(want)
        m_specs = [s for k, s in _port_specs(got[0][1]) if k.startswith(".m")]
        assert any("data" in [a for e in s if e for a in (e if isinstance(e, tuple) else (e,))]
                   for s in m_specs)


# the reference's tests/test_sharding_rules.py, run against the port
MESH = SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))


def _spec(path, shape, arch="internlm2-1.8b", mode="train"):
    got = param_spec(path, shape, get_config(arch), MESH, mode)
    assert _norm(got) == _norm(rparam_spec(path, shape, rget_config(arch), MESH, mode))
    return got


def test_reference_rule_cases():
    assert _spec("['layers']['attn']['wq']", (24, 2048, 16, 128)) == P(None, None, "model", None)
    assert _spec("['layers']['attn']['wk']", (24, 2048, 8, 128)) == P()
    assert _spec("['layers']['attn']['wo']", (24, 16, 128, 2048)) == P(None, "model", None, None)
    assert _spec("['layers']['attn']['wq']", (32, 1536, 24, 64),
                 arch="granite-moe-3b-a800m") == P(None, "model", None, None)
    assert _spec("['layers']['mlp']['gate']", (24, 2048, 8192)) == P(None, None, "model")
    assert _spec("['layers']['mlp']['down']", (24, 8192, 2048)) == P(None, "model", None)
    assert _spec("['layers']['moe']['gate']", (48, 128, 2048, 768),
                 arch="qwen3-moe-30b-a3b", mode="serve") == P(None, "model", None, None)
    assert _spec("['layers']['moe']['down']", (32, 48, 512, 1536),
                 arch="granite-moe-3b-a800m") == P(None, "model", None, None)
    assert _spec("['embed']", (92544, 2048)) == P("model", None)
    assert _spec("['embed']", (50280, 1024), arch="mamba2-370m") == P(None, "model")
    assert _spec("['layers']['ssd']['in_proj']", (48, 1024, 4384),
                 arch="mamba2-370m") == P(None, "model", None)
    assert _spec("['layers']['ssd']['conv_w']", (48, 4, 2304), arch="mamba2-370m") == P()
    assert _spec("['layers']['attn_norm']", (24, 2048)) == P()
    assert _spec("['final_norm']", (2048,)) == P()
    s = _spec("['layers']['moe']['gate']", (48, 128, 2048, 768), arch="qwen3-moe-30b-a3b")
    assert "model" in s and "data" in s  # 2D: EP x FSDP
    s2 = _spec("['layers']['moe']['gate']", (48, 128, 2048, 768), arch="qwen3-moe-30b-a3b",
               mode="serve")
    assert "data" not in s2


# the reference's tests/test_zero1.py, on a 1 x 1 mesh
def test_reference_zero1_cases():
    one = AbstractMesh((1, 1), ("data", "model"))
    cfg = get_config("internlm2-1.8b", zero1=True)
    ps = param_shapes(cfg)
    sh = opt_shardings(cfg, one, opt_init(ps), ps)
    p_sh = params_shardings(cfg, one, ps)
    assert sum("data" in str(s.spec) for s in leaves(sh.m)) > 0
    assert sum("data" in str(s.spec) for s in leaves(p_sh)) == 0
    assert sh.step.spec == P()
    rcfg = rget_config("internlm2-1.8b", zero1=True)
    rps = rparam_shapes(rcfg)
    rsh = ropt_shardings(rcfg, JAbstractMesh((1, 1), ("data", "model")),
                         jax.eval_shape(ropt_init, rps), rps)
    assert _port_specs(sh) == _ref_specs(rsh)
    cfg = get_config("internlm2-1.8b")
    sh = opt_shardings(cfg, one, opt_init(ps), ps)
    for a, b in zip(leaves(sh.m), leaves(params_shardings(cfg, one, ps))):
        assert a.spec == b.spec


def test_mesh_helpers_match_reference():
    for sizes, names in MESHES.values():
        ns = SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
        for mesh in (ns, AbstractMesh(sizes, names)):
            assert launch.dp_axes(mesh) == rmesh.dp_axes(ns)
            for axes in (("data",), ("pod", "data"), ("model", "pod"), ("nope",)):
                assert launch.axis_size(mesh, *axes) == rmesh.axis_size(ns, *axes)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert to_placements(P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert to_placements(P(), mesh) == (Replicate(),) * 3
    assert P(("data",), None) == P("data", None)  # a one-name tuple is the name
    with pytest.raises(ValueError, match="mesh order"):
        to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="splits two dims"):
        to_placements(P("data", "data"), mesh)


def test_build_case_arguments_are_meta():
    for shape in SHAPES:
        case = launch.build_case("zamba2-1.2b", shape)
        assert all(t.device.type == "meta" for a in case.args for t in leaves(a))
        ref = rbuild_case("zamba2-1.2b", shape)
        assert [tuple(t.shape) for t in leaves(case.args)] == [
            tuple(t.shape) for t in jax.tree.leaves(ref.args)]
        assert case.kind == ref.kind and case.donate == ref.donate


# ------------------------------------------------------------------ roofline


def _records() -> list:
    ops = [{"kind": k, "bytes": 1000 * (i + 1), "group": g, "trip": t}
           for i, (k, g, t) in enumerate([("all-reduce", 16, 24), ("all-gather", 16, 1),
                                          ("reduce-scatter", 4, 2), ("all-to-all", None, 1),
                                          ("collective-permute", 2, 3)])]
    base = {"mesh": "16x16", "num_devices": 256, "hlo_flops_per_device": 3.3e14,
            "hlo_bytes_per_device": 2.2e12, "peak_bytes_per_device": 9.1e9}
    return [
        {**base, "arch": "internlm2-1.8b", "shape": "train_4k", "kind": "train",
         "collective_ops": ops, "active_params": 1_889_110_016},
        {**base, "arch": "qwen3-moe-30b-a3b", "shape": "prefill_32k", "kind": "prefill",
         "wire_bytes_per_device": 4.4e9, "active_params": 3_300_000_000,
         "tpu_peak_bytes_per_device": 7.7e9},
        {**base, "arch": "zamba2-1.2b", "shape": "long_500k", "kind": "decode",
         "collective_ops": ops[:2], "active_params": 1_200_000_000},
        {**base, "arch": "whisper-medium", "shape": "decode_32k", "kind": "decode",
         "collective_ops": [], "active_params": 769_000_000},
        {**base, "arch": "whisper-medium", "shape": "train_4k", "kind": "train",
         "collective_ops": ops[3:], "active_params": 769_000_000},
        {**base, "arch": "mamba2-370m", "shape": "train_4k", "kind": "train",
         "collective_ops": ops, "active_params": 370_000_000, "hlo_flops_per_device": 1e12},
    ]


@pytest.mark.parametrize("i", range(6))
def test_roofline_matches_reference(i):
    rec = _records()[i]
    shape = SHAPES[rec["shape"]]
    s, gb = shape.seq_len, shape.global_batch
    assert analysis.model_flops_global(rec, s, gb) == ranalysis.model_flops_global(rec, s, gb)
    assert analysis.wire_bytes_per_device(rec) == ranalysis.wire_bytes_per_device(rec)
    got, want = analysis.analyse(rec, s, gb), ranalysis.analyse(rec, s, gb)
    assert got.compute_s * analysis.PEAK_FLOPS == pytest.approx(
        want.compute_s * ranalysis.PEAK_FLOPS, rel=1e-15)
    assert got.memory_floor_s * analysis.HBM_BW == pytest.approx(
        want.memory_floor_s * ranalysis.HBM_BW, rel=1e-15)
    assert got.memory_hlo_s * analysis.HBM_BW == pytest.approx(
        want.memory_hlo_s * ranalysis.HBM_BW, rel=1e-15)
    assert got.collective_s * analysis.ICI_BW == pytest.approx(
        want.collective_s * ranalysis.ICI_BW, rel=1e-15)
    for k in ("model_flops_per_device", "hlo_flops_per_device", "useful_ratio", "arch",
              "shape", "mesh", "kind"):
        assert getattr(got, k) == getattr(want, k)
    assert got.roofline_fraction * got.bound_s * analysis.PEAK_FLOPS == pytest.approx(
        want.roofline_fraction * want.bound_s * ranalysis.PEAK_FLOPS, rel=1e-12)
    # without XLA's bytes the memory term is the floor alone
    rec = {k: v for k, v in rec.items() if k != "hlo_bytes_per_device"}
    assert analysis.analyse(rec, s, gb).memory_hlo_s is None


def test_collective_records_match_reference():
    ops = _records()[0]["collective_ops"]
    assert roofline.summarize_collectives(ops) == rcollect.summarize_collectives(ops)
    assert roofline.wire_bytes(ops) == rcollect.wire_bytes(ops)
    # a one-rank group moves nothing over a link
    assert roofline.wire_bytes([{"kind": "all-reduce", "bytes": 64, "group": 1}]) == 0.0
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == (989e12, 3.35e12, 450e9)


def test_collect_from_step_on_a_cpu_step():
    from repro_torch.models import init_params
    from repro_torch.train import make_train_step

    cfg = smoke_config("internlm2-1.8b", dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(total_steps=10))
    rec = roofline.collect_from_step(step, params, opt_init(params), batch, arch=cfg.name,
                                     shape="smoke", kind="train", mesh_desc="1", num_devices=1,
                                     cfg=cfg)
    assert rec["cost_source"] == "torch.FlopCounterMode"
    assert rec["collective_ops"] == [] and rec["wire_bytes_per_device"] == 0.0
    assert "peak_bytes_per_device" not in rec and "hlo_bytes_per_device" not in rec
    model = analysis.model_flops_global(rec, 16, 2, cfg)
    assert 0.5 * model < rec["hlo_flops_per_device"] < 2 * model
    terms = roofline.analyse({**rec, "peak_bytes_per_device": 1e6}, 16, 2, cfg)
    assert terms.dominant in ("compute", "memory") and terms.collective_s == 0.0
    assert terms.measured_fraction(terms.bound_s) == pytest.approx(terms.roofline_fraction)


# ------------------------------------------------------------------ meta dry run


def _smoke_overrides(arch: str) -> dict:
    full, sm = get_config(arch), smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full, f.name)}


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "decode_32k"),
                                        ("zamba2-1.2b", "long_500k")])
def test_meta_dryrun_smoke_cells(arch, shape):
    over = _smoke_overrides(arch)
    rec = dryrun.run_cell(arch, shape, False, verbose=False, cfg_overrides=over)
    assert rec["status"] == "ok" and rec["num_devices"] == 256
    assert math.isfinite(rec["global_flops"]) and rec["global_flops"] > 0
    assert abs(rec["global_flops"] / rec["model_flops_global"] - 1) < 0.10
    # the smoke internlm2's 4 heads split attention's contraction on 16 x 16;
    # the smoke zamba2's 8 SSM heads run whole between its split SSD
    # projections, and long_500k's one request splits its KV sequence over
    # "data": both modelled
    modelled = True
    assert rec["collectives_modelled"] is modelled and bool(rec["collective_ops"]) is modelled
    # argument bytes: the reference's shard shapes of the same cell
    jm = JAbstractMesh((16, 16), ("data", "model"))
    case = rbuild_case(arch, shape, **over)
    (in_sh, _) = case.shardings(jm)
    want = 0
    for tree, sh in zip(case.args, in_sh):
        for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
                sh, is_leaf=lambda x: isinstance(x, JNamedSharding))):
            want += math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
    assert rec["argument_bytes_per_device"] == want
    terms = roofline.analyse(rec, SHAPES[shape].seq_len, SHAPES[shape].global_batch,
                             launch.build_case(arch, shape, **over).cfg)
    assert (terms.collective_s > 0) is modelled and terms.memory_hlo_s is None


def test_dryrun_cli_and_skips(tmp_path, monkeypatch, capsys):
    assert dryrun.run_cell("internlm2-1.8b", "long_500k", False)["status"] == "skipped"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "mamba2-370m", "--shape",
                                      "decode_32k", "--multipod", "--out", str(tmp_path)])
    dryrun.main()
    rec = json.loads((tmp_path / "mamba2-370m__decode_32k__2x16x16.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16" and rec["num_devices"] == 512
    assert "mamba2-370m x decode_32k" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "mamba2-370m"])
        dryrun.main()


def test_zero1_on_fsdp_params_mirrors_the_reference_spec_it_cannot_build():
    """The fsdp + zero1 spec the reference builds holds 'data' twice."""
    cfg, rcfg = get_config("qwen3-moe-30b-a3b", zero1=True), rget_config("qwen3-moe-30b-a3b",
                                                                          zero1=True)
    jm = JAbstractMesh((16, 16), ("data", "model"))
    rps = rparam_shapes(rcfg)
    with pytest.raises(Exception, match="duplicate"):
        ropt_shardings(rcfg, jm, jax.eval_shape(ropt_init, rps), rps)
    # the params' own (fsdp) specs are equal
    ps = param_shapes(cfg)
    assert _port_specs(params_shardings(cfg, AbstractMesh((16, 16), ("data", "model")), ps)) \
        == _ref_specs(rparams_shardings(rcfg, jm, rps))
