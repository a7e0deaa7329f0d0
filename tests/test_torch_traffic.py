"""repro_torch.traffic against repro.traffic on the CPU.

The same numpy inputs — int8 byte matrices, weights made by
``repro.models.init_params`` and carried across with
``repro_torch.convert.params_from_numpy``, flat weight and gradient
vectors — go through both packages: row keys and orders, the MLP / head
permutations, the permuted parameter trees, the egress permutation and
its inverse, and stream BT reports must be equal exactly (the egress
permutation runs the port's ``psu_sort``, whose kernel is held against
this plain path on the card).  The last tests hold both packages to the
egress and ``benchmarks/arch_bt.py`` values pinned in ``chip_smoke.py``.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.traffic as rt
import repro_torch.traffic as tt
from chip_smoke import ARCH_BT, EGRESS, arch_bt_inputs, egress_inputs
from repro.configs import smoke_config
from repro.kernels import bt_count as rk_bt_count
from repro.kernels import quantize_egress as rk_quantize_egress
from repro.link import LinkSpec as RLinkSpec
from repro.link import TxPipeline as RTxPipeline
from repro.models import init_params
from repro_torch.convert import model_config_from_reference, params_from_numpy
from repro_torch.kernels import bt_count, quantize_egress
from repro_torch.link import LinkSpec, TxPipeline
from torch_groups import torch_threads  # noqa: F401

ARCHS = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b"]


def _int8(shape, seed):
    a = np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)
    return jnp.asarray(a), torch.from_numpy(a)


def _same(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


def _same_tree(ref: dict, got: dict):
    assert ref.keys() == got.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            _same_tree(ref[k], got[k])
        else:
            assert got[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
            _same(ref[k], got[k])


def _model(arch):
    cfg = smoke_config(arch)
    params = init_params(cfg, jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, model_config_from_reference(dataclasses.asdict(cfg)), port


@pytest.mark.parametrize("strategy,k", [("none", 4), ("acc", 4), ("app", 4), ("app", 2),
                                        ("app", 8)])
@pytest.mark.parametrize("shape", [(1, 16), (37, 16), (128, 64), (300, 5)])
def test_row_keys_and_order_match(strategy, k, shape):
    jx, tx = _int8(shape, shape[0] * 7 + k)
    _same(rt.row_bucket_keys(jx, strategy, k), tt.row_bucket_keys(tx, strategy, k))
    order = tt.row_order(tx, strategy, k)
    assert order.dtype == torch.int32
    _same(rt.row_order(jx, strategy, k), order)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_ordering_matches_on_init_params(arch):
    cfg, params, tcfg, port = _model(arch)
    _same_tree(jax.tree.map(np.asarray, params), port)  # carried across exactly
    layer0 = lambda tree: {k: layer0(v) if isinstance(v, dict) else v[0]  # noqa: E731
                           for k, v in tree.items()}
    blocks = []
    if "mlp" in params["layers"] or "attn" in params["layers"]:
        blocks.append((layer0(params["layers"]), layer0(port["layers"])))
    if "shared" in params:
        blocks.append((params["shared"], port["shared"]))
    assert blocks or arch == "mamba2-370m"
    for strategy in ("acc", "app"):
        for ref_block, port_block in blocks:
            if "mlp" in ref_block:
                perm = tt.mlp_permutation(port_block["mlp"], strategy)
                _same(rt.mlp_permutation(ref_block["mlp"], strategy), perm)
                _same_tree(rt.apply_mlp_ordering(ref_block["mlp"], rt.mlp_permutation(
                    ref_block["mlp"], strategy)), tt.apply_mlp_ordering(port_block["mlp"], perm))
            if "attn" in ref_block:
                perm = tt.head_permutation(port_block["attn"], tcfg, strategy)
                _same(rt.head_permutation(ref_block["attn"], cfg, strategy), perm)
        for k in (2, 4):
            ref = rt.apply_weight_ordering(params, cfg, strategy, k)
            got = tt.apply_weight_ordering(port, tcfg, strategy, k)
            _same_tree(jax.tree.map(np.asarray, ref), got)
    assert tt.apply_weight_ordering(port, tcfg, "none") is port


def test_weight_ordering_permutes_something():
    """The orderings above are not identities on these weights."""
    _, params, tcfg, port = _model("internlm2-1.8b")
    got = tt.apply_weight_ordering(port, tcfg, "acc")
    assert not torch.equal(got["layers"]["mlp"]["down"], port["layers"]["mlp"]["down"])
    assert torch.equal(got["embed"], port["embed"])


@pytest.mark.parametrize("strategy,k", [("app", 4), ("acc", 4), ("none", 4), ("none", 2),
                                        ("app", 9)])
@pytest.mark.parametrize("m,packet", [(64 * 300, 64), (64 * 300 + 17, 64), (48 * 101 + 5, 48),
                                      (30, 64), (1024 * 3 + 1, 1024)])
def test_egress_permutation_matches(strategy, k, m, packet):
    jw, tw = _int8((m,), m + k)
    perm, inv = rt.egress_permutation(jw, packet=packet, strategy=strategy, k=k)
    tperm, tinv = tt.egress_permutation(tw, packet=packet, strategy=strategy, k=k)
    assert tperm.dtype == tinv.dtype == torch.int32
    _same(perm, tperm)
    _same(inv, tinv)


def test_egress_permutation_none_still_sorts_and_contract():
    """The reference's quirk: strategy='none' sorts by k buckets too."""
    _, tw = _int8((64 * 50,), 1)
    perm, _ = tt.egress_permutation(tw, strategy="none", k=4)
    assert not torch.equal(perm, torch.arange(64 * 50, dtype=torch.int32))
    assert torch.equal(perm, tt.egress_permutation(tw, strategy="app", k=4)[0])
    with pytest.raises(ValueError, match="packet"):
        tt.egress_permutation(tw, packet=1025)
    with pytest.raises(TypeError, match="int8"):
        tt.egress_permutation(tw.to(torch.int32))
    with pytest.raises(ValueError, match="k must be"):
        tt.egress_permutation(tw, strategy="app", k=10)


@pytest.mark.parametrize("sm", [False, True])
@pytest.mark.parametrize("layout", ["row", "col"])
def test_stream_bt_report_matches_on_arch_bt_grid(sm, layout):
    w = arch_bt_inputs()["weights"]
    for strategy in ("none", "acc", "app"):
        ref = rt.stream_bt_report("w", jnp.asarray(w), strategy, sign_magnitude=sm,
                                  layout=layout)
        got = tt.stream_bt_report("w", torch.from_numpy(w), strategy, sign_magnitude=sm,
                                  layout=layout)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.reduction == ref.reduction
        key = f"sm={int(sm)}/{layout}/{strategy}"
        assert (ref.num_flits, ref.bt_none, ref.bt_ordered) == ARCH_BT["weights"][key]
    # another row axis and lane count
    ref = rt.stream_bt_report("t", jnp.asarray(w[:96]), "acc", row_axis=-1, lanes=8)
    got = tt.stream_bt_report("t", torch.from_numpy(w[:96]), "acc", row_axis=-1, lanes=8)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_int8_view_and_reexports_match():
    x = np.random.default_rng(3).normal(size=(33, 70)).astype(np.float32)
    _same(rt.int8_view(jnp.asarray(x)), tt.int8_view(torch.from_numpy(x)))
    q8 = _int8((50, 16), 4)
    _same(rt.to_sign_magnitude(q8[0]), tt.to_sign_magnitude(q8[1]))
    _same(rt.tensor_flit_stream(q8[0], 8), tt.tensor_flit_stream(q8[1], 8))


def test_both_packages_reproduce_the_egress_pins():
    """chip_smoke.py phase 3d (i): the quantized 2**20 gradient's digests
    and the BT of its wire before and after the static permutation."""
    e = EGRESS
    g, w = egress_inputs()
    rq, rs, _ = rk_quantize_egress(jnp.asarray(g), block=e["block"])
    tq, ts, _ = quantize_egress(torch.from_numpy(g), block=e["block"])
    for q, s in ((np.asarray(rq), np.asarray(rs)), (tq.numpy(), ts.numpy())):
        assert hashlib.sha256(q.tobytes()).hexdigest() == e["codes_sha256"]
        assert hashlib.sha256(s.astype("<f4").tobytes()).hexdigest() == e["scales_sha256"]
    rw8, tw8 = rt.int8_view(jnp.asarray(w)), tt.int8_view(torch.from_numpy(w))
    for strategy, pin in e["bt"].items():
        perm, _ = rt.egress_permutation(rw8, packet=e["packet"], strategy=strategy, k=4)
        tperm, _ = tt.egress_permutation(tw8, packet=e["packet"], strategy=strategy, k=4)
        ref = (int(rk_bt_count(rt.tensor_flit_stream(rq))),
               int(rk_bt_count(rt.tensor_flit_stream(rq[jnp.asarray(perm)]))))
        wire = tq.view(torch.uint8)
        got = (int(bt_count(tt.tensor_flit_stream(wire))),
               int(bt_count(tt.tensor_flit_stream(wire[tperm.to(torch.int64)]))))
        assert ref == got == pin, strategy


def test_both_packages_reproduce_the_arch_bt_pins():
    """chip_smoke.py phase 3d: benchmarks/arch_bt.py rows 3 (MoE dispatch)
    and 4 (grad egress) on its own inputs (row 1 is held above)."""
    a = arch_bt_inputs()
    spec = dict(flits_per_packet=1, input_lanes=16, weight_lanes=0, key="row_bucket",
                encode="sign_magnitude", pack="row", k=4)
    rt8, tt8 = rt.int8_view(jnp.asarray(a["tokens"])), tt.int8_view(torch.from_numpy(a["tokens"]))
    ref = tuple(RTxPipeline(RLinkSpec(**{**spec, "key": key})).measure_rows(rt8).total_bt
                for key in ("none", "row_bucket"))
    got = tuple(TxPipeline(LinkSpec(**{**spec, "key": key}), device="cpu").measure_rows(tt8)
                .total_bt for key in ("none", "row_bucket"))
    assert ref == got == ARCH_BT["moe_dispatch"]
    perm, _ = rt.egress_permutation(rt.int8_view(jnp.asarray(a["wflat"])), packet=64)
    tperm, _ = tt.egress_permutation(tt.int8_view(torch.from_numpy(a["wflat"])), packet=64)
    rg, tg = rt.int8_view(jnp.asarray(a["grad"])), tt.int8_view(torch.from_numpy(a["grad"]))
    ref = (int(rk_bt_count(rt.tensor_flit_stream(rg))),
           int(rk_bt_count(rt.tensor_flit_stream(rg[jnp.asarray(perm)]))))
    got = (int(bt_count(tt.tensor_flit_stream(tg))),
           int(bt_count(tt.tensor_flit_stream(tg[tperm.to(torch.int64)]))))
    assert ref == got == ARCH_BT["grad_egress"]
