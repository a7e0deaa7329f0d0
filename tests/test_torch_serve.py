"""repro_torch.serve against repro.serve on the CPU.

The same numpy weights (``chip_smoke.serve_inputs`` for the pinned smoke
configs, or the reference's ``init_params`` carried across) and prompts go
through both packages at dtype float32: prefill and decode logits and the
KV cache agree within 1e-4 of their largest magnitude, and the KV
quantizer's codes and scales are bit-exact.  The last
tests hold both packages to phase 3f's pins in ``chip_smoke.py``
(``SERVE``): tokens, the captured weight stream's sha256, the measurement
totals exactly, KV bytes within ``SERVE['kv_codes']`` codes on at most
``SERVE['kv_share']`` of the bytes.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models as tm
import repro_torch.serve as ts
from chip_smoke import (
    SERVE,
    SERVE_ARCH,
    SERVE_ARCHS,
    SERVE_KV_PINS,
    SERVE_POINTS,
    arch_bt_row2_tensor,
    evals_digest,
    kv_bytes,
    kv_differ,
    links_digest,
    serve_grid,
    serve_inputs,
    serve_noc,
    serve_smoke,
)
from repro import obs as robs
from repro.configs import smoke_config
from repro.dse import DesignPoint, evaluate_grid
from repro.link import LinkSpec
from repro.models import init_params, prefill
from repro.noc import decode_weight_flows, mesh, simulate_noc
from repro.serve import generate
from repro.serve.loop import make_decode_fn, make_prefill_fn
from repro.serve import kv_quant as rkv
from repro.traffic import stream_bt_report
from repro_torch.convert import model_config_from_reference, params_from_reference
from torch_groups import torch_threads  # noqa: F401

# the reference's tests/test_model_equivalence.py DECODE_ARCHS
DECODE_ARCHS = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-1.2b"]
REL_TOL = 1e-4


def _carried(arch, **over):
    cfg = smoke_config(arch, dtype="float32", **over)
    params = init_params(cfg, jax.random.key(3))
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    return cfg, params, tcfg, params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                                    "cpu")


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(want - np.asarray(got, np.float64)).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match(arch):
    """The reference's jitted serving functions against the port's on the
    reference's init weights (greedy tokens of these configs are held in
    test_both_packages_hold_phase_3f_pins)."""
    cfg, params, tcfg, tparams = _carried(arch)
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    lg, cache = make_prefill_fn(cfg, 16)(params, jnp.asarray(tok[:, :12]))
    tlg, tcache = ts.make_prefill_fn(tcfg, 16)(tparams, torch.from_numpy(tok[:, :12]))
    assert _rel(lg, tlg) < REL_TOL
    assert sorted(cache) == sorted(tcache) and int(tcache["pos"]) == 12
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    lg2, cache2 = make_decode_fn(cfg)(params, cache, jnp.asarray(tok[:, 12:13]))
    tlg2, tcache2 = ts.make_decode_fn(tcfg)(tparams, tcache, torch.from_numpy(tok[:, 12:13]))
    assert _rel(lg2, tlg2) < REL_TOL
    for key in ("k", "v"):
        assert _rel(cache2[key], tcache2[key]) < REL_TOL
    assert int(tcache["pos"]) == 12 and int(tcache2["pos"]) == 13  # input cache unmodified


def test_sampled_generation_uses_the_generator():
    _, _, tcfg, tparams = _carried("internlm2-1.8b")
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    a = ts.generate(tparams, tcfg, prompts, 5, temperature=1.0,
                    generator=torch.Generator().manual_seed(1))
    b = ts.generate(tparams, tcfg, prompts, 5, temperature=1.0,
                    generator=torch.Generator().manual_seed(1))
    c = ts.generate(tparams, tcfg, prompts, 5, temperature=1.0, seed=1)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.tokens, c.tokens)
    assert a.tokens.shape == (2, 5) and int(a.tokens.max()) < tcfg.vocab
    assert bool((a.logprobs <= 0).all())


def test_kv_quant_is_bit_exact():
    cfg, params, tcfg, tparams = _carried("internlm2-1.8b")
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    _, cache = prefill(params, cfg, jnp.asarray(tok), max_len=12)
    _, tcache = tm.prefill(tparams, tcfg, torch.from_numpy(tok), 12)
    # the same float cache through both quantizers (the port's own cache is
    # equal only to rounding)
    tcache = {**tcache, "k": torch.from_numpy(np.asarray(cache["k"])),
              "v": torch.from_numpy(np.asarray(cache["v"]))}
    q, tq = rkv.quantize_cache(cache), ts.quantize_cache(tcache)
    for key in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(np.asarray(q[key]), tq[key].numpy())
    assert tq["k_q"].dtype == torch.int8 and bool(tq["quantized"])
    d, td = rkv.dequantize_cache(q, jnp.float32), ts.dequantize_cache(tq, torch.float32)
    for key in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(d[key]), td[key].numpy())
    assert rkv.cache_bytes(q) == ts.cache_bytes(tq)
    assert rkv.cache_bytes(cache) == ts.cache_bytes(tcache)
    ssm = tm.init_cache(model_config_from_reference(dataclasses.asdict(
        smoke_config("mamba2-370m"))), 1, 4, device="cpu")
    assert ts.quantize_cache(ssm) is ssm  # SSM-only cache: nothing to quantize


# ------------------------------------------------ phase 3f's pins


def reference_serve(arch: str) -> dict:
    """Phase 3f's smoke measurements through the JAX package: ``generate``
    under capture on ``serve_inputs(arch)``, then model_traffic.py's grid,
    and for SERVE_ARCH its NoC run and activity grid; arch_bt.py row 2 of
    the same weights.  Returns the pinned values and the KV bytes."""
    _, params_np, prompts, frames = serve_inputs(arch)
    cfg = smoke_config(arch, dtype="float32")
    params = jax.tree.map(jnp.asarray, params_np)
    kw = {} if frames is None else {"frames": jnp.asarray(frames)}
    with robs.capture() as sess:
        res = generate(params, cfg, jnp.asarray(prompts), SERVE["new_tokens"], **kw)
    (w,) = sess.get("serve_decode", "weights")
    wl = sess.workload("serve_decode", elems=SERVE["elems"], lanes=SERVE["lanes"],
                       names=["weights"])
    points = tuple(DesignPoint(**dataclasses.asdict(p)) for p in SERVE_POINTS)
    out = {"tokens": np.asarray(res.tokens).tolist(), "names": [s.name for s in sess.streams],
           "weights_bytes": w.num_bytes,
           "weights_sha256": hashlib.sha256(w.data.tobytes()).hexdigest(),
           "grid": {e.label: [e.total_bt, e.aux_bt] for e in evaluate_grid(points, wl)}}
    if arch == SERVE_ARCH:
        reps = []
        for key in ("none", "acc"):
            spec = LinkSpec(width_bits=8 * SERVE["lanes"],
                            flits_per_packet=SERVE["elems"] // SERVE["lanes"],
                            input_lanes=SERVE["lanes"], weight_lanes=0, key=key, k=4)
            topo = mesh(4, 4)
            flows = decode_weight_flows(jnp.asarray(w.data.view(np.int8)), topo, 0,
                                        SERVE["noc_dsts"], spec)
            reps.append(simulate_noc(topo, flows, spec, sort_at="source"))
        out["noc"] = [reps[0].total_bt, reps[1].total_bt, reps[1].active_links,
                      reps[1].total_flit_hops, links_digest(reps[1])]
        out["activity_sha256"] = evals_digest(
            evaluate_grid(points, wl, activity_windows=SERVE["window"]))
    if arch in ("internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-370m"):
        t = arch_bt_row2_tensor(params, cfg)
        rep = stream_bt_report(arch, t, "app", sign_magnitude=True, layout="col")
        out["arch_bt_row2"] = [rep.num_flits, int(rep.bt_none), int(rep.bt_ordered)]
    kv = np.concatenate([s.data for s in sess.get("serve_decode", "kv")])
    return out, kv


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_both_packages_hold_phase_3f_pins(arch):
    pin = SERVE["pins"][arch]
    ref, ref_kv = reference_serve(arch)
    assert ref == pin
    np.testing.assert_array_equal(ref_kv, np.load(SERVE_KV_PINS)[arch])

    cfg, params, sess, res = serve_smoke(arch, torch.device("cpu"))
    (w,) = sess.get("serve_decode", "weights")
    got = {"tokens": res.tokens.tolist(), "names": [s.name for s in sess.streams],
           "weights_bytes": w.num_bytes,
           "weights_sha256": hashlib.sha256(w.data.numpy().tobytes()).hexdigest(),
           "grid": {e.label: [e.total_bt, e.aux_bt] for e in serve_grid(sess)}}
    if arch == SERVE_ARCH:
        base, acc = serve_noc(w.data, "none"), serve_noc(w.data, "acc")
        got["noc"] = [base.total_bt, acc.total_bt, acc.active_links, acc.total_flit_hops,
                      links_digest(acc)]
        got["activity_sha256"] = evals_digest(serve_grid(sess, activity_windows=SERVE["window"]))
    if "arch_bt_row2" in pin:
        from repro_torch.traffic import stream_bt_report as tstream_bt_report

        rep = tstream_bt_report(arch, arch_bt_row2_tensor(params, cfg), "app",
                                sign_magnitude=True, layout="col")
        got["arch_bt_row2"] = [rep.num_flits, int(rep.bt_none), int(rep.bt_ordered)]
    assert got == pin
    codes, share = kv_differ(kv_bytes(sess), ref_kv)
    assert codes <= SERVE["kv_codes"] and share <= SERVE["kv_share"], (codes, share)
