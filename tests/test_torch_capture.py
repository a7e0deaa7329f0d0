"""repro_torch.obs.capture against repro.obs.capture on the CPU.

The reference's weights are carried across (``params_from_reference``)
and the same numpy inputs go through both packages.  Integer outputs are
exact: the captured weight bytes (one amax per stacked leaf, leaves in
``jax.tree.leaves`` order), the KV row of a cache, MoE dispatch buffers,
stream names and order, ``.npz`` sessions read by the other package,
workload BT totals, ``benchmarks/arch_bt.py`` row 2 and the error
messages.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import _obs_hooks as rhooks
from repro import obs as robs
from repro.configs import smoke_config
from repro.dse import DesignPoint as RDesignPoint
from repro.dse import evaluate_grid as revaluate_grid
from repro.models import decode_step, init_params, prefill
from repro.models.moe import init_moe, moe_block
from repro.traffic import stream_bt_report as rstream_bt_report
from repro_torch import _obs_hooks as thooks
from repro_torch import dse
from repro_torch import obs as tobs
from repro_torch.convert import (
    model_config_from_reference,
    params_from_numpy,
    params_from_reference,
)
from repro_torch.link import LinkSpec, TxPipeline
from repro_torch.models import moe as tmoe
from repro_torch.traffic import stream_bt_report
from torch_groups import torch_threads  # noqa: F401

CPU = torch.device("cpu")
# the modules (each package's obs exports a function of the same name)
rcap = importlib.import_module("repro.obs.capture")


def _carried(arch, seed=0, **over):
    cfg = smoke_config(arch, **over)
    params = init_params(cfg, jax.random.key(seed))
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    return cfg, params, tcfg, params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                                    "cpu")


def test_vocabulary_and_exports_match():
    assert tobs.TAP_SCENARIOS == robs.TAP_SCENARIOS
    assert tobs.PROBE_KINDS["capture.stream"] == "event"
    # every reference export, the training drivers included, and
    # train_batch (the reference's module function) besides
    assert set(robs.__all__) <= set(tobs.__all__) and "train_batch" in tobs.__all__
    thooks.tap("serve.weights", params={"w": torch.ones((2, 2))})  # no capture: a no-op


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b"])
def test_weight_stream_bytes_are_exact(arch):
    """The serve.weights tap's bytes on the reference's init weights: one
    symmetric int8 scale per stacked leaf, float leaves of two or more
    dimensions, in sorted-key order (a MoE and a hybrid tree here; every
    family of phase 3f, dense included, in test_torch_serve.py)."""
    _, params, _, tparams = _carried(arch)
    want, n = rcap._tree_bytes(params, 2)
    with tobs.capture() as sess:
        thooks.tap("serve.weights", params=tparams)
    (s,) = sess.streams
    assert (s.scenario, s.name, s.kind, s.meta) == ("serve_decode", "weights", "serve.weights",
                                                    {"leaves": n})
    assert s.data.dtype == torch.uint8 and s.source_shape == (want.size,)
    np.testing.assert_array_equal(s.data.numpy(), want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b", "mamba2-370m"])
def test_kv_stream_is_the_new_row_and_state(arch):
    """The serve.kv tap on the same cache in both packages: the row pos-1
    of k and v, then the SSM state trees, exactly."""
    cfg, params, tcfg, _ = _carried(arch, dtype="float32")
    tok = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)), jnp.int32)
    _, cache = prefill(params, cfg, tok[:, :8], max_len=12)
    _, cache = decode_step(params, cfg, cache, tok[:, 8:9])
    tcache = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
              for k, v in cache.items()}
    with robs.capture() as rs:
        rhooks.tap("serve.kv", cache=cache, step=3)
    with tobs.capture() as ts:
        thooks.tap("serve.kv", cache=tcache, step=3)
    (r,), (t,) = rs.streams, ts.streams
    assert (t.name, t.meta, t.source_shape) == (r.name, r.meta, r.source_shape) == (
        "kv", {"step": 3}, (r.data.size,))
    np.testing.assert_array_equal(t.data.numpy(), r.data)


def test_serving_capture_of_a_moe_config_records_no_dispatch_stream():
    """The reference jits prefill / decode, so its moe.dispatch tap sees
    tracers and records nothing while serving; the port mutes it."""
    cfg = model_config_from_reference(dataclasses.asdict(smoke_config("qwen3-moe-30b-a3b")))
    sess = tobs.capture_serve_decode(cfg, batch=2, prompt=8, new_tokens=3, device=CPU)
    assert [s.name for s in sess.streams] == ["weights", "kv", "kv", "kv"]
    assert sess.scenarios() == ("serve_decode",)
    again = tobs.capture_serve_decode(cfg, batch=2, prompt=8, new_tokens=3, device=CPU)
    assert all(torch.equal(a.data, b.data) for a, b in zip(sess.streams, again.streams))


def test_capture_moe_dispatch_expert_in_matches():
    cfg = smoke_config("qwen3-moe-30b-a3b", dtype="float32")
    tcfg = model_config_from_reference(dataclasses.asdict(cfg))
    p = init_moe(jax.random.key(4), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    with robs.capture() as rs:
        moe_block(p, jnp.asarray(x), cfg)
    with tobs.capture() as ts:
        tmoe.moe_block(tp, torch.from_numpy(x), tcfg)
    (r,), (t,) = rs.get("moe_dispatch"), ts.get("moe_dispatch")
    assert (t.name, t.kind, t.source_shape, t.meta) == (r.name, r.kind, r.source_shape, r.meta)
    np.testing.assert_array_equal(t.data.numpy(), r.data)
    drv = tobs.capture_moe_dispatch(tcfg, batch=2, seq=8, device=CPU)
    (e,) = drv.get("moe_dispatch")
    assert e.name == "expert_in" and len(e.source_shape) == 4
    with pytest.raises(ValueError, match="MoE"):
        tobs.capture_moe_dispatch(model_config_from_reference(
            dataclasses.asdict(smoke_config("qwen3-4b"))), device=CPU)


def _session_pair():
    rng = np.random.default_rng(6)
    arrays = {"a": rng.standard_normal((8, 64), dtype=np.float32),
              "b": rng.integers(-128, 128, (3, 64)).astype(np.int8),
              "c": rng.standard_normal((100,), dtype=np.float32)}
    r, t = robs.CaptureSession("pair"), tobs.CaptureSession("pair")
    for name, a in arrays.items():
        r.add("manual", name, jnp.asarray(a), kind="test", n=len(name))
        t.add("manual", name, torch.from_numpy(a), kind="test", n=len(name))
    return r, t


def _same_sessions(a, b):
    assert a.name == b.name and len(a.streams) == len(b.streams)
    for x, y in zip(a.streams, b.streams):
        assert (x.scenario, x.name, x.kind, x.source_shape, x.meta) == (
            y.scenario, y.name, y.kind, y.source_shape, y.meta)
        np.testing.assert_array_equal(np.asarray(x.data), np.asarray(y.data))


def test_npz_sessions_cross_the_packages(tmp_path):
    r, t = _session_pair()
    _same_sessions(r, _host(t))
    robs.save_session(str(tmp_path / "ref.npz"), r)
    tobs.save_session(str(tmp_path / "port.npz"), t)
    _same_sessions(r, _host(tobs.load_session(str(tmp_path / "ref.npz"), device=CPU)))
    _same_sessions(r, robs.load_session(str(tmp_path / "port.npz")))
    assert (tmp_path / "ref.npz").read_bytes() == (tmp_path / "port.npz").read_bytes()


def _host(sess):
    out = robs.CaptureSession(sess.name)
    for s in sess.streams:
        out._add_bytes(s.scenario, s.name, s.data.numpy(), s.source_shape, s.kind, s.meta)
    return out


def test_workload_bt_sums_per_stream_and_matches_the_reference():
    r, t = _session_pair()
    points = (dse.DesignPoint(ordering="none", k=None), dse.DesignPoint(ordering="app", k=4))
    wl = t.workload("manual", elems=64)
    evs = dse.evaluate_grid(points, wl)
    spec = LinkSpec(width_bits=128, flits_per_packet=4, input_lanes=16, weight_lanes=0,
                    key="none")
    per_stream = sum(int(round(TxPipeline(spec, device=CPU).measure(s).overall_bt_per_flit
                               * 4 * int(s.shape[0]))) for s in wl.streams)
    assert evs[0].total_bt == per_stream
    rpoints = tuple(RDesignPoint(**dataclasses.asdict(p)) for p in points)
    ref = revaluate_grid(rpoints, r.workload("manual", elems=64))
    assert [e.total_bt for e in evs] == [e.total_bt for e in ref]
    np.testing.assert_array_equal(t.packets("manual", 64).numpy(),
                                  np.asarray(r.packets("manual", 64)))


def test_divisibility_errors_carry_the_reference_messages():
    msgs = []
    for sess in (robs.CaptureSession(), tobs.CaptureSession()):
        sess.add("manual", "odd", np.ones((10, 10), np.float32))
        got = []
        for call in (lambda: sess.packets("manual", 64, owner="my-config", strict=True),
                     lambda: sess.packets("manual", 128, owner="my-config"),
                     lambda: sess.workload("nothing")):
            with pytest.raises(ValueError) as e:
                call()
            got.append(str(e.value))
        assert tuple(sess.packets("manual", 64).shape) == (1, 64)
        msgs.append(got)
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-370m"])
def test_arch_bt_row2_on_the_reference_init_weights(arch):
    """benchmarks/arch_bt.py row 2: layer 0's streamed MLP tensor of the
    reference's init_params(smoke_config(arch), key(0)), APP k = 4,
    sign-magnitude, column layout."""
    cfg, params, tcfg, tparams = _carried(arch)
    from chip_smoke import arch_bt_row2_tensor

    ref = rstream_bt_report(arch, arch_bt_row2_tensor(params, cfg), "app",
                            sign_magnitude=True, layout="col")
    got = stream_bt_report(arch, arch_bt_row2_tensor(tparams, tcfg), "app",
                           sign_magnitude=True, layout="col")
    assert [got.num_flits, int(got.bt_none), int(got.bt_ordered)] == [
        ref.num_flits, int(ref.bt_none), int(ref.bt_ordered)]


def test_capture_fires_probe_events_and_nests():
    with tobs.collect() as reg:
        with tobs.capture() as outer, tobs.capture() as inner:
            thooks.tap("moe.dispatch", expert_in=torch.ones((1, 2, 3, 64)))
    assert len(outer.streams) == len(inner.streams) == 1
    assert reg.value("capture.bytes", scenario="moe_dispatch", stream="expert_in") == 384
    assert reg.value("capture.streams", scenario="moe_dispatch", stream="expert_in") == 1
    assert thooks.TAP is None
    with tobs.capture() as sess, thooks.muted():
        thooks.tap("moe.dispatch", expert_in=torch.ones((1, 2, 3, 64)))
    assert sess.streams == []
