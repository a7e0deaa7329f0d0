"""repro_torch's data, optim, checkpoint and training loop against the
reference on the CPU.

* ``data``: batches byte-equal to ``repro.data``'s.
* ``optim.adamw``: the same numpy tree through both packages' ``update``,
  ``lr_schedule`` and ``global_norm`` (clipped and unclipped) within
  ``F32_TOL`` of each leaf's largest magnitude.
* ``optim.compress``: ``compressed_psum`` in modes none / bf16 / int8_ef
  against the reference, jitted under a one-device ``shard_map`` as it
  runs (int8_ef: the sum, the error buffer and the wire codes exact);
  error feedback makes the running mean converge; the ordered egress is
  transparent.
* ``checkpoint``: round trip, keep-N GC, CRC fallback, shape mismatch,
  async saves, placement onto devices, and a ``{"params", "opt"}``
  checkpoint written by either package restored by the other with equal
  arrays, paths, CRCs and manifest.
* ``train``: the loop learns, and a preempted run resumed from its
  checkpoints ends with params bitwise equal to a straight run's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.checkpoint import CheckpointManager as RManager
from repro.compat import shard_map
from repro.configs import smoke_config as rsmoke_config
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLMDataset as RDataset
from repro.models import init_params
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import CompressionConfig as RCompressionConfig
from repro.optim import compressed_psum as rcompressed_psum
from repro.optim import global_norm as rglobal_norm
from repro.optim import init as ropt_init
from repro.optim import lr_schedule as rlr_schedule
from repro.optim import update as rupdate
from repro_torch import optim
from repro_torch._tree import leaves, leaves_with_path
from repro_torch.checkpoint import CheckpointManager, restore_resharded
from repro_torch.configs import smoke_config
from repro_torch.convert import opt_state_from_reference, params_from_numpy
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.optim.compress import int8_wire
from repro_torch.traffic import egress_permutation, int8_view
from repro_torch.train import SimulatedPreemption, TrainLoopConfig, train
from torch_groups import torch_threads  # noqa: F401

F32_TOL = 1e-6


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    return float(np.abs(a - np.asarray(b, np.float64)).max() / max(np.abs(a).max(), 1e-30))


def _tree(seed=0):
    """A smoke parameter tree (the reference's init, as numpy)."""
    cfg = rsmoke_config("internlm2-1.8b", dtype="float32")
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.key(seed)))


# ------------------------------------------------ data


@pytest.mark.parametrize("cfg", [dict(vocab=256, seq_len=32, global_batch=8, seed=1, noise=0.05),
                                 dict(vocab=92544, seq_len=16, global_batch=4)])
def test_batches_are_byte_equal(cfg):
    ref, port = RDataset(RDataConfig(**cfg)), SyntheticLMDataset(DataConfig(**cfg))
    for step in (0, 7):
        a, b = ref.global_batch(step), port.global_batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes()
        for shard in range(2):
            a, b = ref.shard_batch(step, shard, 2), port.shard_batch(step, shard, 2)
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    with pytest.raises(ValueError, match="not divisible"):
        port.shard_batch(0, 0, 3)
    assert port.restore(port.state(5)) == 5


# ------------------------------------------------ adamw


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    params, grads = _tree(0), _tree(1)
    cfg = dict(peak_lr=1e-3, warmup_steps=3, total_steps=20, clip_norm=clip)
    rstate = ropt_init(jax.tree.map(jnp.asarray, params))
    state = optim.init(params_from_numpy(params, "cpu"))
    rp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")
    for it in range(3):  # carried state: step counter, moments, bias corrections
        g = jax.tree.map(lambda x: x * (it + 1), grads)
        rp, rstate, rm = rupdate(RAdamWConfig(**cfg), jax.tree.map(jnp.asarray, g), rstate, rp)
        tp, state, m = optim.update(optim.AdamWConfig(**cfg), params_from_numpy(g, "cpu"),
                                    state, tp)
        assert _rel(rm["grad_norm"], m["grad_norm"]) < F32_TOL
        assert _rel(rm["lr"], m["lr"]) < F32_TOL
        assert int(state.step) == int(rstate.step) == it + 1
        for ref_tree, tree in ((rp, tp), (rstate.m, state.m), (rstate.v, state.v)):
            for a, b in zip(jax.tree.leaves(ref_tree), leaves(tree)):
                assert b.dtype == torch.float32 and _rel(a, b) < F32_TOL
    if clip == 1.0:  # the gradient norm is far above the clip: scaled
        assert float(m["grad_norm"]) > 10 * clip


def test_lr_schedule_and_global_norm_match_reference():
    for cfg in (dict(warmup_steps=100, total_steps=10_000), dict(warmup_steps=1, total_steps=10),
                dict(warmup_steps=0, total_steps=0, min_lr_ratio=0.5)):
        r, t = rlr_schedule(RAdamWConfig(**cfg)), optim.lr_schedule(optim.AdamWConfig(**cfg))
        for step in (0, 1, 2, 5, 50, 100, 101, 5000, 10_000, 20_000):
            want = float(r(jnp.int32(step)))
            got = t(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and abs(float(got) - want) <= F32_TOL * want
    tree = _tree(3)
    assert _rel(rglobal_norm(jax.tree.map(jnp.asarray, tree)),
                optim.global_norm(params_from_numpy(tree, "cpu"))) < F32_TOL


def test_update_donate_is_in_place_and_default_is_not():
    params, grads = _tree(0), _tree(1)
    tp = params_from_numpy(params, "cpu")
    st = optim.init(tp)
    cfg = optim.AdamWConfig()
    new_p, new_s, _ = optim.update(cfg, params_from_numpy(grads, "cpu"), st, tp)
    for a, b in zip(leaves(tp), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert all(float(x.abs().max()) == 0 for x in leaves(st.m))
    got_p, got_s, _ = optim.update(cfg, params_from_numpy(grads, "cpu"), st, tp, donate=True)
    for a, b, c in zip(leaves(new_p), leaves(got_p), leaves(tp)):
        assert torch.equal(a, b) and b is c
    for a, b in zip(leaves(new_s.v), leaves(st.v)):
        assert torch.equal(a, b)


# ------------------------------------------------ compress


def _reference_psum(cfg, g, e, perm=None, inv=None):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))

    def f(g, e):
        return rcompressed_psum(g, e, cfg, ("data",), perm, inv)

    with mesh:
        out, ne = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), P()),
                                    out_specs=(P(), P())))(jnp.asarray(g), jnp.asarray(e))
    return np.asarray(out), np.asarray(ne)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("m,block", [(4096, 256), (1000, 64)])
def test_compressed_psum_matches_reference(mode, m, block):
    rng = np.random.default_rng(m)
    g = (rng.standard_normal(m) * rng.lognormal(0, 2, m)).astype(np.float32)
    e = (0.01 * rng.standard_normal(m)).astype(np.float32)
    want, want_e = _reference_psum(RCompressionConfig(mode=mode, block=block), g, e)
    cfg = optim.CompressionConfig(mode=mode, block=block)
    got, got_e = optim.compressed_psum(torch.from_numpy(g), torch.from_numpy(e), cfg)
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    if mode == "int8_ef":
        wire, scale, _ = int8_wire(torch.from_numpy(g), torch.from_numpy(e), cfg)
        assert wire.dtype == torch.int8 and wire.shape[0] == m + (-m) % block
        np.testing.assert_array_equal(
            (wire.to(torch.float32).reshape(-1, block) * scale[:, None]).reshape(-1)[:m].numpy(),
            want)
    # the compiled reference reads subnormal floats as zero and writes zero
    # for a subnormal result: a block of subnormal gradients, g = error =
    # 7e-39 (a normal sum of subnormal inputs), and a normal g and error
    # whose sum is subnormal
    for sg, se in _subnormal_cases(m, block):
        want, want_e = _reference_psum(RCompressionConfig(mode=mode, block=block), sg, se)
        got, got_e = optim.compressed_psum(torch.from_numpy(sg), torch.from_numpy(se), cfg)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_e.numpy(), want_e)


def _subnormal_cases(m: int, block: int) -> list:
    rng = np.random.default_rng(m + block)
    g = (rng.standard_normal(m) * rng.lognormal(0, 2, m)).astype(np.float32)
    e = (0.01 * rng.standard_normal(m)).astype(np.float32)
    cases = []
    a, b = g.copy(), e.copy()
    a[:block] = np.float32(1e-39) * np.sign(rng.standard_normal(block)).astype(np.float32)
    cases.append((a, b))
    a, b = g.copy(), e.copy()
    a[block: 2 * block] = np.float32(7e-39)
    b[block: 2 * block] = np.float32(7e-39)
    cases.append((a, b))
    a, b = g.copy(), e.copy()
    a[:block] = np.float32(1.5e-38)
    b[:block] = np.float32(-1.4e-38)
    a[block: 2 * block] = np.float32(3e-38)
    b[block: 2 * block] = np.float32(-2.95e-38)
    cases.append((a, b))
    return cases


def test_error_feedback_converges_and_ordered_egress_is_transparent():
    m, block = 8192, 256
    rng = np.random.default_rng(9)
    g = torch.from_numpy((rng.standard_normal(m) * rng.lognormal(0, 1, m)).astype(np.float32))
    cfg = optim.CompressionConfig(mode="int8_ef", block=block)
    err = optim.init_error_buffer(m, "cpu")
    total = torch.zeros(m)
    drift = []
    for step in range(1, 33):  # EF: the running mean of the outputs tends to g
        out, err = optim.compressed_psum(g, err, cfg)
        total += out
        drift.append(float((total / step - g).abs().max()))
    assert drift[-1] < drift[0] / 8
    assert float(err.abs().max()) <= float(g.abs().max()) / 127
    w8 = int8_view(torch.from_numpy(rng.standard_normal(m).astype(np.float32)))
    perm, inv = egress_permutation(w8, packet=64)
    assert not torch.equal(perm, torch.arange(m, dtype=torch.int32))
    ocfg = optim.CompressionConfig(mode="int8_ef", block=block, use_egress_ordering=True)
    e0 = torch.zeros(m)
    a, ea = optim.compressed_psum(g, e0, cfg)
    b, eb = optim.compressed_psum(g, e0, ocfg, perm=perm, inv_perm=inv)
    assert torch.equal(a, b) and torch.equal(ea, eb)
    want, _ = _reference_psum(RCompressionConfig(mode="int8_ef", block=block,
                                                 use_egress_ordering=True),
                              g.numpy(), e0.numpy(), perm.numpy(), inv.numpy())
    np.testing.assert_array_equal(b.numpy(), want)


# ------------------------------------------------ checkpoint


def _opt_tree(seed=0):
    params = jax.tree.map(jnp.asarray, _tree(seed))
    st = ropt_init(params)
    st = st._replace(step=jnp.int32(4), m=jax.tree.map(lambda x: x + 1, st.m))
    return {"params": params, "opt": st}


def test_checkpoint_roundtrip_gc_and_async(tmp_path):
    tree = _opt_tree()
    port = {"params": params_from_numpy(jax.tree.map(np.asarray, tree["params"]), "cpu"),
            "opt": opt_state_from_reference(jax.tree.map(np.asarray, tree["opt"]), "cpu")}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, port, extra={"data_step": s})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got, extra, step = mgr.restore(port)
    assert step == 3 and extra == {"data_step": 3}
    assert isinstance(got["opt"], optim.OptState) and got["opt"].step.dtype == np.int32
    for (pa, a), (pb, b) in zip(leaves_with_path(got), leaves_with_path(port)):
        assert pa == pb and isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b.numpy())
    placed = restore_resharded(got, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(placed), leaves(port)))
    devs = restore_resharded(got, jax.tree.map(lambda _: "cpu", tree))
    assert all(x.device.type == "cpu" for x in leaves(devs))
    mgr.save_async(4, port, extra={"data_step": 4})
    mgr.wait()
    assert mgr.restore(port)[2] == 4
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(port)


def test_checkpoint_corruption_falls_back_and_shape_mismatch_raises(tmp_path, capsys):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(2)}
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree)
    mgr.save(2, {"w": tree["w"] * 2, "b": tree["b"]})
    # corrupt the newest: flip its manifest's CRC
    path = os.path.join(str(tmp_path), "step_0000000002", "manifest.json")
    man = json.load(open(path))
    man["leaves"][0]["crc32"] ^= 1
    json.dump(man, open(path, "w"))
    got, _, step = mgr.restore(tree)
    assert step == 1 and "falling back" in capsys.readouterr().out
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        mgr.restore({"w": torch.zeros(4, 3), "b": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(3, 4), "c": torch.ones(2)})  # missing leaf


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_the_packages(tmp_path, writer):
    tree = _opt_tree(7)
    port = {"params": params_from_numpy(jax.tree.map(np.asarray, tree["params"]), "cpu"),
            "opt": opt_state_from_reference(jax.tree.map(np.asarray, tree["opt"]), "cpu")}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    RManager(a).save(3, tree, extra={"data_step": 3})
    CheckpointManager(b).save(3, port, extra={"data_step": 3})
    ma, mb = (json.load(open(os.path.join(d, "step_0000000003", "manifest.json"))) for d in (a, b))
    assert ma == mb  # paths, keys, shapes, dtypes, CRCs, extra
    src = a if writer == "reference" else b
    got, extra, step = CheckpointManager(src).restore(port)
    rgot, rextra, rstep = RManager(src).restore(tree)
    assert step == rstep == 3 and extra == rextra == {"data_step": 3}
    for x, y in zip(leaves(got), jax.tree.leaves(rgot)):
        np.testing.assert_array_equal(x, np.asarray(y))
        assert x.dtype == np.asarray(y).dtype


# ------------------------------------------------ training loop


def test_train_learns_and_restarts_bitwise(tmp_path):
    cfg = smoke_config("internlm2-1.8b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1, noise=0.05)
    ocfg = optim.AdamWConfig(peak_lr=2e-3, warmup_steps=3, total_steps=40)

    def loop(d, fail_at=None, steps=8):
        return TrainLoopConfig(steps=steps, checkpoint_every=3, checkpoint_dir=str(d),
                               fail_at_step=fail_at)

    straight = train(cfg, dcfg, ocfg, loop(tmp_path / "a"), device="cpu")
    losses = [m["loss"] for m in straight["log"]]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [3, 6, 8]
    with pytest.raises(SimulatedPreemption):
        train(cfg, dcfg, ocfg, loop(tmp_path / "b", fail_at=5), device="cpu")
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [3]
    resumed = train(cfg, dcfg, ocfg, loop(tmp_path / "b"), device="cpu")
    assert [m["step"] for m in resumed["log"]] == list(range(3, 8))
    assert [m["loss"] for m in resumed["log"]] == losses[3:]
    for a, b in zip(leaves(straight["params"]), leaves(resumed["params"])):
        assert torch.equal(a, b)
    assert int(resumed["opt_state"].step) == 8
    # the same seed gives the same initial weights
    again = train(cfg, dcfg, ocfg, TrainLoopConfig(steps=1), device="cpu")
    assert again["log"][0]["loss"] == losses[0]


# ------------------------------------------------ compressed_psum over a process group

_GROUP_SCRIPT = '''
import socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, {src!r})
from repro_torch import optim


def grads(rank):
    rng = np.random.default_rng(rank)
    return (rng.standard_normal(1000) * rng.lognormal(0, 2, 1000)).astype(np.float32)


def run(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", world_size=2,
                            rank=rank)
    g = torch.from_numpy(grads(rank))
    res = {{}}
    for mode in ("none", "bf16", "int8_ef"):
        s, e = optim.compressed_psum(g, torch.zeros(1000), optim.CompressionConfig(mode, 64),
                                     group=dist.group.WORLD)
        res[mode] = (s.numpy(), e.numpy())
    np.save(f"{{out}}/rank{{rank}}.npy", np.array([res], dtype=object), allow_pickle=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    mp.spawn(run, args=(port, sys.argv[1]), nprocs=2)
'''


def test_compressed_psum_over_a_gloo_group(tmp_path):
    """Two processes in one gloo group: every mode returns the same sum on
    both ranks; int8_ef's shared scales are the MAX of the ranks' block
    maxima, its sum the int16 sum of both ranks' codes times them, and each
    rank keeps its own error buffer."""
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "group.py"
    script.write_text(_GROUP_SCRIPT.format(src=str(Path(__file__).resolve().parents[1] / "src")))
    subprocess.run([sys.executable, str(script), str(tmp_path)], check=True, timeout=240,
                   capture_output=True)
    res = [np.load(tmp_path / f"rank{r}.npy", allow_pickle=True)[0] for r in range(2)]
    g = []
    for r in range(2):
        rng = np.random.default_rng(r)
        g.append((rng.standard_normal(1000) * rng.lognormal(0, 2, 1000)).astype(np.float32))
    for mode in ("none", "bf16", "int8_ef"):
        np.testing.assert_array_equal(res[0][mode][0], res[1][mode][0])
    np.testing.assert_array_equal(res[0]["none"][0], g[0] + g[1])
    np.testing.assert_array_equal(
        res[0]["bf16"][0], (torch.from_numpy(g[0]).bfloat16() + torch.from_numpy(g[1]).bfloat16())
        .float().numpy())
    pad = np.pad(np.stack(g), ((0, 0), (0, 24))).reshape(2, -1, 64)
    scale = np.maximum(np.abs(pad).max(axis=(0, 2)) * np.float32(1 / 127), np.float32(1e-12))
    q = np.clip(np.round(pad / scale[:, None]), -127, 127)
    want = (q.sum(0) * scale[:, None]).reshape(-1)[:1000].astype(np.float32)
    np.testing.assert_array_equal(res[0]["int8_ef"][0], want)
    for r in range(2):
        assert np.abs(res[r]["int8_ef"][1]).max() <= scale.max() / 2 + 1e-6
