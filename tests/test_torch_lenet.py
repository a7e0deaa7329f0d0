"""repro_torch.models.lenet and capture_lenet_conv against the reference on
the CPU, and both packages held to phase 3g's LeNet pins.

Carried weights (``convert.lenet_params_from_reference``: the reference's
HWIO tree) and the same images go through both packages: logits within
``LOGIT_TOL`` of the largest, one SGD step's loss, gradients and params
within ``SGD_TOL`` of each leaf's largest magnitude (a zero-initialised
bias moves by lr x its gradient, so it carries the gradient's rounding),
captured conv / input bytes equal.  A ``train_lenet`` checkpoint written by
the reference restores in the port with equal params, and ``.npz``
sessions written by either package's ``save_session`` replay in both.
``reference_lenet()`` trains the reference's LeNet (300 steps, batch 64)
and captures it: its params, images and bytes are
``tests/data/lenet_ref.npz``, and ``benchmarks/model_traffic.py``'s
lenet_conv measurements of those bytes, in both packages, are
``chip_smoke.LENET``'s pins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.table1_bt import _measure_separate
from chip_smoke import (
    LENET,
    LENET_REF,
    SERVE_POINTS,
    evals_digest,
    lenet_patches,
    lenet_reference,
    lenet_rows,
    links_digest,
)
from repro import obs as robs
from repro.dse import DesignPoint, evaluate_grid
from repro.link import LinkSpec
from repro.models import lenet as rlenet
from repro.noc import conv_platform_flows, mesh, simulate_noc
from repro_torch import obs as tobs
from repro_torch._tree import leaves
from repro_torch.convert import lenet_params_from_reference
from repro_torch.models import lenet
from torch_groups import torch_threads  # noqa: F401

CPU = torch.device("cpu")
LOGIT_TOL = 1e-5
SGD_TOL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    return float(np.abs(a - np.asarray(b, np.float64)).max() / max(np.abs(a).max(), 1e-30))


def _carried(seed=0):
    params = rlenet.init_lenet(jax.random.key(seed))
    return params, lenet_params_from_reference(jax.tree.map(np.asarray, params), CPU)


def test_shapes_layouts_and_forward_match():
    params, tparams = _carried()
    assert [tuple(x.shape) for x in leaves(tparams)] == [
        x.shape for x in jax.tree.leaves(params)]
    assert tuple(tparams["conv1"]["w"].shape) == (5, 5, 1, 6)  # HWIO, as the reference
    images, _ = rlenet.synth_batch(jax.random.key(1), batch=16)
    want = rlenet.lenet_forward(params, images)
    got = lenet.lenet_forward(tparams, torch.from_numpy(np.array(images)))
    assert got.shape == (16, lenet.NUM_CLASSES) and _rel(want, got) < LOGIT_TOL
    with pytest.raises(ValueError, match="do not fit"):
        bad = jax.tree.map(np.asarray, params)
        bad["conv1"]["w"] = bad["conv1"]["w"].transpose(3, 2, 0, 1)  # OIHW
        lenet_params_from_reference(bad, CPU)
    np.testing.assert_array_equal(lenet._templates(0), rlenet._templates(0))


def test_one_sgd_step_matches():
    params, tparams = _carried(2)
    images, labels = rlenet.synth_batch(jax.random.key(3), batch=32)
    lr, mom, wd = 0.05, 0.9, 1e-3
    loss, grads = jax.value_and_grad(rlenet._loss)(params, images, labels)
    vel = jax.tree.map(lambda g: g, grads)  # momentum * 0 + g
    want = jax.tree.map(lambda p, v: p - lr * (v + wd * p), params, vel)
    tvel = {k: {kk: torch.zeros_like(v) for kk, v in d.items()} for k, d in tparams.items()}
    tloss = lenet._sgd_step(tparams, tvel, torch.from_numpy(np.array(images)),
                            torch.from_numpy(np.array(labels)), lr, mom, wd)
    assert _rel(loss, tloss) < SGD_TOL
    for a, b in zip(jax.tree.leaves(want), leaves(tparams)):
        assert _rel(a, b) < SGD_TOL
    for a, b in zip(jax.tree.leaves(grads), leaves(tvel)):
        assert _rel(a, b) < SGD_TOL


def test_train_lenet_learns_checkpoints_and_restores_the_reference(tmp_path):
    params, info = lenet.train_lenet(steps=30, batch=32, ckpt_dir=str(tmp_path / "p"),
                                     device=CPU)
    assert info["restored"] is False and info["final_loss"] < 1.0
    back, info2 = lenet.train_lenet(steps=30, batch=32, ckpt_dir=str(tmp_path / "p"),
                                    device=CPU)
    assert info2 == {"restored": True, "steps": 30, "final_loss": info["final_loss"]}
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(back)))
    # a checkpoint the reference wrote, restored by the port (and the port's
    # by the reference)
    rparams, rinfo = rlenet.train_lenet(steps=20, batch=16, ckpt_dir=str(tmp_path / "r"))
    got, ginfo = lenet.train_lenet(ckpt_dir=str(tmp_path / "r"), device=CPU)
    assert ginfo["restored"] and ginfo["steps"] == 20
    assert abs(ginfo["final_loss"] - rinfo["final_loss"]) == 0
    for a, b in zip(jax.tree.leaves(rparams), leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rback, rinfo2 = rlenet.train_lenet(ckpt_dir=str(tmp_path / "p"))
    assert rinfo2["restored"]
    for a, b in zip(jax.tree.leaves(rback), leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_capture_bytes_equal_and_sessions_replay(tmp_path):
    params, tparams = _carried(4)
    images, _ = rlenet.synth_batch(jax.random.key(0), batch=8)
    rsess = robs.capture_lenet_conv(params=params)  # draws the same images
    tsess = tobs.capture_lenet_conv(params=tparams, images=torch.from_numpy(np.array(images)),
                                    device=CPU)
    assert [(s.scenario, s.name, s.kind, s.source_shape) for s in rsess.streams] == [
        (s.scenario, s.name, s.kind, s.source_shape) for s in tsess.streams]
    for a, b in zip(rsess.streams, tsess.streams):
        np.testing.assert_array_equal(a.data, b.data.numpy())
    # .npz sessions: each package's file replayed in both
    robs.save_session(str(tmp_path / "r.npz"), rsess)
    tobs.save_session(str(tmp_path / "t.npz"), tsess)
    for path in ("r.npz", "t.npz"):
        for back in (robs.load_session(str(tmp_path / path)),
                     tobs.load_session(str(tmp_path / path), device=CPU)):
            assert [s.name for s in back.streams] == ["conv1", "conv2", "inputs"]
            for a, b in zip(rsess.streams, back.streams):
                np.testing.assert_array_equal(a.data, np.asarray(
                    b.data.numpy() if isinstance(b.data, torch.Tensor) else b.data))
    # the port's own images are numpy draws: 8 task images, templates + noise
    own = tobs.capture_lenet_conv(params=tparams, device=CPU)
    assert own.get("lenet_conv", "inputs")[0].source_shape == (8, 32, 32, 1)


# ------------------------------------------------ phase 3g's LeNet pins


def reference_lenet() -> tuple[dict, dict]:
    """The reference's trained LeNet (train_lenet(300), batch 64) and its
    capture: (the arrays of LENET_REF, its final loss)."""
    params, info = rlenet.train_lenet(steps=LENET["steps"], batch=LENET["batch"])
    images, _ = rlenet.synth_batch(jax.random.key(0), batch=LENET["images"])
    sess = robs.capture_lenet_conv(params=params)
    arrays = {f"params/{k}/{kk}": np.asarray(v) for k, d in params.items()
              for kk, v in d.items()}
    arrays["images"] = np.asarray(images)
    arrays.update({f"bytes/{s.name}": s.data for s in sess.streams})
    return arrays, info


def reference_lenet_rows(want: dict) -> dict:
    """model_traffic.py's lenet_conv measurements through the JAX package on
    the pinned capture bytes ``want`` (stream name -> uint8)."""
    sess = robs.CaptureSession()
    shapes = {"conv1": (5, 5, 1, 6), "conv2": (5, 5, 6, 16), "inputs": (8, 32, 32, 1)}
    for name in ("conv1", "conv2", "inputs"):
        sess._add_bytes("lenet_conv", name, want[name], shapes[name], "lenet.conv", {})
    points = tuple(DesignPoint(**dataclasses.asdict(p)) for p in SERVE_POINTS)
    evals = evaluate_grid(points, sess.workload("lenet_conv", elems=64, lanes=16),
                          activity_windows=LENET["window"])
    m44 = mesh(4, 4)
    flows = conv_platform_flows(jnp.asarray(lenet_patches()),
                                jnp.asarray(sess.scenario_bytes("lenet_conv", ["conv1"])), m44, 0,
                                list(LENET["noc_pes"]), LinkSpec())
    reps = [simulate_noc(m44, flows, dataclasses.replace(LinkSpec(), key=k), sort_at="source")
            for k in ("none", "acc")]
    inp = np.asarray(sess.packets("lenet_conv", 64, names=["inputs"]))
    wgt = np.asarray(sess.packets("lenet_conv", 64, names=["conv1", "conv2"]))
    bt = {k: [_measure_separate(x, k) for x in (inp, wgt)] for k in ("none", "acc", "app")}
    base = sum(bt["none"])
    return {"grid": {e.label: [e.total_bt, e.aux_bt] for e in evals},
            "activity_sha256": evals_digest(evals),
            "noc": [reps[0].total_bt, reps[1].total_bt, links_digest(reps[1])],
            "recalib": {"bt_per_flit": bt,
                        "captured_red": {k: 100 * (1 - sum(bt[k]) / base) for k in ("acc", "app")}}}


def test_reference_lenet_reproduces_the_pinned_weights():
    arrays, info = reference_lenet()
    ref = np.load(LENET_REF)
    assert sorted(arrays) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(arrays[k], ref[k])
    assert info["final_loss"] == LENET["pins"]["final_loss"]
    assert LENET["loss_bound"] > info["final_loss"]


def test_both_packages_hold_phase_3g_lenet_pins():
    pin = LENET["pins"]
    params, images, want = lenet_reference(CPU)
    assert reference_lenet_rows(want) == {k: pin[k] for k in ("grid", "activity_sha256", "noc",
                                                               "recalib")}
    sess = tobs.capture_lenet_conv(params=params, images=images, device=CPU)
    for s in sess.streams:
        np.testing.assert_array_equal(s.data.numpy(), want[s.name])
    assert lenet_rows(sess) == {k: pin[k] for k in ("grid", "activity_sha256", "noc", "recalib")}
