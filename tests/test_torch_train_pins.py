"""Both packages held to phase 3g's training pins in ``chip_smoke.py``.

``reference_train(arch)`` runs one eager train step of the JAX package
under capture on ``chip_smoke.train_inputs(arch)`` (numpy weights and
batch from the seed) and measures the captured gradient stream as
``benchmarks/model_traffic.py`` does; its values must equal ``TRAIN``'s
pins (loss and ``grad_norm`` within ``TRAIN['rel_tol']``) and its bytes
``tests/data/train_grad_pins.npz``.  The port's ``chip_smoke.train_smoke``
on the CPU must meet the same pins, its gradient bytes within one int8
code of the reference's on at most 1 % of the bytes, and its measurements
of the reference's bytes equal to the pinned totals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    SERVE_POINTS,
    TRAIN,
    TRAIN_ARCHS,
    TRAIN_GRAD_PINS,
    evals_digest,
    kv_differ,
    links_digest,
    pinned_grads_session,
    train_inputs,
    train_rows,
    train_smoke,
)
from repro import obs as robs
from repro.configs import smoke_config
from repro.dse import DesignPoint, evaluate_grid
from repro.link import LinkSpec
from repro.noc import ring, ring_allreduce_flows, simulate_noc
from repro.optim import AdamWConfig
from repro.optim import init as opt_init
from repro.train import make_train_step
from torch_groups import torch_threads  # noqa: F401

CPU = torch.device("cpu")


def reference_train(arch: str) -> tuple[dict, np.ndarray]:
    """Phase 3g (i) through the JAX package: one eager train step under
    capture on ``train_inputs(arch)``, then model_traffic.py's grid (with
    activity windows) and ring(8) fabric on the captured grads.  Returns
    the pinned values and the gradient bytes."""
    _, params_np, batch = train_inputs(arch)
    cfg = smoke_config(arch, dtype="float32")
    params = jax.tree.map(jnp.asarray, params_np)
    step = make_train_step(cfg, AdamWConfig(**TRAIN["opt"]))
    with robs.capture() as sess:
        _, _, metrics = step(params, opt_init(params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    (g,) = sess.get("train_allreduce", "grads")
    points = tuple(DesignPoint(**dataclasses.asdict(p)) for p in SERVE_POINTS)
    wl = sess.workload("train_allreduce", elems=TRAIN["elems"], lanes=TRAIN["lanes"])
    evals = evaluate_grid(points, wl, activity_windows=TRAIN["window"])
    reps = []
    for key in ("none", "acc"):
        spec = LinkSpec(width_bits=8 * TRAIN["lanes"],
                        flits_per_packet=TRAIN["elems"] // TRAIN["lanes"],
                        input_lanes=TRAIN["lanes"], weight_lanes=0, key=key, k=4)
        topo = ring(TRAIN["ring"])
        flows = ring_allreduce_flows(jnp.asarray(g.data.view(np.int8)), topo, spec=spec)
        reps.append(simulate_noc(topo, flows, spec, sort_at="source"))
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "names": [s.name for s in sess.streams], "grads_bytes": g.num_bytes,
           "grid": {e.label: [e.total_bt, e.aux_bt] for e in evals},
           "activity_sha256": evals_digest(evals),
           "ring": [reps[0].total_bt, reps[1].total_bt, links_digest(reps[1])]}
    return out, g.data


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_both_packages_hold_phase_3g_pins(arch):
    pin = TRAIN["pins"][arch]
    ref, ref_bytes = reference_train(arch)
    for k in ("loss", "grad_norm"):
        assert abs(ref[k] - pin[k]) <= TRAIN["rel_tol"] * abs(pin[k])
    assert {k: v for k, v in ref.items() if k not in ("loss", "grad_norm")} == {
        k: v for k, v in pin.items() if k not in ("loss", "grad_norm")}
    np.testing.assert_array_equal(ref_bytes, np.load(TRAIN_GRAD_PINS)[arch])

    sess, metrics = train_smoke(arch, CPU)
    for k in ("loss", "grad_norm"):
        assert abs(metrics[k] - pin[k]) <= TRAIN["rel_tol"] * abs(pin[k])
    (g,) = sess.get("train_allreduce", "grads")
    assert [s.name for s in sess.streams] == pin["names"] and g.num_bytes == pin["grads_bytes"]
    codes, share = kv_differ(g.data.numpy(), ref_bytes)
    assert codes <= TRAIN["grad_codes"] and share <= TRAIN["grad_share"], (codes, share)
    # the port's measurements of the reference's bytes equal the pins
    got = train_rows(pinned_grads_session(arch, CPU))
    assert got == {k: pin[k] for k in got}
