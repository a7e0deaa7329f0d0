"""Fault-tolerant training loop.

Counterpart of ``repro.train.loop``:
  * restore-from-latest on start (params, optimizer, data-pipeline step);
  * periodic atomic checkpoints with integrity CRCs;
  * deterministic data sharding (restart/straggler safe);
  * optional simulated preemption (``fail_at_step``) used to prove restart
    equivalence;
  * metrics log returned to the caller (and printed).

It runs eagerly on ``device`` (``cuda`` unless named), with no
``torch.compile``; the train step updates the params and optimizer state
in place, as the reference donates them to its jitted step.  Initial
weights come from a ``torch.Generator`` seeded with ``loop.seed``, so they
differ from the JAX RNG's: restart equivalence is held within the port,
and parity with the reference goes through carried weights.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import CheckpointManager, restore_resharded
from ..data import DataConfig, SyntheticLMDataset
from ..kernels.backend import resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from ..optim import init as opt_init
from .step import make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 20
    checkpoint_every: int = 10
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    microbatches: int = 1
    log_every: int = 1
    seed: int = 0
    fail_at_step: Optional[int] = None  # simulated preemption (tests)


class SimulatedPreemption(RuntimeError):
    pass


def train(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    opt_cfg: AdamWConfig,
    loop: TrainLoopConfig,
    batch_transform: Optional[Callable[[dict], dict]] = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run (or resume) a training job on ``device``.  Returns final state +
    metrics log."""
    dev = resolve_device(device)
    dataset = SyntheticLMDataset(data_cfg)
    step_fn = make_train_step(cfg, opt_cfg, loop.microbatches, donate=True)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(loop.seed), dev)
    opt_state = opt_init(params)
    start_step = 0

    manager = None
    if loop.checkpoint_dir:
        manager = CheckpointManager(loop.checkpoint_dir, keep=loop.keep_checkpoints)
        if manager.latest_step() is not None:
            tree = {"params": params, "opt": opt_state}
            restored, extra, ck_step = manager.restore(tree)
            restored = restore_resharded(restored, dev)
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(extra.get("data_step", ck_step))
            print(f"resumed from checkpoint step {ck_step}")

    log: list[dict[str, float]] = []
    for step in range(start_step, loop.steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise SimulatedPreemption(f"simulated preemption at step {step}")
        t0 = time.monotonic()
        batch = dataset.global_batch(step)
        if batch_transform is not None:
            batch = batch_transform(batch)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % loop.log_every == 0 or step == loop.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["sec"] = time.monotonic() - t0
            log.append(m)
            print(
                f"step {step:5d} loss {m['loss']:.4f} "
                f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} {m['sec']:.2f}s"
            )
        if manager and ((step + 1) % loop.checkpoint_every == 0 or step == loop.steps - 1):
            manager.save(
                step + 1,
                {"params": params, "opt": opt_state},
                extra={"data_step": step + 1},
            )
    return {"params": params, "opt_state": opt_state, "log": log}
