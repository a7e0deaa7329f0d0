"""What the port's multi-process test files share, in torch and numpy only.

A gloo group's ranks import this module and the test module that started
them, so neither may load ``jax`` or the JAX package (``repro``): that
would cost every rank seconds of start-up for nothing.  ``join`` and
``leave`` assert it on each rank, and ``tests/test_torch_imports.py``
holds every rank's imports to it.

* :func:`ranks` starts a gloo group's ranks (one torch thread each) and
  :func:`reference` a reference process (with forced host devices);
  :func:`wait` waits for a whole set of them against one wall-clock
  deadline and fails with the output of each that failed or had not
  exited; :func:`run_ranks` is both for one group.
* :func:`shared` computes a one-process result once per arguments in this
  process and hands out read-only arrays, so that one test cannot change
  what another reads; :func:`tensors` copies such arrays into tensors.
* :func:`torch_threads`, imported by a port test file, sizes torch's
  intra-op pool to this process's share of the cores while the file runs.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 240  # seconds for every process a fixture starts, together
WORKERS = 6  # the processes that share the cores (the suite's ``-n 6``)
PYTHONPATH = os.pathsep.join([str(ROOT / "src"), str(ROOT), str(ROOT / "tests")])


def assert_no_reference() -> None:
    """Neither JAX nor the JAX package (``repro``) is loaded here."""
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, f"a gloo rank loaded the reference: {loaded[:5]}"


def join(argv: list[str]) -> tuple[int, int, str]:
    """A rank's start: (rank, world, its directory) from ``argv``, one torch
    thread, no JAX loaded, then the gloo group of the ``file://`` store in
    that directory."""
    import torch.distributed as dist

    rank, world, out = int(argv[1]), int(argv[2]), argv[3]
    assert_no_reference()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store", rank=rank,
                            world_size=world)
    return rank, world, out


def leave(path: str, results: dict) -> None:
    """A rank's end: its results written to ``path`` whole (a reader never
    sees part of the file), still no JAX loaded, the group left."""
    import torch.distributed as dist

    assert_no_reference()
    partial = path + ".partial.npz"
    np.savez(partial, **results)
    os.replace(partial, path)
    dist.destroy_process_group()


def _spawn(script: Path, args: list, log: Path, devices: int | None = None) -> subprocess.Popen:
    """Start ``script`` with ``args``, its output to ``log``.  Without
    ``devices`` it is a gloo rank on one torch thread; with it, a reference
    process whose XLA has that many host devices."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", PYTHONPATH=PYTHONPATH)
    if devices is not None:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(script), *map(str, args)], stdout=f,
                                stderr=subprocess.STDOUT, env=env)
    proc.log = log
    return proc


def ranks(tmp: Path, script: str, world: int) -> list:
    """``script`` (dedented into ``tmp``) started as the ``world`` ranks of
    a gloo group (argv: rank, world, ``tmp``)."""
    path = tmp / "worker.py"
    path.write_text(textwrap.dedent(script))
    return [_spawn(path, [r, world, tmp], tmp / f"rank{r}.log") for r in range(world)]


def reference(tmp: Path, script: str, devices: int, *args) -> subprocess.Popen:
    """``script`` (dedented into ``tmp``) started as a reference process on
    ``devices`` host devices (argv: ``tmp``, then ``args``)."""
    path = tmp / "reference.py"
    path.write_text(textwrap.dedent(script))
    return _spawn(path, [tmp, *args], tmp / "reference.log", devices)


def wait(procs: list, deadline: float | None = None) -> None:
    """Wait for every process in ``procs`` against one deadline
    (``time.monotonic()``; ``DEADLINE`` seconds from now if None).  When one
    fails, the rest cannot finish their collectives, so no more waiting.
    Then every process is killed, and the test fails with the output of each
    that failed or had not exited."""
    end = time.monotonic() + DEADLINE if deadline is None else deadline
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes) or any(codes):
            late = "was still running when another failed"
            break
        if time.monotonic() >= end:
            late = f"had not exited by the deadline ({DEADLINE} s)"
            break
        time.sleep(0.05)
    running = [p for p in procs if p.poll() is None]
    for p in procs:
        p.kill()
        p.wait()
    bad = [(p, f"exited with {p.returncode}") for p in procs
           if p not in running and p.returncode] + [(p, late) for p in running]
    assert not bad, "\n".join(f"{p.log} {why}:\n{p.log.read_text()[-3000:]}" for p, why in bad)


def run_ranks(tmp: Path, script: str, world: int) -> None:
    """``script`` run as a ``world``-rank gloo group, waited for."""
    wait(ranks(tmp, script, world))


def load(tmp: Path, world: int, name: str = "rank") -> list:
    """The ranks' results, in rank order (``leave``'s files)."""
    return [dict(np.load(tmp / f"{name}{r}.npz")) for r in range(world)]


def _freeze(x):
    if isinstance(x, np.ndarray):
        x.setflags(write=False)
    elif isinstance(x, dict):
        for k, v in x.items():
            x[k] = _freeze(v)
    elif isinstance(x, (list, tuple)):
        x = tuple(_freeze(v) for v in x)
    return x


def shared(fn):
    """``fn`` computed once per arguments (keyed on their ``repr``) in this
    process; lists in its result become tuples and its arrays read-only."""
    cache = {}

    @functools.wraps(fn)
    def call(*args):
        key = repr(args)
        if key not in cache:
            cache[key] = _freeze(fn(*args))
        return cache[key]

    return call


def tensors(arrays: dict, rows=slice(None)) -> dict:
    """Tensors copied from ``arrays``' ``rows`` (a tensor made by
    ``torch.from_numpy`` would write into a shared, read-only array)."""
    return {k: torch.tensor(v[rows]) for k, v in arrays.items()}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """torch's intra-op threads set to this process's share of the cores
    while the module that imports this fixture runs, then put back: each of
    the suite's workers would otherwise start a pool as wide as the machine
    beside five others and the ranks' processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
    yield
    torch.set_num_threads(before)
