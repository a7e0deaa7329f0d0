"""Build-at-first-use loader for the port's CUDA kernels.

Compiles every ``csrc/*.cu`` source of this package — and nothing else —
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface under ``<repo>/build/repro_torch/``, then loads it with
``ctypes``.  The library's name carries the hash of every source and
header, so any change to one rebuilds it.  The sources compile at once,
one ``nvcc`` each, into a temporary directory, and are linked there
before the library is moved into place.  A missing or failing ``nvcc``
raises with the compiler's output; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "DTYPE_CODES", "build", "library", "check", "timed_build"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# element types the kernels take, as the C entry points' `dtype` argument
DTYPE_CODES = {torch.uint8: 0, torch.int32: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the C entry points and their argument types (see csrc/*.cu)
SIGNATURES = {
    "repro_bt_count": [_P, _I, _L, _L, _L, _I, _P, _P],
    "repro_psu_sort": [_P, _I, _L, _I, _I, _I, _I, _P, _P, _P],
    "repro_psu_stream": [_P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "repro_bt_axes": [
        _P, _P, _I, _L, _L, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ],
    "repro_bt_axes_activity": [
        _P, _P, _I, _L, _L, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _L, _I, _I, _P, _P, _P,
    ],
    "repro_quantize_egress": [_P, _L, _L, _I, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH and not under $CUDA_HOME/bin): the "
        "repro_torch CUDA kernels cannot be built"
    )


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the output of any that fail."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(c, log) for c, p, log in zip(cmds, procs, logs) if p.returncode != 0]
    if failed:
        msg = "\n\n".join(f"$ {' '.join(c)}\n{log}" for c, log in failed)
        raise RuntimeError(f"nvcc failed building the repro_torch kernels:\n{msg}")
    return logs


def build() -> tuple[Path, str]:
    """Compile (if needed) and return (library path, compiler log).

    The log is empty when everything was already built for these sources.
    """
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_torch_{_digest(sources + headers)}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        logs = _run([  # one nvcc per source, all started together
            [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objs)
        ])
        tmp_lib = Path(tmp) / lib.name
        logs += _run([[nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)]])
        os.replace(tmp_lib, lib)
    log = "\n".join(x for x in logs if x.strip())
    (BUILD_DIR / "build.log").write_text(log)
    return lib, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        what = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {err} ({what})")


def timed_build() -> tuple[float, str]:
    """Build from scratch-or-cache and load; (seconds, compiler log)."""
    t0 = time.perf_counter()
    _, log = build()
    library()
    return time.perf_counter() - t0, log
