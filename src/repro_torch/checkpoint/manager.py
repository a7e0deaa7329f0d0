"""Fault-tolerant checkpointing.

Counterpart of ``repro.checkpoint.manager``, in its file format:

  * **Atomicity** — checkpoints are written to a temp dir and ``os.rename``d
    into place; a crash mid-write never corrupts the latest checkpoint.
  * **Integrity** — every array carries a CRC32 of its bytes in the
    manifest, verified on restore; a corrupt checkpoint is skipped and the
    previous one is used.
  * **Elasticity** — arrays are stored on the host (numpy, ``np.savez``);
    ``restore`` returns host arrays and ``restore_resharded`` places them
    onto a device, or onto a tree of devices, other than the one that saved.
  * **Pipeline state** — the data-pipeline step and arbitrary JSON metadata
    ride in the manifest, so restarts are bit-exact end to end.

The manifest keys each leaf by its ``jax.tree_util.keystr`` path
(``['params']['embed']``, ``['opt'].m['embed']``; ``repro_torch._tree``),
and leaves are numbered in the reference's leaf order, so a checkpoint
written by either package restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .._tree import leaves_with_path, tree_map


def _to_numpy(x) -> np.ndarray:
    """A leaf as a host numpy array (a bfloat16 tensor as ``ml_dtypes``'
    bfloat16, the reference's host type)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only a bfloat16 leaf needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _flatten(tree: Any) -> list[tuple[str, np.ndarray]]:
    return [(p, _to_numpy(v)) for p, v in leaves_with_path(tree)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        """Straggler-friendly save: snapshot to host memory synchronously
        (device buffers must not mutate underneath), then write + rename on
        a background thread so the training loop never blocks on disk.  At
        most one async save in flight; a second call joins the first."""
        snapshot = tree_map(lambda x: _to_numpy(x).copy(), tree)
        self.wait()
        self._async_thread = threading.Thread(
            target=self.save, args=(step, snapshot, extra), daemon=True
        )
        self._async_thread.start()

    def wait(self) -> None:
        """Block until any in-flight async save has been published."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = _flatten(tree)
        arrays = {f"a{i}": arr for i, (_, arr) in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": [
                {
                    "path": p,
                    "key": f"a{i}",
                    "shape": list(a.shape),
                    "dtype": str(a.dtype),
                    "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()),
                }
                for i, (p, a) in enumerate(leaves)
            ],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple[Any, dict, int]:
        """Restore into the structure of ``template`` (a tree of tensors or
        arrays; only its structure and shapes are read).

        Walks back through older checkpoints if the newest fails integrity.
        Returns (tree of host numpy arrays, extra, step).
        """
        candidates = self.all_steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        for s in reversed(candidates):
            try:
                return (*self._load(template, s), s)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                # corrupt / truncated / CRC-mismatch: fall back to older
                print(f"checkpoint step {s} failed integrity ({e}); falling back")
        raise FileNotFoundError(f"no valid checkpoint in {self.directory}")

    def _load(self, template: Any, step: int) -> tuple[Any, dict]:
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        by_path = {}
        for leaf in manifest["leaves"]:
            arr = data[leaf["key"]]
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != leaf["crc32"]:
                raise ValueError(f"crc mismatch at {leaf['path']}")
            by_path[leaf["path"]] = arr
        paths = iter(p for p, _ in leaves_with_path(template))

        def load(tmpl):
            key = next(paths)
            if key not in by_path:
                raise KeyError(f"missing leaf {key}")
            arr = by_path[key]
            want = tuple(np.shape(tmpl))
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {want}")
            return arr

        return tree_map(load, template), manifest["extra"]


def restore_resharded(tree_host: Any, devices: Any) -> Any:
    """Place a host-restored tree onto ``devices``: one device (or its
    name) for every leaf, or a tree of devices of the same structure — the
    elastic path: save on one device layout, restore onto another."""
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        return tree_map(lambda a: _to_tensor(a, dev), tree_host)
    return tree_map(lambda a, d: _to_tensor(a, torch.device(d)), tree_host, devices)
