"""Architecture registry: the 10 assigned configs + reduced smoke variants.

A copy of ``repro.configs`` (pure data, held equal to it by
``tests/test_torch_configs.py``).  ``get_config(name)`` returns the exact
assigned configuration; ``smoke_config(name)`` returns the same *family*
at toy scale (few layers, narrow width, tiny vocab/experts) for CPU smoke
tests.  The port has no models yet: a full config sizes the gradient of
``chip_smoke.py``'s egress path (``param_count()``).
"""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

from .shapes import SHAPES, ShapeSpec, shapes_for_family  # noqa: F401

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "gemma-7b": "gemma_7b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-4b": "qwen3_4b",
    "whisper-medium": "whisper_medium",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "internvl2-26b": "internvl2_26b",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides).validate()
    return cfg


def smoke_config(name: str, **overrides) -> ModelConfig:
    mod = _module(name)
    fields = dict(mod.SMOKE)
    fields.setdefault("attn_impl", "dense")
    fields.update(overrides)
    return dataclasses.replace(mod.CONFIG, **fields).validate()


def arch_shapes(name: str) -> list[str]:
    return shapes_for_family(get_config(name).family)


def all_cells() -> list[tuple[str, str]]:
    """Every assigned (arch, shape) pair — 40 nominal, minus documented
    long_500k skips for pure full-attention archs."""
    cells = []
    for arch in ARCH_NAMES:
        for shape in arch_shapes(arch):
            cells.append((arch, shape))
    return cells
