"""Registered TX-pipeline stages (paper §III/§IV; DESIGN.md §3.2).

Counterpart of ``repro.link.stages``: the pluggable KEY (sort-key
derivation), ENCODE (byte recoding) and PACK (flit layout) stages, plus
the legacy strategy API (``make_order`` / ``order_packets`` /
``ORDER_STRATEGIES``) on top of the registries.  Every ordering is the
paper's stable counting sort over "keys + bucket count".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch

from ..core.coding import gray_encode_bytes
from ..core.popcount import bucket_map, popcount
from ..core.sorting import counting_sort_indices

__all__ = [
    "KeyStage",
    "PackStage",
    "KEY_STAGES",
    "ENCODE_STAGES",
    "PACK_STAGES",
    "lookup_stage",
    "make_order",
    "order_packets",
    "ORDER_STRATEGIES",
    "to_sign_magnitude",
    "to_gray",
    "tensor_flit_stream",
    "row_bucket_keys",
    "row_bucket_order",
]


def lookup_stage(kind: str, name: str, registry: Mapping[str, object]):
    """Registry lookup; an unknown name lists every registered one."""
    if name not in registry:
        raise ValueError(
            f"unknown {kind} stage {name!r}; registered {kind} stages: "
            f"{', '.join(sorted(registry))}"
        )
    return registry[name]


# --------------------------------------------------------------------------
# encode stages


def to_sign_magnitude(q_int8: torch.Tensor) -> torch.Tensor:
    """Recode two's-complement int8 as sign-magnitude bytes (uint8)."""
    q = q_int8.to(torch.int16)
    sign = (q < 0).to(torch.uint8) << 7
    return sign | q.abs().to(torch.uint8)


def to_gray(values: torch.Tensor) -> torch.Tensor:
    """Recode bytes as reflected-binary Gray code (uint8)."""
    return gray_encode_bytes(values.to(torch.uint8))


ENCODE_STAGES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda v: v,
    "sign_magnitude": to_sign_magnitude,
    "gray": to_gray,
}


# --------------------------------------------------------------------------
# key stages


@dataclasses.dataclass(frozen=True)
class KeyStage:
    """Sort-key derivation: fn(values, *, lanes, width, k) -> (keys, buckets).

    ``data_independent`` stages fix the permutation from the framing alone.
    """

    name: str
    fn: Callable[..., tuple[torch.Tensor, int]]
    data_independent: bool = False


def _key_none(values: torch.Tensor, **_: object) -> tuple[torch.Tensor, int]:
    n = values.shape[-1]
    keys = torch.arange(n, dtype=torch.int32, device=values.device).expand(values.shape)
    return keys, n


def _key_column_major(
    values: torch.Tensor, *, lanes: int = 8, **_: object
) -> tuple[torch.Tensor, int]:
    """Keys = transmit rank of the column-major re-traversal of the packet's
    (flits, lanes) matrix: element (f, l) is visited in order l*F + f."""
    n = values.shape[-1]
    if n % lanes != 0:
        raise ValueError(f"packet size {n} not divisible by lanes {lanes}")
    flits = n // lanes
    i = torch.arange(n, dtype=torch.int32, device=values.device)
    return ((i % lanes) * flits + i // lanes).expand(values.shape), n


def _key_acc(values: torch.Tensor, *, width: int = 8, **_: object):
    return popcount(values, width), width + 1


def _key_app(values: torch.Tensor, *, width: int = 8, k: int = 4, **_: object):
    return bucket_map(popcount(values, width), width, k), k


def row_bucket_keys(rows: torch.Tensor, levels: int, *, width: int = 8) -> torch.Tensor:
    """Bucket key per row of an (R, B) byte matrix: the row's total
    '1'-bit count mapped uniformly onto ``levels`` buckets."""
    bits = popcount(rows.to(torch.uint8), width).sum(dim=-1, dtype=torch.int32)
    max_bits = width * rows.shape[-1]
    return torch.div(bits * levels, max_bits + 1, rounding_mode="floor")


def _key_row_bucket(values: torch.Tensor, *, width: int = 8, k: int = 4, **_: object):
    return row_bucket_keys(values, k, width=width), k


KEY_STAGES: Dict[str, KeyStage] = {
    "none": KeyStage("none", _key_none, data_independent=True),
    "column_major": KeyStage("column_major", _key_column_major, data_independent=True),
    "acc": KeyStage("acc", _key_acc),
    "app": KeyStage("app", _key_app),
    "row_bucket": KeyStage("row_bucket", _key_row_bucket),
}


def row_bucket_order(
    rows: torch.Tensor, levels: int, *, width: int = 8, descending: bool = False
) -> torch.Tensor:
    """Stable comparison-free sort order of rows by popcount bucket."""
    keys = row_bucket_keys(rows, levels, width=width)
    if descending:
        keys = (levels - 1) - keys
    return counting_sort_indices(keys, levels)


# --------------------------------------------------------------------------
# pack stages


def tensor_flit_stream(mat: torch.Tensor, lanes: int = 16) -> torch.Tensor:
    """A byte matrix as a (T, lanes) flit stream (row-major flatten,
    trimmed to whole flits)."""
    flat = mat.reshape(-1)
    usable = (flat.shape[0] // lanes) * lanes
    return flat[:usable].reshape(-1, lanes)


def _per_packet_row(values: torch.Tensor, lanes: int) -> torch.Tensor:
    p, n = values.shape
    if n % lanes != 0:
        raise ValueError(f"payload size {n} not divisible by lanes {lanes}")
    return values.reshape(p, n // lanes, lanes)


def _per_packet_lane(values: torch.Tensor, lanes: int) -> torch.Tensor:
    p, n = values.shape
    if n % lanes != 0:
        raise ValueError(f"payload size {n} not divisible by lanes {lanes}")
    return values.reshape(p, lanes, n // lanes).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class PackStage:
    """Flit layout: ``per_packet`` shapes (P, N) payloads into (P, F, lanes)
    flit halves (None for stream-only layouts); ``stream`` lays a whole byte
    matrix out as (T, lanes) flit rows."""

    name: str
    per_packet: Optional[Callable[[torch.Tensor, int], torch.Tensor]]
    stream: Callable[[torch.Tensor, int], torch.Tensor]


PACK_STAGES: Dict[str, PackStage] = {
    "row": PackStage("row", _per_packet_row, tensor_flit_stream),
    "lane": PackStage(
        "lane",
        _per_packet_lane,
        lambda m, lanes: _per_packet_lane(m, lanes).reshape(-1, lanes),
    ),
    "col": PackStage("col", None, lambda m, lanes: tensor_flit_stream(m.T, lanes)),
}


# --------------------------------------------------------------------------
# legacy strategy API (paper §IV, Table I)


def make_order(
    strategy: str,
    values: torch.Tensor,
    *,
    lanes: int = 8,
    width: int = 8,
    k: int = 4,
    descending: bool = False,
    **_: object,
) -> torch.Tensor:
    """Per-packet element order (int32 (..., N)) for a packet-granularity
    ``KEY_STAGES`` strategy; gather with it to reorder."""
    stage = KEY_STAGES.get(strategy)
    if stage is None or strategy == "row_bucket":
        choices = sorted(set(KEY_STAGES) - {"row_bucket"})
        raise ValueError(f"unknown ordering strategy {strategy!r}; choose from {choices}")
    n = values.shape[-1]
    if stage.data_independent:
        # one fixed permutation broadcast over the batch ('descending' is a
        # sort-stage knob the layout stages ignore, as in the reference)
        if strategy == "none":
            order = torch.arange(n, dtype=torch.int32, device=values.device)
        else:
            keys, nb = stage.fn(
                torch.zeros((n,), dtype=torch.int32, device=values.device),
                lanes=lanes, width=width, k=k,
            )
            order = counting_sort_indices(keys, nb)
        return order.expand(values.shape)
    keys, nb = stage.fn(values, lanes=lanes, width=width, k=k)
    if descending:
        keys = (nb - 1) - keys
    return counting_sort_indices(keys, nb)


def order_packets(
    strategy: str,
    inputs: torch.Tensor,
    weights: torch.Tensor | None = None,
    **kwargs: object,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Reorder (P, N) packets (and their paired weights) with one strategy."""
    order = make_order(strategy, inputs, **kwargs).to(torch.int64)
    out_w = torch.gather(weights, -1, order) if weights is not None else None
    return torch.gather(inputs, -1, order), out_w


def _legacy_strategy(name: str) -> Callable[..., torch.Tensor]:
    def fn(values: torch.Tensor, **kwargs: object) -> torch.Tensor:
        return make_order(name, values, **kwargs)

    fn.__name__ = f"order_{name}"
    return fn


ORDER_STRATEGIES: Dict[str, Callable[..., torch.Tensor]] = {
    name: _legacy_strategy(name) for name in ("none", "column_major", "acc", "app")
}
