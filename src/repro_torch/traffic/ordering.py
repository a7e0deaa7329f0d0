"""Popcount ordering applied to model traffic (counterpart of
``repro.traffic.ordering``).

The model-side integration points — which tensors may be permuted, and
how, without changing results; the stream mechanics (encode, row-bucket
keys, flit layout, BT) are delegated to ``repro_torch.link``:

  1. **Contraction-axis weight permutation** (``apply_mlp_ordering``,
     ``apply_head_ordering``, ``apply_weight_ordering``): the d_ff rows of
     an MLP, and the KV-head groups of attention with their q-head blocks,
     reordered by the popcount bucket of their int8 bytes — a numeric
     no-op up to float summation order.  The reference ``jax.vmap``s over
     stacked layers; here a loop over the leading layer axis stacks the
     per-layer results, which gives the same exact integer permutations.
  2. **Gradient egress permutation** (``egress_permutation``): a static
     permutation of the int8 gradient wire image derived from the weight
     bytes, so it is the same on every replica.  The reference sorts on
     the host with numpy; the port sorts each packet with ``psu_sort``
     (the CUDA kernel on a CUDA tensor), because for 8-bit keys the
     reference's ``(popcount * levels) // 9`` is exactly the PSU's key.
  3. **BT accounting** (``stream_bt_report``): a tensor as a flit stream
     before and after popcount row ordering, through two
     ``TxPipeline.measure_rows`` runs.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .. import _obs_hooks as _obs
from ..kernels.backend import resolve_device
from ..kernels.ops import psu_sort
from ..kernels.psu import MAX_N
from ..link import LinkSpec, TxPipeline
from ..link import row_bucket_keys as _link_row_bucket_keys
from ..link import tensor_flit_stream, to_sign_magnitude  # noqa: F401  (re-export)
from ..models.config import ModelConfig

__all__ = [
    "int8_view",
    "row_bucket_keys",
    "row_order",
    "mlp_permutation",
    "apply_mlp_ordering",
    "head_permutation",
    "apply_head_ordering",
    "apply_weight_ordering",
    "egress_permutation",
    "BTStreamReport",
    "stream_bt_report",
    "tensor_flit_stream",
    "to_sign_magnitude",
]

Strategy = Literal["none", "acc", "app"]


def _row_levels(strategy: Strategy, k: int) -> int:
    """ACC keeps the element-granularity 9-level mapping; APP coarsens to k."""
    return 9 if strategy == "acc" else k


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """int8 bytes as uint8 without a copy (the reference's ``astype(uint8)``)."""
    return t.view(torch.uint8) if t.dtype == torch.int8 else t.to(torch.uint8)


# --------------------------------------------------------------------------
# int8 views and popcount keys


def int8_view(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantization of a weight tensor (the wire
    / HBM-stream image used for BT accounting and ordering keys): float32
    division by max|w| / 127 and round-half-to-even, as the reference."""
    with _obs.stage("traffic.stage", "int8_view"):
        x = w.to(torch.float32)
        scale = (x.abs().max() / 127.0).clamp_min(1e-12)
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def row_bucket_keys(rows_int8: torch.Tensor, strategy: Strategy, k: int = 4) -> torch.Tensor:
    """Bucket key per row of an (R, B) int8 matrix (see
    :func:`repro_torch.link.row_bucket_keys` for the mapping)."""
    return _link_row_bucket_keys(_bytes(rows_int8), _row_levels(strategy, k))


def row_order(rows_int8: torch.Tensor, strategy: Strategy, k: int = 4) -> torch.Tensor:
    """Stable comparison-free sort order (int32) of rows by popcount bucket."""
    if strategy == "none":
        return torch.arange(rows_int8.shape[0], dtype=torch.int32, device=rows_int8.device)
    pipe = TxPipeline(_row_spec(strategy, k, sign_magnitude=False, layout="row"),
                      device=rows_int8.device)
    return pipe.row_order(_bytes(rows_int8))


# --------------------------------------------------------------------------
# contraction-axis weight permutation (numeric no-op graph rewrites)


def mlp_permutation(mlp_params: dict, strategy: Strategy, k: int = 4) -> torch.Tensor:
    """d_ff permutation keyed on the down-projection rows (streamed axis)."""
    return row_order(int8_view(mlp_params["down"]), strategy, k)  # down: (ff, d)


def apply_mlp_ordering(mlp_params: dict, perm: torch.Tensor) -> dict:
    """Permute the d_ff axis: gate/up columns and down rows move together."""
    out = dict(mlp_params)
    idx = perm.to(torch.int64)
    if "gate" in out:
        out["gate"] = out["gate"].index_select(-1, idx)
    out["up"] = out["up"].index_select(-1, idx)
    out["down"] = out["down"].index_select(-2, idx)
    return out


def head_permutation(
    attn_params: dict, cfg: ModelConfig, strategy: Strategy, k: int = 4
) -> torch.Tensor:
    """KV-head-group permutation keyed on wk bytes (groups move atomically
    so the GQA head -> group mapping is preserved)."""
    wk = attn_params["wk"]  # (d, Hkv, hd)
    hkv = wk.shape[-2]
    rows = int8_view(wk).permute(1, 0, 2).reshape(hkv, -1)
    return row_order(rows, strategy, k)


def apply_head_ordering(attn_params: dict, cfg: ModelConfig, perm: torch.Tensor) -> dict:
    """Permute KV-head groups (wk/wv) and the matching q-head blocks (wq/wo)."""
    out = dict(attn_params)
    rep = cfg.q_rep
    idx = perm.to(torch.int64)
    hkv = out["wk"].shape[-2]
    out["wk"] = out["wk"].index_select(-2, idx)
    out["wv"] = out["wv"].index_select(-2, idx)
    d, h, hd = out["wq"].shape
    out["wq"] = out["wq"].reshape(d, hkv, rep, hd).index_select(1, idx).reshape(d, h, hd)
    wo = out["wo"].reshape(hkv, rep, hd, -1)
    out["wo"] = wo.index_select(0, idx).reshape(h, hd, -1)
    return out


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def _leading(tree: dict) -> int:
    v = next(iter(tree.values()))
    return _leading(v) if isinstance(v, dict) else v.shape[0]


def apply_weight_ordering(
    params: dict, cfg: ModelConfig, strategy: Strategy = "app", k: int = 4
) -> dict:
    """Order every layer's MLP d_ff axis and attention KV groups.

    Layer-stacked params get per-layer permutations, one layer at a time.
    Returns a new params tree of the same shapes and dtypes; model outputs
    are unchanged up to float summation order.
    """
    if strategy == "none":
        return params
    out = dict(params)

    def order_layer(lp: dict) -> dict:
        lp = dict(lp)
        if "mlp" in lp:
            lp["mlp"] = apply_mlp_ordering(lp["mlp"], mlp_permutation(lp["mlp"], strategy, k))
        if "attn" in lp:
            perm = head_permutation(lp["attn"], cfg, strategy, k)
            lp["attn"] = apply_head_ordering(lp["attn"], cfg, perm)
        return lp

    for key in ("layers", "enc_layers", "trailing"):
        if key in out and isinstance(out[key], dict) and (
            "mlp" in out[key] or "attn" in out[key]
        ):
            stacked = out[key]
            out[key] = _stack([order_layer(_layer(stacked, i)) for i in range(_leading(stacked))])
    if "shared" in out:
        out["shared"] = order_layer(out["shared"])
    return out


# --------------------------------------------------------------------------
# gradient egress permutation (static, replica-identical)


def egress_permutation(
    weights_flat_int8, packet: int = 64, strategy: Strategy = "app", k: int = 4,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Static wire permutation: int8 positions grouped into ``packet``-byte
    packets, packets ordered within by the *weight* byte popcount bucket
    ``(popcount * levels) // 9`` (levels 9 for ACC, else ``k``: so
    ``strategy="none"`` sorts too, by k buckets, as in the reference),
    stably; a tail shorter than a packet stays in place.

    Each packet is one ``psu_sort`` row (the CUDA kernel on a CUDA
    tensor); ``perm`` is the packet base plus the sort's order, and
    ``inv`` the base plus its rank, both updated in place.

    Returns (perm, inv_perm) as int32 tensors on the weights' device (the
    reference returns numpy int32).  Takes 1 <= packet <= 1,024 (the PSU
    kernel's row width) and k in [1, 9], and raises outside them on every
    device.
    """
    w = weights_flat_int8
    if not isinstance(w, torch.Tensor):
        w = torch.as_tensor(w, device=resolve_device())
    if w.dim() != 1 or w.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"egress_permutation takes a flat int8 vector, got {w.dtype} "
                        f"{tuple(w.shape)}")
    if not 1 <= packet <= MAX_N:
        raise ValueError(f"packet must be in [1, {MAX_N}] (one PSU row), got {packet}")
    m = w.shape[0]
    if m >= 2**31:
        raise ValueError(f"{m} positions do not fit the int32 permutation")
    usable = (m // packet) * packet
    with _obs.stage("traffic.stage", "egress_permutation"):
        order, rank = psu_sort(
            _bytes(w[:usable]).reshape(-1, packet), width=8,
            k=None if strategy == "acc" else k, backend=backend,
        )
        with _obs.stage("traffic.stage", "egress_base"):
            base = torch.arange(0, usable, packet, dtype=torch.int32, device=w.device)[:, None]
            perm, inv = order.add_(base).reshape(-1), rank.add_(base).reshape(-1)
            if usable < m:
                tail = torch.arange(usable, m, dtype=torch.int32, device=w.device)
                perm, inv = torch.cat([perm, tail]), torch.cat([inv, tail])
    return perm, inv


# --------------------------------------------------------------------------
# BT accounting over modeled flit streams (delegates to repro_torch.link)


@dataclasses.dataclass(frozen=True)
class BTStreamReport:
    name: str
    num_flits: int
    bt_none: float
    bt_ordered: float

    @property
    def reduction(self) -> float:
        return 1.0 - self.bt_ordered / max(self.bt_none, 1e-9)


def _row_spec(strategy: Strategy, k: int, sign_magnitude: bool, layout: str) -> LinkSpec:
    return LinkSpec(
        width_bits=128,
        flits_per_packet=1,
        input_lanes=16,
        weight_lanes=0,
        key="none" if strategy == "none" else "row_bucket",
        encode="sign_magnitude" if sign_magnitude else "identity",
        pack="col" if layout == "col" else "row",
        k=_row_levels(strategy, k),
    )


def stream_bt_report(
    name: str,
    tensor: torch.Tensor,
    strategy: Strategy = "app",
    k: int = 4,
    row_axis: int = -2,
    lanes: int = 16,
    sign_magnitude: bool = False,
    layout: Literal["row", "col"] = "row",
) -> BTStreamReport:
    """BT of streaming ``tensor`` before/after popcount row ordering.

    ``layout="row"`` streams whole rows (the HBM-natural order);
    ``layout="col"`` interleaves rows column-major so consecutive flits
    carry adjacent rows in the sorted order.  The encode stage is part of
    both specs, so the report isolates the ordering gain.  Two
    ``TxPipeline`` row-stream measurements (key 'none', then the ordered
    spec), on the tensor's device.
    """
    t8 = int8_view(tensor)
    mat = torch.movedim(t8, row_axis, 0).reshape(t8.shape[row_axis], -1)
    base_spec = dataclasses.replace(
        _row_spec("none", k, sign_magnitude, layout), width_bits=lanes * 8, input_lanes=lanes,
    )
    ord_spec = dataclasses.replace(
        _row_spec(strategy, k, sign_magnitude, layout), width_bits=lanes * 8, input_lanes=lanes,
    )
    base = TxPipeline(base_spec, device=mat.device).measure_rows(mat, name=name)
    ordered = TxPipeline(ord_spec, device=mat.device).measure_rows(mat, name=name)
    return BTStreamReport(name, base.num_flits, base.total_bt, ordered.total_bt)
