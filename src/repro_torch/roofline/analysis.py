"""Three-term roofline from dry-run or step records.

Counterpart of ``repro.roofline.analysis``:

    compute    = FLOPs_per_device / peak_FLOPs          [s]
    memory     = resident bytes per device / HBM_bw     [s]  (the floor)
    collective = wire_bytes_per_device / link_bw        [s]

Hardware constants: the NVIDIA H100 SXM5 (80 GB HBM3, 700 W board power),
from NVIDIA's H100 Tensor Core GPU data sheet: 989 TFLOP/s dense bf16
(1,979 with sparsity), 3.35 TB/s HBM3, and NVLink 4 at 900 GB/s per GPU in
both directions, 450 GB/s each way.  ``ICI_BW`` keeps the reference's name
for the per-device link rate.  The reference's TPU v5e constants stay in
the reference.

Wire factors per collective kind (ring algorithms, group size n):
    all-reduce         2 (n-1)/n   x result bytes
    all-gather           (n-1)/n   x result bytes
    reduce-scatter       (n-1)     x result bytes (result is the shard)
    all-to-all           (n-1)/n   x result bytes
    collective-permute   1         x result bytes

MODEL_FLOPS: 6·N·D train (2 fwd + 4 bwd), 2·N·D prefill, 2·N_active·B
decode, plus attention — per device after dividing by the device count.
The ratio MODEL_FLOPS / counted FLOPs exposes remat / dispatch / redundancy
waste.

A torch record has no XLA bytes-accessed count (``roofline.collect``), so
``memory_hlo_s`` is None there and the memory term is the floor alone, as
the reference's ``dominant`` already reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .collect import wire_bytes

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "RooflineTerms", "analyse",
           "wire_bytes_per_device", "model_flops_global"]

PEAK_FLOPS = 989e12  # dense bf16 / H100 SXM5
HBM_BW = 3.35e12  # bytes/s, HBM3
ICI_BW = 450e9  # bytes/s per direction per GPU, NVLink 4 (the reference's name)


def wire_bytes_per_device(rec: dict[str, Any]) -> float:
    if "wire_bytes_per_device" in rec:
        return float(rec["wire_bytes_per_device"])
    return wire_bytes(rec.get("collective_ops", []))


def _attention_flops(rec: dict[str, Any], seq_len: int, global_batch: int,
                     cfg=None) -> float:
    """Attention (QK^T + PV) FLOPs — part of useful MODEL_FLOPS.

    Dense/MoE/VLM: causal full attention over seq_len.  SSM archs: the SSD
    scan's state FLOPs are already ~proportional to params x tokens (no
    quadratic term).  Hybrid: shared attention every k layers.  ``cfg``
    defaults to the record's arch as configured (``get_config``), as the
    reference reads it.
    """
    if cfg is None:
        from ..configs import get_config

        cfg = get_config(rec["arch"])
    hd = cfg.resolved_head_dim
    d_attn = cfg.n_heads * hd
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // cfg.shared_attn_every
    else:
        n_attn_layers = cfg.n_layers
    mult = 3.0 if rec["kind"] == "train" else 1.0  # fwd+bwd vs fwd
    if cfg.family in ("encdec", "audio"):
        enc_len = 1500  # whisper stub frontend (launch/specs.ENC_FRAMES)
        if rec["kind"] == "decode":
            per_tok = 4.0 * cfg.n_layers * (seq_len + enc_len) * d_attn
            return global_batch * per_tok
        # encoder bidirectional S_enc^2 + decoder causal S^2/2 + cross S*S_enc
        fwd = 4.0 * global_batch * d_attn * (
            cfg.n_enc_layers * enc_len**2
            + cfg.n_layers * (seq_len**2 / 2 + seq_len * enc_len)
        )
        return mult * fwd
    if rec["kind"] == "decode":
        # each new token attends the full cache
        return 4.0 * global_batch * n_attn_layers * seq_len * d_attn
    # causal: 4*S^2/2 = 2 S^2 per layer (QK + PV) forward
    return mult * 2.0 * global_batch * n_attn_layers * seq_len**2 * d_attn


def model_flops_global(rec: dict[str, Any], seq_len: int, global_batch: int,
                       cfg=None) -> float:
    n_active = rec["active_params"]
    attn = _attention_flops(rec, seq_len, global_batch, cfg)
    if rec["kind"] == "train":
        return 6.0 * n_active * seq_len * global_batch + attn
    if rec["kind"] == "prefill":
        return 2.0 * n_active * seq_len * global_batch + attn
    return 2.0 * n_active * global_batch + attn  # decode: one token/sequence


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    kind: str
    compute_s: float
    memory_hlo_s: float | None  # bytes accessed / HBM where a record has them
    memory_floor_s: float  # resident bytes / HBM: every live byte crosses
    #                        HBM at least once per step
    collective_s: float
    model_flops_per_device: float
    hlo_flops_per_device: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        """Dominant term, using the memory FLOOR (the defensible bound)."""
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_floor_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_floor_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roofline that useful model FLOPs occupy:
        (model_flops/peak) / max(term) — 1.0 means the dominant resource is
        spent entirely on useful compute."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops_per_device / PEAK_FLOPS) / self.bound_s

    def measured_fraction(self, seconds: float) -> float:
        """The useful model FLOPs' time at peak over a measured step time."""
        return (self.model_flops_per_device / PEAK_FLOPS) / seconds if seconds > 0 else 0.0


def analyse(rec: dict[str, Any], seq_len: int, global_batch: int, cfg=None) -> RooflineTerms:
    chips = rec["num_devices"]
    mf = model_flops_global(rec, seq_len, global_batch, cfg) / chips
    hf = rec["hlo_flops_per_device"]
    floor_bytes = rec.get("tpu_peak_bytes_per_device", rec.get("peak_bytes_per_device", 0))
    hlo_bytes = rec.get("hlo_bytes_per_device")
    return RooflineTerms(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        kind=rec["kind"],
        compute_s=hf / PEAK_FLOPS,
        memory_hlo_s=None if hlo_bytes is None else hlo_bytes / HBM_BW,
        memory_floor_s=floor_bytes / HBM_BW,
        collective_s=wire_bytes_per_device(rec) / ICI_BW,
        model_flops_per_device=mf,
        hlo_flops_per_device=hf,
        useful_ratio=mf / hf if hf else 0.0,
    )
