"""Codec registration into the ``repro_torch.link`` stage machinery.

Counterpart of ``repro.codec.stage``: ``CODEC_STAGES`` is the registry a
``LinkSpec.codec`` name resolves against (the one home is
``schemes.CODECS``), and ``kernel_config`` maps a spec's (ordering, codec)
pair onto the static config the multi-axis measurement takes.  The wire
codec codes the assembled flit stream, after ordering and packing; the
stateless byte maps also exist as element-level encode stages
(``repro_torch.link.stages.ENCODE_STAGES``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..kernels import CodecVariant
from ..link.spec import LinkSpec
from ..link.stages import lookup_stage
from .schemes import CODECS, Codec, CodedStream, codec_by_name

__all__ = ["CODEC_STAGES", "wire_codec", "encode_stream", "kernel_config"]

CODEC_STAGES: Dict[str, Codec] = CODECS


def wire_codec(name: str) -> Codec:
    """The registered codec for a ``LinkSpec.codec`` name (unknown names
    list the registered codecs)."""
    return lookup_stage("codec", name, CODEC_STAGES)


def encode_stream(stream: torch.Tensor, name: str) -> CodedStream:
    """Apply the named wire codec to an assembled (T, lanes) stream."""
    return wire_codec(name).encode(stream)


def kernel_config(spec: LinkSpec) -> CodecVariant:
    """The static measurement config of this spec's (ordering, codec) pair
    (``repro_torch.kernels.bt_count_codecs``)."""
    codec = codec_by_name(spec.codec)
    return CodecVariant(
        key=spec.key,
        k=spec.k if spec.key == "app" else None,
        descending=spec.descending,
        codec=codec.scheme,
        partition=codec.partition,
    )
