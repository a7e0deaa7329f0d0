"""Assigned input-shape set for the LM-family architectures.

Every architecture pairs with these four shapes (assignment):

  train_4k     seq_len=4096    global_batch=256   -> train_step
  prefill_32k  seq_len=32768   global_batch=32    -> serve prefill
  decode_32k   seq_len=32768   global_batch=128   -> serve_step (1 new token,
                                                     KV cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     -> serve_step; needs
                                                     sub-quadratic attention,
                                                     run for SSM/hybrid only
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k is skipped for pure full-attention archs (DESIGN.md §4): a dense
# 512k-token KV attention is the quadratic-cost case the assignment says to
# skip; SSM/hybrid archs run it with O(1) state.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shapes_for_family(family: str) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if family in SUBQUADRATIC_FAMILIES:
        names.append("long_500k")
    return names
