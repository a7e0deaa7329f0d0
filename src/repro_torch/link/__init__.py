# The TX-pipeline subsystem (counterpart of repro.link): the paper's
# transmit dataflow as one registry-backed pipeline (DESIGN.md §3.2):
#   spec.py     - LinkSpec: framing + stage selection
#   stages.py   - registered key/encode/pack stages + legacy strategy API
#   framing.py  - flit packing and paired-stream assembly (DESIGN.md §1)
#   pipeline.py - TxPipeline: staged path + fused single-launch hot path
#   power.py    - the Fig. 6/7 link power model
from .framing import (
    assemble_stream,
    measure,
    pack_to_flits,
    paired_stream,
    unpack_from_flits,
)
from .pipeline import LinkReport, TxPipeline, TxResult
from .power import LinkPowerModel
from .spec import LinkSpec
from .stages import (
    ENCODE_STAGES,
    KEY_STAGES,
    ORDER_STRATEGIES,
    PACK_STAGES,
    KeyStage,
    PackStage,
    lookup_stage,
    make_order,
    order_packets,
    row_bucket_keys,
    row_bucket_order,
    tensor_flit_stream,
    to_gray,
    to_sign_magnitude,
)

__all__ = [
    "LinkSpec",
    "TxPipeline",
    "TxResult",
    "LinkReport",
    "LinkPowerModel",
    "pack_to_flits",
    "unpack_from_flits",
    "assemble_stream",
    "paired_stream",
    "measure",
    "make_order",
    "order_packets",
    "ORDER_STRATEGIES",
    "KEY_STAGES",
    "ENCODE_STAGES",
    "PACK_STAGES",
    "KeyStage",
    "PackStage",
    "lookup_stage",
    "to_sign_magnitude",
    "to_gray",
    "tensor_flit_stream",
    "row_bucket_keys",
    "row_bucket_order",
]
