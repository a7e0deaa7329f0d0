# Model traffic as link streams (counterpart of repro.traffic): the int8
# wire view, popcount row ordering of model weights, the static gradient
# egress permutation and stream BT reports.
from .ordering import (
    BTStreamReport,
    apply_head_ordering,
    apply_mlp_ordering,
    apply_weight_ordering,
    egress_permutation,
    head_permutation,
    int8_view,
    mlp_permutation,
    row_bucket_keys,
    row_order,
    stream_bt_report,
    tensor_flit_stream,
    to_sign_magnitude,
)

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
    "tensor_flit_stream",
    "stream_bt_report",
    "BTStreamReport",
    "to_sign_magnitude",
]
