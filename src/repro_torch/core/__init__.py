# The paper's primary contribution — comparison-free popcount sorting
# (ACC-PSU / APP-PSU) — plus the BT and area models used to evaluate it.
# Counterpart of repro.core (the legacy link/ordering shims are not ported:
# their home is repro_torch.link).
from .area import (
    AREA_ANCHORS,
    PSUArea,
    PSUTiming,
    bitonic_area,
    bitonic_timing,
    codec_area,
    csn_area,
    psu_area,
    psu_timing,
)
from .bt import BTReport, bit_transitions, bt_per_flit, bt_report
from .popcount import (
    bucket_boundaries,
    bucket_map,
    num_bucket_bits,
    popcount,
    popcount_lut4,
)
from .sorting import (
    acc_sort_indices,
    app_sort_indices,
    apply_order,
    counting_sort_indices,
    counting_sort_ranks,
    invert_permutation,
)

__all__ = [
    "popcount",
    "popcount_lut4",
    "bucket_map",
    "bucket_boundaries",
    "num_bucket_bits",
    "counting_sort_ranks",
    "counting_sort_indices",
    "acc_sort_indices",
    "app_sort_indices",
    "apply_order",
    "invert_permutation",
    "bit_transitions",
    "bt_per_flit",
    "bt_report",
    "BTReport",
    "psu_area",
    "bitonic_area",
    "csn_area",
    "codec_area",
    "PSUArea",
    "AREA_ANCHORS",
    "PSUTiming",
    "psu_timing",
    "bitonic_timing",
]
