# The hand-written Hopper kernels and their plain PyTorch twins (one module
# per TPU kernel they replace):
#   psu.py      - the popcount-sorting unit (repro/kernels/psu.py)
#   btcount.py  - bit transitions of a flit stream (repro/kernels/btcount.py)
#   axes.py     - the multi-axis BT core (repro/kernels/axes.py): the fused
#                 sort -> pack -> BT stream, and the jagged link x ordering
#                 x codec measurement with its per-wire activity windows
#   quantize.py - the blockwise int8 egress quantizer (repro/kernels/quantize.py)
# csrc/ holds the CUDA sources, _build.py compiles them at first use,
# backend.py is the device-decides dispatch and ops.py the public wrappers.
from .axes import CODEC_SCHEMES, CodecVariant, Variant, VARIANT_KEYS
from .axes import bt_axes_activity_cuda as _bt_axes_activity_cuda
from .axes import bt_axes_cuda as _bt_axes_cuda
from .axes import psu_stream_cuda as _psu_stream_cuda
from .backend import BACKENDS, resolve_device
from .btcount import bt_count_cuda as _bt_count_cuda
from .ops import (
    AxesActivity,
    LinkActivity,
    PsuStreamResult,
    bt_count,
    bt_count_axes,
    bt_count_axes_sharded,
    bt_count_codecs,
    bt_count_links,
    bt_count_variants,
    psu_reorder,
    psu_sort,
    psu_stream,
    quantize_egress,
)
from .psu import psu_sort_cuda as _psu_sort_cuda
from .quantize import quantize_egress_cuda as _quantize_egress_cuda

__all__ = [
    "psu_sort",
    "psu_reorder",
    "psu_stream",
    "PsuStreamResult",
    "AxesActivity",
    "LinkActivity",
    "bt_count",
    "bt_count_axes",
    "bt_count_axes_sharded",
    "bt_count_links",
    "bt_count_variants",
    "bt_count_codecs",
    "quantize_egress",
    "Variant",
    "CodecVariant",
    "VARIANT_KEYS",
    "CODEC_SCHEMES",
    "BACKENDS",
    "resolve_device",
    "launch_counts",
    "reset_launch_counts",
]

_WRAPPERS = {
    "psu_sort": _psu_sort_cuda,
    "bt_count": _bt_count_cuda,
    "psu_stream": _psu_stream_cuda,
    "bt_axes": _bt_axes_cuda,
    # the activity mode (its own launch entry, so the BT-only counts stay apart)
    "bt_axes_activity": _bt_axes_activity_cuda,
    "quantize_egress": _quantize_egress_cuda,
}


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
