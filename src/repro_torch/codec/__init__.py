# The low-power link-coding subsystem (counterpart of repro.codec): the
# classic coding family the paper's ordering is compared against, and
# composed with.
#   schemes.py  - encode/decode codec pairs over flit streams + registry
#   stage.py    - registration into the repro_torch.link stage machinery
#   overhead.py - invert-line / extra-wire and encoder-area accounting
#   compare.py  - ordering vs coding vs composed comparison tables, one
#                 bt_count_codecs measurement per stream
from .compare import ComparisonRow, compare_streams, demo_workloads, format_table
from .overhead import CodecOverhead, codec_overhead, coded_energy_pj
from .schemes import (
    CODECS,
    SCHEMES,
    Codec,
    CodedStream,
    bus_invert_partitions,
    codec_by_name,
    invert_line_transitions,
    make_bus_invert,
    register_codec,
)
from .stage import CODEC_STAGES, encode_stream, kernel_config, wire_codec

__all__ = [
    "Codec",
    "CodedStream",
    "CODECS",
    "CODEC_STAGES",
    "SCHEMES",
    "codec_by_name",
    "make_bus_invert",
    "register_codec",
    "bus_invert_partitions",
    "invert_line_transitions",
    "wire_codec",
    "encode_stream",
    "kernel_config",
    "CodecOverhead",
    "codec_overhead",
    "coded_energy_pj",
    "ComparisonRow",
    "compare_streams",
    "format_table",
    "demo_workloads",
]
