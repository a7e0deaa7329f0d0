# Roofline (counterpart of repro.roofline): the three-term analysis with
# the H100's constants, and its inputs from a torch run.  The reference's
# HLO parsers (parse_collectives, cpu_bf16_upcast_bytes) and
# collect_from_compiled read XLA executables and have no counterpart.
from .analysis import (
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS,
    RooflineTerms,
    analyse,
    model_flops_global,
    wire_bytes_per_device,
)
from .collect import collect_from_step, record_collectives, summarize_collectives, wire_bytes

__all__ = [
    "PEAK_FLOPS",
    "HBM_BW",
    "ICI_BW",
    "RooflineTerms",
    "analyse",
    "wire_bytes_per_device",
    "model_flops_global",
    "collect_from_step",
    "record_collectives",
    "summarize_collectives",
    "wire_bytes",
]
