"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): HBM3 at 3.35 TB/s and 67 T/s on the CUDA cores, the rate
the port's integer kernels run at.  A card set below 700 W reads lower."""

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def least_s(bytes_moved: float, ops: float) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S)
