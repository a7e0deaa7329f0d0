"""The noc_fabric layer's least time (its bytes and operations, counted from the
traffic's shapes, at the H100's peaks) over the device time of the
operations in its ranges, in %."""


def read(run):
    return run.roofline_pct("noc_fabric")
