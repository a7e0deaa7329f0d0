"""The device allocator's peak (``torch.cuda.max_memory_allocated``) over
set-up and window, in GB: it decides whose traffic fits on one card."""


def read(run):
    return run.peak_bytes / 1e9
