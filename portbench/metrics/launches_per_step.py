"""The port's own launch counters (``repro_torch.kernels.launch_counts``)
over the window, per step."""


def read(run):
    return sum(run.launches.values()) / run.steps
