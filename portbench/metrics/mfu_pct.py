"""The whole step's share of the H100's peak: the sum of the least times
of every layer's counted work (HBM binds each) over the mean step time of
the traced window (host clock)."""


def read(run):
    least = sum(run.least_s(layer) for layer in run.work)
    return 100 * least * run.steps / run.window_s
