"""95th percentile over every step of the window of the host time from a
step's start until its BT integers are on the host: the wait for one
snapshot's answer."""

import statistics


def read(run):
    if len(run.step_s) < 2:
        return 1e3 * run.step_s[0]
    return 1e3 * statistics.quantiles(run.step_s, n=20, method="inclusive")[-1]
