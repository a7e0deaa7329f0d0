"""Process start to the first timed step (host clock): imports, the
kernel library's load (its build, in a checkout's first run), the inputs
made on the device and the warm-up step."""


def read(run):
    return run.setup_s
