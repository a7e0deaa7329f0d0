"""Int8 gradient-wire bytes measured in the window over the window's
seconds (host clock): the rate at which a user's traffic becomes BT
integers.  A step's bytes are its wire elements, once however many
orderings it measures."""


def read(run):
    return run.steps * run.wire_bytes / run.window_s / 1e9
