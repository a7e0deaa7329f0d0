"""The steps that drive the port, one module per path a traffic mix can
name.  Each module gives ``LAYERS`` (the port's layers it drives and the
ranges their calls run in), ``work`` (each layer's bytes and integer
operations a step, from shapes), ``step`` (one measurement on one input
snapshot: its answer on the host and the device outputs the check
compares) and ``check`` (the comparison with the plain reference)."""
