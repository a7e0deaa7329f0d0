"""The benchmark of the PyTorch and CUDA port ``repro_torch``: cells of a
model configuration under a traffic mix, run by ``portbench/run.py``.  It
drives the port through its public entry points and imports neither JAX
nor the JAX package ``repro``."""
