"""Plain PyTorch references that decide each cell's ``correct``.  They
import torch alone: nothing of the program, the JAX package or JAX."""
