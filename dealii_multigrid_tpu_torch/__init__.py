"""dealii_multigrid_tpu_torch — the PyTorch/CUDA port of dealii_multigrid_tpu.

The matrix-free hybrid-patch multigrid solver (HMG-global, Poisson on Q_p
elements with hanging-node and Dirichlet constraints) on one NVIDIA GPU.
Host-side setup is NumPy (a copy of the JAX package's host setup code, so both
packages build identical tables); device work is PyTorch plus hand-written
CUDA kernels under ``csrc/``.  The package imports torch and never jax.
"""

__version__ = "0.1.0"
