"""Krylov, smoother, coarse and multigrid solvers on torch tensors."""
