"""Vector-valued (n_components > 1) constrained Laplace operator, on torch.

Mirror of the JAX package's ops/vector.py, the Stokes building block (the
reference declares but stubs this case, include/operator.h:396-406).
Vectors are component-major ``[n_components, n]``: each component is a
contiguous scalar field, so the scalar operator and preconditioner apply
unchanged per component, in a loop where the JAX package uses
``jax.vmap``.  Constraints act identically on every component, the
semantics of a deal.II FESystem of ``n_components`` copies of FE_Q(p) with
component-independent constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class VectorOperator:
    """n_components copies of a scalar constrained operator (anything with
    vmult / dot / n_dofs / dtype); vectors are ``[n_components, n]``."""

    scalar: object
    n_components: int

    @property
    def dtype(self) -> torch.dtype:
        return self.scalar.dtype

    @property
    def n_dofs(self) -> int:
        return self.n_components * self.scalar.n_dofs

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.scalar.vmult(c) for c in u])

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return sum(self.scalar.dot(a, b) for a, b in zip(x, y))


def make_vector_operator(scalar_op, n_components: int) -> VectorOperator:
    return VectorOperator(scalar_op, n_components)


@dataclass(frozen=True)
class VectorPreconditioner:
    """A scalar preconditioner (e.g. PreconditionMG over the scalar
    hierarchy) applied per component: the block-diagonal preconditioner of
    the vector Laplacian."""

    scalar: object

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.scalar.vmult(c) for c in b])

    __call__ = vmult
