"""Preconditioners for the Krylov solvers (port of :mod:`repro.core.precond`,
dense, single device): Jacobi and block-Jacobi.  ``make`` sends a sparse
matrix to the matrix-free extractions of :mod:`repro_torch.sparse.precond`.

Block-Jacobi LU-factors the diagonal blocks up front, batched over the
blocks with ``torch.linalg.lu_factor``, and applies M⁻¹ with one batched
``lu_solve``.  A non-block-multiple ``n`` goes through the identity-pad
policy of :mod:`repro_torch.core.blocking`.  Pivots are torch's 1-based
LAPACK pivots (the reference keeps JAX's 0-based ones; see
:func:`repro_torch.interop.precond_from_numpy`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import blocking

_EPS = 1e-30


class Preconditioner(NamedTuple):
    kind: str                      # "jacobi" | "block_jacobi" | "custom"
    data: tuple                    # state tensors
    apply: Callable                # M⁻¹ v


def _jacobi_data(a: torch.Tensor, eps: float = _EPS) -> tuple[torch.Tensor]:
    d = torch.diagonal(a)
    dinv = torch.where(d.abs() > eps, 1.0 / d, torch.ones_like(d))
    return (dinv,)


def _block_jacobi_data(a: torch.Tensor, block_size: int):
    """(lu, piv): LU factors (k, nb, nb) and 1-based pivots (k, nb) of the
    diagonal blocks of the identity-padded system."""
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"block_jacobi wants a square (n, n) matrix, got "
                         f"{tuple(a.shape)}")
    m, nb, n_pad = blocking.pad_system(a, block_size)
    k = n_pad // nb
    blocks = torch.diagonal(m.reshape(k, nb, k, nb), dim1=0, dim2=2)
    return torch.linalg.lu_factor(blocks.movedim(-1, 0).contiguous())


def _apply_jacobi(dinv):
    return lambda v: dinv * v


def _apply_block_jacobi(lu, piv):
    """M⁻¹ v for (k, nb, nb) factors and (n,) v.  A factor of the
    identity-padded system takes the logical-length v (zero-pad in, slice
    out — exact)."""
    k, nb = piv.shape

    def apply(v):
        n = v.shape[-1]
        vb = F.pad(v, (0, k * nb - n)).reshape(k, nb, 1)
        return torch.linalg.lu_solve(lu, piv, vb).reshape(k * nb)[:n]
    return apply


def from_data(kind: str, data: tuple) -> Preconditioner:
    """A named preconditioner from its state tensors."""
    if kind == "jacobi":
        return Preconditioner(kind, tuple(data), _apply_jacobi(*data))
    if kind == "block_jacobi":
        return Preconditioner(kind, tuple(data), _apply_block_jacobi(*data))
    raise ValueError(f"unknown preconditioner {kind!r}")


def make(spec, a: torch.Tensor, block_size: int = 128
         ) -> Preconditioner | None:
    """A Preconditioner from a user spec (None / name / Preconditioner /
    callable).  Sparse matrices delegate to the matrix-free extractions of
    :mod:`repro_torch.sparse.precond` (same kinds + ``"ssor"``, no
    densify)."""
    if getattr(a, "is_sparse", False):
        from repro_torch.sparse import precond as sparse_precond
        return sparse_precond.make(spec, a, block_size)
    if spec is None:
        return None
    if isinstance(spec, Preconditioner):
        return spec
    if callable(spec):
        return Preconditioner("custom", (), spec)
    if spec == "jacobi":
        return from_data(spec, _jacobi_data(a))
    if spec == "block_jacobi":
        return from_data(spec, tuple(_block_jacobi_data(a, block_size)))
    raise ValueError(f"unknown preconditioner {spec!r}")


def jacobi(a: torch.Tensor, eps: float = _EPS) -> Callable:
    """Diagonal (point-Jacobi) preconditioner M⁻¹ = diag(A)⁻¹."""
    return _apply_jacobi(*_jacobi_data(a, eps))


def block_jacobi(a: torch.Tensor, block_size: int = 128) -> Callable:
    """Block-diagonal preconditioner; blocks LU-factored up front."""
    return _apply_block_jacobi(*_block_jacobi_data(a, block_size))
