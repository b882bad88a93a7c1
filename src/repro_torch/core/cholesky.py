"""Blocked right-looking Cholesky A = L Lᵀ (port of
:mod:`repro.core.cholesky`, the single-device path).

Per block step: the (nb, nb) Cholesky of the diagonal block, the panel's
triangular solve L21 = A21·Lkk⁻ᵀ, and the rank-nb SYRK update of the
trailing matrix.  ``backend="cuda"`` with float32 and ``fuse_panel=True``
runs the solve and the update as one call of the hand-written kernel
(:mod:`repro_torch.kernels.factor_fused`); with ``fuse_panel=False`` they
are the triangular-solve kernel (:mod:`repro_torch.kernels.trsm`) and the
tiled GEMM kernel (:mod:`repro_torch.kernels.gemm`); otherwise
``solve_triangular`` and a matrix product, in the input's dtype.

As in :mod:`repro_torch.core.lu`, k is a host integer, each step slices its
active window, and the factorization works in place on one working copy.
Non-block-multiple sizes are identity-padded (exact).
"""
from __future__ import annotations

import torch

from repro_torch.core import blocking
from repro_torch.core.triangular import (solve_lower_blocked,
                                         solve_upper_blocked)
from repro_torch.kernels import ops


def cholesky_factor(a: torch.Tensor, block_size: int = 128, mesh=None,
                    backend: str = "ref", fuse_panel: bool = True
                    ) -> torch.Tensor:
    """Returns L (lower triangular) with A = L @ L.T.  A must be SPD."""
    blocking.check_backend(backend, mesh)
    if mesh is not None:
        raise ValueError("the distributed Cholesky (mesh=) is not ported "
                         "yet; drop mesh= for the single-device "
                         "factorization")
    kernels = blocking.effective_backend(backend, a.dtype) == "cuda"
    a, nb, n = blocking.working_copy(a, block_size)
    eye = torch.eye(nb, dtype=a.dtype, device=a.device)
    for k in range(0, n, nb):
        akk = a[k:k + nb, k:k + nb]
        # jnp.linalg.cholesky factors the symmetrized block; torch reads
        # only the lower triangle, so symmetrize as the reference does.
        # cholesky_ex: no host read of the error flag per step.  A block
        # that is not positive definite becomes NaN, as jnp.linalg.cholesky
        # returns it, so the failure reaches x instead of a partial factor.
        fac = torch.linalg.cholesky_ex((akk + akk.T) / 2)
        lkk = torch.where(fac.info == 0, fac.L, torch.nan)
        a[k:k + nb, k:k + nb] = lkk
        if kernels and fuse_panel:
            linv = torch.linalg.solve_triangular(lkk, eye, upper=False)
            ops.cholesky_panel_update(a, linv, k, nb=nb)
        elif kernels and k + nb < n:     # the last step has no L21
            # L21 = C·Lkk⁻ᵀ: Lkk L21ᵀ = Cᵀ
            l21 = ops.trsm_lower(lkk, a[k + nb:, k:k + nb].T).T
            a[k + nb:, k:k + nb] = l21
            a[k + nb:, k + nb:] -= ops.matmul(l21, l21.T)
        elif not kernels:
            colblk = a[k + nb:, k:k + nb]
            l21 = torch.linalg.solve_triangular(lkk, colblk.T,
                                                upper=False).T
            a[k + nb:, k:k + nb] = l21
            a[k + nb:, k + nb:] -= l21 @ l21.T
    return a.tril_()


def cholesky_solve(l: torch.Tensor, b: torch.Tensor, block_size: int = 128,
                   mesh=None, backend: str = "ref") -> torch.Tensor:
    """Solve A x = b given L from :func:`cholesky_factor`; ``b`` may be
    shorter than the (padded) factor."""
    n0 = b.shape[0]
    bp = blocking.pad_rhs(b, l.shape[0])
    y = solve_lower_blocked(l, bp, block_size=block_size, mesh=mesh,
                            backend=backend)
    # Lᵀ x = y: the upper solve on the transposed view (no copy of L)
    x = solve_upper_blocked(l.T, y, block_size=block_size, mesh=mesh,
                            backend=backend)
    return x[:n0]


def cholesky_factor_state(a: torch.Tensor, *, block_size: int = 128,
                          mesh=None, backend: str = "ref"
                          ) -> tuple[torch.Tensor]:
    """Registry ``factor`` entry: one-tuple state for :func:`cholesky_apply`."""
    return (cholesky_factor(a, block_size=block_size, mesh=mesh,
                            backend=backend),)


def cholesky_apply(state, b: torch.Tensor, *, block_size: int = 128,
                   mesh=None, backend: str = "ref") -> torch.Tensor:
    """Registry ``apply`` entry: solve from a factored state."""
    (l,) = state
    return cholesky_solve(l, b, block_size=block_size, mesh=mesh,
                          backend=backend)


def solve(a: torch.Tensor, b: torch.Tensor, block_size: int = 128, mesh=None,
          backend: str = "ref") -> torch.Tensor:
    l = cholesky_factor(a, block_size=block_size, mesh=mesh, backend=backend)
    return cholesky_solve(l, b, block_size=block_size, mesh=mesh,
                          backend=backend)
