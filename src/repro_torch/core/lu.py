"""Blocked right-looking LU with partial pivoting (port of
:mod:`repro.core.lu`, the single-device path).

The paper's delayed-update LU: per block step, a pivoted factorization of
the (n − k, nb) panel, then the panel row's triangular solve and one
rank-nb update of the trailing matrix.  ``backend="cuda"`` with float32
and ``fuse_panel=True`` runs that solve-and-update as one call of the
hand-written kernel (:mod:`repro_torch.kernels.factor_fused`); with
``fuse_panel=False`` it is the triangular-solve kernel
(:mod:`repro_torch.kernels.trsm`) and the tiled GEMM kernel
(:mod:`repro_torch.kernels.gemm`), as the reference composes them;
otherwise ``solve_triangular`` plus a matrix product, in the input's
dtype.

The reference steps a fixed-shape ``lax.fori_loop`` over masked full-size
windows.  Here the step offset k is a host integer, so each step slices
its active window: the panel covers rows [k, n), and the row swaps touch
only the ≤ 2·nb rows that move (the reference gathers the whole matrix
each step).  The factorization works in place on one working copy of
``a``; the caller's matrix is never written.

``lu_factor`` returns ``(LU_packed, perm)`` with ``A[perm] = L @ U`` for
the identity-padded system when n is not a block multiple;
``lu_solve`` pads and slices the right-hand side itself.
"""
from __future__ import annotations

import torch

from repro_torch.core import blocking
from repro_torch.core.triangular import (solve_lower_blocked,
                                         solve_upper_blocked)
from repro_torch.kernels import ops


def _panel_factor(pan: torch.Tensor):
    """LU with partial pivoting of the (m, nb) panel ``pan``, in place.

    Returns ``(perm, pivots)``: ``perm`` (m,) is the row permutation with
    pan_in[perm] = L @ U, and ``pivots`` (nb,) the row chosen at each
    column.  The pivot is the first largest |entry| (``jnp.argmax``'s
    tie-break); everything stays on the device, with no host read per
    column.
    """
    m, nb = pan.shape
    perm = torch.arange(m, device=pan.device)
    pivots = torch.empty(nb, dtype=torch.long, device=pan.device)
    cols = torch.arange(nb, device=pan.device)
    for j in range(nb):
        p = j + torch.argmax(pan[j:, j].abs())
        pivots[j] = p
        swap = torch.stack((cols[j], p))
        back = torch.stack((p, cols[j]))
        pan[swap] = pan[back]
        perm[swap] = perm[back]
        pivot = pan[j, j]
        pan[j + 1:, j] /= torch.where(pivot == 0, torch.ones_like(pivot),
                                      pivot)
        pan[j + 1:, j + 1:] -= torch.outer(pan[j + 1:, j], pan[j, j + 1:])
    return perm, pivots


def lu_factor(a: torch.Tensor, block_size: int = 128, mesh=None,
              backend: str = "ref", fuse_panel: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked LU with partial pivoting.  Returns ``(LU_packed, perm)``."""
    blocking.check_backend(backend, mesh)
    if mesh is not None:
        raise ValueError("the distributed LU (mesh=) is not ported yet; "
                         "drop mesh= for the single-device factorization")
    kernels = blocking.effective_backend(backend, a.dtype) == "cuda"
    a, nb, n = blocking.working_copy(a, block_size)
    perm_total = torch.arange(n, device=a.device)
    cols = torch.arange(nb, device=a.device)
    eye = torch.eye(nb, dtype=a.dtype, device=a.device)
    for k in range(0, n, nb):
        pan = a[k:, k:k + nb].clone()
        perm, pivots = _panel_factor(pan)
        # the swaps move only the panel's own rows and the pivot rows: one
        # gather applies them to L history + trailing matrix
        moved = torch.cat((cols, pivots))
        window = a[k:]
        window[moved] = window[perm[moved]]
        a[k:, k:k + nb] = pan
        perm_total[k:] = perm_total[k:][perm]
        l11 = a[k:k + nb, k:k + nb]
        if kernels and fuse_panel:
            linv = torch.linalg.solve_triangular(l11, eye, upper=False,
                                                 unitriangular=True)
            ops.lu_panel_update(a, linv, k, nb=nb)
        elif kernels and k + nb < n:     # the last step has no A12
            u12 = ops.trsm_lower(l11.contiguous(), a[k:k + nb, k + nb:],
                                 unit_diagonal=True)
            a[k:k + nb, k + nb:] = u12
            a[k + nb:, k + nb:] -= ops.matmul(a[k + nb:, k:k + nb], u12)
        elif not kernels:
            u12 = torch.linalg.solve_triangular(
                l11, a[k:k + nb, k + nb:], upper=False, unitriangular=True)
            a[k:k + nb, k + nb:] = u12
            a[k + nb:, k + nb:] -= a[k + nb:, k:k + nb] @ u12
    return a, perm_total


def unpack(lu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split packed LU into (unit-lower L, upper U)."""
    l = torch.tril(lu, -1) + torch.eye(lu.shape[0], dtype=lu.dtype,
                                       device=lu.device)
    return l, torch.triu(lu)


def lu_solve(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor,
             block_size: int = 128, mesh=None, backend: str = "ref"
             ) -> torch.Tensor:
    """Solve A x = b given ``(LU, perm)`` from :func:`lu_factor`; ``b`` may
    be shorter than the (padded) factor."""
    n0 = b.shape[0]
    bp = blocking.pad_rhs(b, lu.shape[0])[perm]
    y = solve_lower_blocked(lu, bp, unit_diagonal=True,
                            block_size=block_size, mesh=mesh, backend=backend)
    x = solve_upper_blocked(lu, y, block_size=block_size, mesh=mesh,
                            backend=backend)
    return x[:n0]


def lu_apply(state, b: torch.Tensor, *, block_size: int = 128, mesh=None,
             backend: str = "ref") -> torch.Tensor:
    """Registry ``apply`` entry: solve from a :func:`lu_factor` state."""
    lu, perm = state
    return lu_solve(lu, perm, b, block_size=block_size, mesh=mesh,
                    backend=backend)


def solve(a: torch.Tensor, b: torch.Tensor, block_size: int = 128, mesh=None,
          backend: str = "ref") -> torch.Tensor:
    """Direct dense solve via blocked, pivoted LU."""
    lu, perm = lu_factor(a, block_size=block_size, mesh=mesh, backend=backend)
    return lu_solve(lu, perm, b, block_size=block_size, mesh=mesh,
                    backend=backend)
