"""Blocked triangular solves (port of :mod:`repro.core.triangular`, the
single-device part): L y = b and U x = y, the apply stage of the direct
solvers.

``backend="cuda"`` with float32 runs the whole solve as one call of the
hand-written kernel (:mod:`repro_torch.kernels.trsm`), which takes any n
and reads an upper or transposed triangle in place.  Otherwise the solve
is the reference's blocked loop: an (nb, nb) ``solve_triangular`` of the
diagonal block, then a block-column product updating the rest of the
right-hand side — in the input's dtype, so float64 stays float64.
Non-block-multiple sizes are identity / zero padded, which is exact (see
:mod:`repro_torch.core.blocking`).

The block-cyclic ``*_cyclic_local`` / ``*_spmd`` substitutions belong to
the distributed slice and are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import blocking
from repro_torch.kernels import ops


def _check(backend: str, mesh) -> None:
    blocking.check_backend(backend, mesh)
    if mesh is not None:
        raise ValueError("distributed triangular solves (mesh=) are not "
                         "ported yet; drop mesh= for the single-device solve")


def _padded(a, b, block_size):
    """(a, b as a 2-D working copy, nb, n, b was 1-D)."""
    a, nb, n = blocking.pad_system(a, block_size)
    vec = b.ndim == 1
    y = blocking.pad_rhs(b, n)
    y = (y[:, None] if vec else y).clone()
    return a, y, nb, n, vec


def solve_lower_blocked(a: torch.Tensor, b: torch.Tensor, *,
                        unit_diagonal: bool = False, block_size: int = 128,
                        mesh=None, backend: str = "ref") -> torch.Tensor:
    """Solve L y = b where L is the lower triangle of ``a``."""
    _check(backend, mesh)
    if blocking.effective_backend(backend, a.dtype) == "cuda":
        return ops.trsm_lower(a, b, unit_diagonal=unit_diagonal)
    n0 = b.shape[0]
    a, y, nb, n, vec = _padded(a, b, block_size)
    for k in range(0, n, nb):
        yk = torch.linalg.solve_triangular(
            a[k:k + nb, k:k + nb], y[k:k + nb], upper=False,
            unitriangular=unit_diagonal)
        y[k:k + nb] = yk
        y[k + nb:] -= a[k + nb:, k:k + nb] @ yk
    y = y[:n0]
    return y[:, 0] if vec else y


def solve_upper_blocked(a: torch.Tensor, b: torch.Tensor, *,
                        block_size: int = 128, mesh=None,
                        backend: str = "ref") -> torch.Tensor:
    """Solve U x = b where U is the upper triangle of ``a``."""
    _check(backend, mesh)
    if blocking.effective_backend(backend, a.dtype) == "cuda":
        return ops.trsm_upper(a, b)
    n0 = b.shape[0]
    a, x, nb, n, vec = _padded(a, b, block_size)
    for k in range(n - nb, -1, -nb):
        xk = torch.linalg.solve_triangular(
            a[k:k + nb, k:k + nb], x[k:k + nb], upper=True)
        x[k:k + nb] = xk
        x[:k] -= a[:k, k:k + nb] @ xk
    x = x[:n0]
    return x[:, 0] if vec else x
