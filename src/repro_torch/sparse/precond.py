"""Matrix-free preconditioners extracted from sparse structure (port of
:mod:`repro.sparse.precond`) — never densify.

* ``jacobi`` — point diagonal, read straight off the stored bricks (BSR)
  or entries (ELL).
* ``block_jacobi`` — the BSR diagonal bricks are the blocks: LU-factored
  with one batched ``torch.linalg.lu_factor``, applied with one batched
  ``lu_solve``.  Same :class:`~repro_torch.core.precond.Preconditioner`
  carrier as the dense path.
* ``ssor`` — block-SSOR at brick granularity:
  ``M = (D + ωL) D⁻¹ (D + ωU) / (ω(2−ω))`` with D the diagonal bricks and
  L/U the strictly lower/upper brick triangles.  The two sweeps run
  block row by block row, forward then backward, in the reference's order:
  a Python loop over the block rows, each step a few small tensor ops, so
  an apply is host-bound at large ``nbr``.  SPD for SPD A and 0 < ω < 2.
"""
from __future__ import annotations

import torch

from repro_torch.core.precond import (_EPS, Preconditioner,
                                      _apply_block_jacobi, _apply_jacobi)
from repro_torch.sparse import formats


def _diag_bricks(a: formats.BSR) -> torch.Tensor:
    """Diagonal bricks with all-zero bricks replaced by the identity (keeps
    the batched LU factorization well defined for hand-built
    structures)."""
    bricks = a.block_diagonal()
    ok = bricks.abs().amax(dim=(-2, -1), keepdim=True) > 0
    return torch.where(ok, bricks, torch.eye(a.nb, dtype=bricks.dtype,
                                             device=bricks.device))


def jacobi(a: formats.SparseMatrix, eps: float = _EPS) -> Preconditioner:
    if isinstance(a, formats.BSR):
        d = a.diagonal()
    elif isinstance(a, formats.ELL):
        row = torch.arange(a.shape[0], device=a.device)[:, None]
        cols = torch.from_numpy(a.cols).to(a.device)
        hits = torch.from_numpy(a.valid).to(a.device) & (cols == row)
        d = (a.data * hits).sum(dim=1)
    else:
        raise TypeError(f"unsupported sparse type {type(a)}")
    dinv = torch.where(d.abs() > eps, 1.0 / d, torch.ones_like(d))
    return Preconditioner("jacobi", (dinv,), _apply_jacobi(dinv))


def block_jacobi(a: formats.BSR) -> Preconditioner:
    """Blocks are the BSR bricks (block size = ``a.nb``); the apply pads /
    slices the logical-length operand exactly like the dense
    block-Jacobi."""
    if not isinstance(a, formats.BSR):
        raise ValueError("block_jacobi needs BSR (brick-aligned blocks); "
                         "ELL supports 'jacobi' only")
    lu, piv = torch.linalg.lu_factor(_diag_bricks(a))
    return Preconditioner("block_jacobi", (lu, piv),
                          _apply_block_jacobi(lu, piv))


def ssor(a: formats.BSR, omega: float = 1.0) -> Preconditioner:
    if not isinstance(a, formats.BSR):
        raise ValueError("ssor needs BSR (brick-aligned sweeps); "
                         "ELL supports 'jacobi' only")
    if not 0.0 < omega < 2.0:
        raise ValueError(f"ssor needs 0 < omega < 2, got {omega}")
    nbr, nb, n = a.nbr, a.nb, a.shape[0]
    dev = a.device
    data_p = a.padded_data()                       # (nbr, max_blk, nb, nb)
    _, col_map, _ = a.ell_layout()
    cols = torch.from_numpy(col_map).to(dev).long()   # (nbr, max_blk)
    rows = torch.arange(nbr, device=dev)[:, None]
    bricks = _diag_bricks(a)
    lu, piv = torch.linalg.lu_factor(bricks)
    l_data = data_p * (cols < rows).to(data_p.dtype)[..., None, None]
    u_data = data_p * (cols > rows).to(data_p.dtype)[..., None, None]

    def sweep(tri, vb, forward: bool):
        """Solve (D + ω T) z = v block row by block row; T's bricks are
        pre-masked so not-yet-solved gathers contribute exact zeros."""
        z = vb.new_zeros((nbr, nb))
        for s in range(nbr):
            r = s if forward else nbr - 1 - s
            acc = torch.einsum("mij,mj->i", tri[r], z[cols[r]])
            rhs = (vb[r] - omega * acc)[:, None]
            z[r] = torch.linalg.lu_solve(lu[r], piv[r], rhs)[:, 0]
        return z

    def apply(v):
        vb = torch.nn.functional.pad(v, (0, a.n_pad - n)).reshape(nbr, nb)
        z = sweep(l_data, vb, True)                       # (D + ωL)⁻¹ v
        z = torch.einsum("rij,rj->ri", bricks, z)         # D ·
        z = sweep(u_data, z, False)                       # (D + ωU)⁻¹ ·
        return (omega * (2.0 - omega)) * z.reshape(a.n_pad)[:n]

    return Preconditioner("ssor", (), apply)


def make(spec, a: formats.SparseMatrix,
         block_size: int = 128) -> Preconditioner | None:
    """Sparse counterpart of :func:`repro_torch.core.precond.make` (same
    specs; ``block_size`` is ignored — block granularity is the brick
    size)."""
    del block_size
    if spec is None:
        return None
    if isinstance(spec, Preconditioner):
        return spec
    if callable(spec):
        return Preconditioner("custom", (), spec)
    if spec == "jacobi":
        return jacobi(a)
    if spec == "block_jacobi":
        return block_jacobi(a)
    if spec == "ssor":
        return ssor(a)
    raise ValueError(f"unknown preconditioner {spec!r}")
