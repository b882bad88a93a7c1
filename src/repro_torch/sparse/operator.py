"""Sparse single-device engine (port of :class:`repro.sparse.operator
.SparseOperator`).

:class:`SparseOperator` implements the full ``LinearOperator`` primitive
set over a :class:`~repro_torch.sparse.formats.BSR` or
:class:`~repro_torch.sparse.formats.ELL` matrix, so every registered
Krylov method (cg, pipelined_cg, bicg, bicgstab, gmres, ca_cg, ca_gmres)
runs on a sparse A unchanged.  ``backend="cuda"`` sends every matvec
through the hand-written BSR SpMV kernel (:mod:`repro_torch.kernels.spmv`),
float32 and float64 alike — the SpMV keeps float64, unlike the Krylov
vector kernels — and inherits the dense engine's fused update,
pipelined-reduction and Gram kernels (float32 only).

The reference's block-row-sharded ``SparseSpmdLocalOperator`` and
``spmd_solve`` are not ported yet (the distributed slice of the port).
"""
from __future__ import annotations

from repro_torch.core.operator import DenseOperator
from repro_torch.kernels import ops
from repro_torch.sparse import formats


class SparseOperator(DenseOperator):
    """Single-device sparse engine.  Reuses the dense engine's reductions
    and fused update kernels; only the mat-vec changes.  ``backend="cuda"``
    needs BSR (the kernel's brick layout); ELL runs the plain path."""

    has_transpose = True

    def __init__(self, a: formats.SparseMatrix, *, backend: str = "ref"):
        if not getattr(a, "is_sparse", False):
            raise TypeError(f"expected a sparse matrix, got {type(a)}")
        if backend == "cuda" and not isinstance(a, formats.BSR):
            raise ValueError("backend='cuda' SpMV is BSR-only — convert "
                             "with BSR.from_dense or use backend='ref'")
        super().__init__(matvec=self._mv, matvec_t=self._mvt,
                         backend=backend)
        self.sparse = a
        self._a_t = None        # transposed BSR, built at the first Aᵀx

    def _mv(self, v):
        if self.backend == "cuda":
            return ops.bsr_matvec(self.sparse, v)
        return self.sparse.matvec(v)

    def _mvt(self, v):
        if self.backend == "cuda":
            # built once, on the device, only by a method that calls Aᵀx
            if self._a_t is None:
                self._a_t = self.sparse.transpose()
            return ops.bsr_matvec(self._a_t, v)
        return self.sparse.matvec_t(v)
