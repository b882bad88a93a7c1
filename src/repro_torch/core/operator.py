"""LinearOperator layer (port of :mod:`repro.core.operator`, single device).

Every Krylov solver in :mod:`repro_torch.core.krylov` is written once
against the primitive set

* ``matvec`` / ``matvec_t`` — y = A x and y = Aᵀ x,
* ``dot`` / ``dots`` / ``dotm`` — inner products (``dots`` may fuse several),
* ``update`` — the fused x += αp; r −= αAp; ⟨r,r⟩ pass,
* ``axpy_pair`` — least squares' paired (x + αp, r − αq),
* ``pipelined_dots`` — pipelined CG's single fused reduction,
* ``block_dots`` — the Gram matrix of a (k, n) row-stack in one reduction
  (the s-step methods' one reduction per outer step),
* ``scale`` / ``norm`` — helpers.

:class:`DenseOperator` with ``backend="cuda"`` sends ``update``,
``pipelined_dots`` and ``block_dots`` of float32 vectors, and ``axpy_pair``
when both pairs have one shape, through the hand-written kernels of
:mod:`repro_torch.kernels.krylov_fused`.  Its matvecs are plain products,
as in the reference, where they were left to XLA.  The sparse engine
(:mod:`repro_torch.sparse.operator`) subclasses it and sends its matvecs
through the BSR SpMV kernel.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import blocking
from repro_torch.kernels import ops


class LinearOperator:
    """Primitive set shared by all engines."""

    has_transpose = False

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matvec_t(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no Aᵀx")

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def dots(self, pairs: Sequence[tuple[torch.Tensor, torch.Tensor]]):
        """Several inner products; engines override to use ONE reduction."""
        return tuple(self.dot(u, v) for u, v in pairs)

    def dotm(self, m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Stacked dots ``m @ w`` for a (k, n) row-stack m (GMRES Gram)."""
        raise NotImplementedError

    def block_dots(self, vs: torch.Tensor) -> torch.Tensor:
        """Gram matrix G = V Vᴴ of a (k, n) row-stack — all k² basis inner
        products in one reduction, in place of the ~2s dot products of s
        classical Krylov iterations."""
        return vs.conj() @ vs.T

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(v, v))

    def scale(self, s, v: torch.Tensor) -> torch.Tensor:
        return s * v

    def update(self, x, r, p, ap, alpha):
        """Fused Krylov update: (x + αp, r − αAp, ⟨r', r'⟩)."""
        xn = x + self.scale(alpha, p)
        rn = r - self.scale(alpha, ap)
        return xn, rn, self.dot(rn, rn)

    def axpy_pair(self, x, p, r, q, alpha):
        """(x + αp, r − αq) — the paired axpys of CGLS.  ``x``/``p`` live in
        the solution space and ``r``/``q`` in the residual space, so the
        pairs may differ in length; engines fuse the pass when both have
        one length."""
        return x + self.scale(alpha, p), r - self.scale(alpha, q)

    def pipelined_dots(self, r, u, w):
        """(⟨r,u⟩, ⟨w,u⟩, ⟨r,r⟩) — pipelined CG's single reduction."""
        return self.dots(((r, u), (w, u), (r, r)))


class DenseOperator(LinearOperator):
    """A dense matrix on one device.  ``backend="cuda"`` fuses the update,
    the pipelined reduction and the Gram matrix into single passes (float32
    only; other dtypes use the plain path, see
    :func:`blocking.effective_backend`)."""

    has_transpose = True

    def __init__(self, a: torch.Tensor | None = None, *,
                 matvec: Callable | None = None,
                 matvec_t: Callable | None = None,
                 backend: str = "ref"):
        blocking.check_backend_name(backend)
        if a is None and matvec is None:
            raise ValueError("need a matrix or a matvec callable")
        self.a = a
        self._matvec = matvec
        self._matvec_t = matvec_t
        self.backend = backend
        if a is None and matvec_t is None:
            self.has_transpose = False

    def matvec(self, v):
        return self._matvec(v) if self._matvec is not None else self.a @ v

    def matvec_t(self, v):
        if self._matvec_t is not None:
            return self._matvec_t(v)
        if self.a is None:
            return super().matvec_t(v)
        return self.a.T @ v

    def dot(self, u, v):
        return torch.vdot(u, v)

    def dotm(self, m, w):
        return m @ w

    def _fusable(self, v):
        return blocking.effective_backend(self.backend, v.dtype) == "cuda"

    def update(self, x, r, p, ap, alpha):
        if self._fusable(x):
            return ops.fused_cg_update(x, r, p, ap, alpha)
        return super().update(x, r, p, ap, alpha)

    def pipelined_dots(self, r, u, w):
        if self._fusable(r):
            return ops.fused_pipelined_dots(r, u, w)
        return super().pipelined_dots(r, u, w)

    def block_dots(self, vs):
        if self._fusable(vs):
            return ops.fused_gram(vs)
        return super().block_dots(vs)

    def axpy_pair(self, x, p, r, q, alpha):
        # one fused pass when both pairs share a shape (square systems);
        # a rectangular system takes the two plain axpys
        if self._fusable(x) and x.shape == r.shape:
            xn, rn, _ = ops.fused_cg_update(x, r, p, q, alpha)
            return xn, rn
        return super().axpy_pair(x, p, r, q, alpha)


def as_operator(op, *, matvec_t: Callable | None = None) -> LinearOperator:
    """Adapt a bare matvec callable into the operator interface; pass
    operators through unchanged."""
    if isinstance(op, LinearOperator):
        return op
    if callable(op):
        return DenseOperator(matvec=op, matvec_t=matvec_t)
    raise TypeError(f"expected LinearOperator or callable, got {type(op)}")


def make_operator(a, *, mesh=None, backend: str = "ref") -> LinearOperator:
    """The engine for ``a``: a sparse matrix → :class:`~repro_torch.sparse
    .operator.SparseOperator`, a dense (m, n) tensor →
    :class:`DenseOperator`.  Distributed (``mesh=``) and batched (B, n, n)
    engines are not ported yet and raise."""
    if getattr(a, "is_sparse", False):
        if mesh is not None:
            raise ValueError("distributed sparse solves are block-row SPMD "
                             "— use engine='spmd' (sparse.operator"
                             ".spmd_solve), not a gspmd operator; the port "
                             "has no engine='spmd' yet")
        from repro_torch.sparse.operator import SparseOperator
        return SparseOperator(a, backend=backend)
    if mesh is not None:
        raise ValueError("distributed engines (mesh=) are not ported yet; "
                         "drop mesh= for the single-device engine")
    if a.ndim != 2:
        raise ValueError(f"only dense (m, n) systems are ported; got shape "
                         f"{tuple(a.shape)} (batched and sparse engines are "
                         "not ported yet)")
    return DenseOperator(a, backend=backend)
