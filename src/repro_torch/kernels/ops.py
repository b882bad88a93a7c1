"""Public dispatch for the kernels (port of :mod:`repro.kernels.ops` for the
ported kernels).

The wrappers decide by the tensors' device alone: a CUDA tensor launches
the hand-written kernel or raises, a CPU tensor runs the plain version
(:mod:`repro_torch.kernels.ref`).  Callers never know which executed the
math.  ``use_kernel=False`` on the Krylov updates runs the plain version on
any device.
"""
from __future__ import annotations

from repro_torch.kernels import attention as _attention
from repro_torch.kernels import factor_fused as _factor_fused
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import krylov_fused as _krylov_fused
from repro_torch.kernels import qr_fused as _qr_fused
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import spmv as _spmv
from repro_torch.kernels import trsm as _trsm


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Softmax attention, (B, Hq, Tq, D) over (B, Hkv, Tk, D); see
    :func:`attention.flash_attention`."""
    return _attention.flash_attention(q, k, v, causal=causal, window=window)


def fused_cg_update(x, r, p, ap, alpha, *, use_kernel: bool = True):
    if not use_kernel:
        return _ref.fused_cg_update(x, r, p, ap, alpha)
    return _krylov_fused.fused_cg_update(x, r, p, ap, alpha)


def fused_pipelined_dots(r, u, w, *, use_kernel: bool = True):
    if not use_kernel:
        return _ref.fused_pipelined_dots(r, u, w)
    return _krylov_fused.fused_pipelined_dots(r, u, w)


def fused_gram(v):
    """The (k, k) Gram matrix V·Vᵀ; see :func:`krylov_fused.fused_gram`."""
    return _krylov_fused.fused_gram(v)


def lu_panel_update(a, linv, k: int, *, nb: int):
    """In place on ``a``; see :func:`factor_fused.lu_panel_update`."""
    return _factor_fused.lu_panel_update(a, linv, k, nb=nb)


def cholesky_panel_update(a, linv, k: int, *, nb: int):
    """In place on ``a``; see :func:`factor_fused.cholesky_panel_update`."""
    return _factor_fused.cholesky_panel_update(a, linv, k, nb=nb)


def matmul(a, b):
    """C = A @ B in float32; see :func:`gemm.matmul`."""
    return _gemm.matmul(a, b)


def qr_panel_update(a, v, t, k: int, *, nb: int):
    """In place on ``a``; see :func:`qr_fused.qr_panel_update`."""
    return _qr_fused.qr_panel_update(a, v, t, k, nb=nb)


def trsm_lower(l, b, *, unit_diagonal: bool = False):
    return _trsm.trsm_lower(l, b, unit_diagonal=unit_diagonal)


def trsm_upper(u, b, *, unit_diagonal: bool = False):
    return _trsm.trsm_upper(u, b, unit_diagonal=unit_diagonal)


def bsr_matvec(bsr, x):
    """y = A x for a BSR ``bsr``; see :func:`spmv.bsr_matvec`."""
    return _spmv.bsr_matvec(bsr, x)
