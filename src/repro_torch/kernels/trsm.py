"""Blocked triangular solve kernel: wrappers of ``csrc/trsm.cu``.

Port of :mod:`repro.kernels.trsm`'s ``trsm_lower`` / ``trsm_upper`` and
their ``_auto`` forms: X with T X = B for a triangular (n, n) ``T``, any n,
any number of right-hand-side columns and a 1-D ``b``.  As in the
reference, the diagonal sub-blocks are inverted outside the kernel, here by
one batched ``torch.linalg.solve_triangular`` (:func:`diag_inverses`); the
kernel then runs the blocked substitution with those inverses, the whole
solve in one launch (:func:`substitute`).

``T`` is either C-contiguous or the transpose of a C-contiguous matrix
(``l.T``, as in Cholesky's second solve); the kernel reads both layouts in
place, and an upper triangle by index reversal, so no copy of ``T`` is made.

Dispatch is by the tensors' device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`.  ``LAUNCHES["trsm"]`` counts the solves
that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"trsm": 0}
BLOCK_ROWS = 128     # the kernel's block rows: the inverted blocks' size

_LIB_NAME = "trsm"
_P = ctypes.c_void_p


def reset_launches() -> None:
    LAUNCHES["trsm"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB_NAME)
    if not getattr(lib, "_declared", False):
        lib.trsm_solve.argtypes = [_P, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                   ctypes.c_int, _P, ctypes.c_int, _P]
        lib.trsm_solve.restype = ctypes.c_int
        lib.trsm_error_string.argtypes = [ctypes.c_int]
        lib.trsm_error_string.restype = ctypes.c_char_p
        lib.trsm_block_rows.restype = ctypes.c_int
        lib.trsm_workspace_ints.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.trsm_workspace_ints.restype = ctypes.c_int64
        if lib.trsm_block_rows() != BLOCK_ROWS:
            raise RuntimeError(f"csrc/trsm.cu solves blocks of "
                               f"{lib.trsm_block_rows()} rows, the wrapper "
                               f"inverts blocks of {BLOCK_ROWS}")
        lib._declared = True
    return lib


def _check(t: torch.Tensor, b: torch.Tensor) -> None:
    for name, v in (("t", t), ("b", b)):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(v)}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
    n = t.shape[0]
    if t.ndim != 2 or t.shape[1] != n or n == 0:
        raise ValueError(f"the triangle must be a square (n, n) matrix, got "
                         f"{tuple(t.shape)}")
    if b.device != t.device:
        raise ValueError(f"b is on {b.device}, the triangle on {t.device}")
    if b.ndim not in (1, 2) or b.shape[0] != n or b.numel() == 0:
        raise ValueError(f"b must be ({n},) or ({n}, m) with m ≥ 1, got "
                         f"{tuple(b.shape)}")
    if not (t.is_contiguous() or t.T.is_contiguous()):
        raise ValueError("the triangle must be contiguous or the transpose "
                         "of a contiguous matrix")


def diag_inverses(t: torch.Tensor, *, rev: bool,
                  unit_diagonal: bool) -> torch.Tensor:
    """(ceil(n/128), 128, 128) inverses of the diagonal blocks of the
    logical lower triangle L' of ``t`` (L'[p, q] = t[n−1−p, n−1−q] when
    ``rev``); the last block is padded with the identity.  Plain PyTorch
    on any device."""
    sb = BLOCK_ROWS
    n = t.shape[0]
    nblk = -(-n // sb)
    idx = torch.arange(nblk * sb, device=t.device)
    valid = (idx < n).view(nblk, sb)
    rows = ((n - 1 - idx) if rev else idx).clamp(0, n - 1).view(nblk, sb)
    d = t[rows[:, :, None], rows[:, None, :]]
    eye = torch.eye(sb, dtype=t.dtype, device=t.device)
    d = torch.where(valid[:, :, None] & valid[:, None, :], d, eye)
    return torch.linalg.solve_triangular(
        d, eye.expand(nblk, sb, sb), upper=False,
        unitriangular=unit_diagonal).contiguous()


def substitute(t: torch.Tensor, b: torch.Tensor, linv: torch.Tensor, *,
               rev: bool) -> torch.Tensor:
    """The kernel's launch: X with L' X = B given ``linv`` from
    :func:`diag_inverses` (CUDA tensors, shapes checked by the callers)."""
    if not _build.on_cuda(t):
        raise ValueError("substitute launches the CUDA kernel: the "
                         "triangle must be a CUDA tensor")
    lib = _lib()
    n = t.shape[0]
    trans = not t.is_contiguous()
    stored = t.T if trans else t               # C-contiguous storage
    rhs = b.reshape(n, -1).contiguous()        # read only
    x = torch.empty_like(rhs)
    work = torch.zeros(lib.trsm_workspace_ints(n, rhs.shape[1]),
                       dtype=torch.int32, device=t.device)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    err = lib.trsm_solve(stored.data_ptr(), n, n, int(rev), int(trans),
                         linv.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                         rhs.shape[1], work.data_ptr(), t.device.index, stream)
    _build.raise_on(err, lib.trsm_error_string, "trsm")
    LAUNCHES["trsm"] += 1
    return x.reshape(b.shape)


def _solve(t: torch.Tensor, b: torch.Tensor, *, rev: bool,
           unit_diagonal: bool) -> torch.Tensor:
    linv = diag_inverses(t, rev=rev, unit_diagonal=unit_diagonal)
    return substitute(t, b, linv, rev=rev)


def trsm_lower(l: torch.Tensor, b: torch.Tensor, *,
               unit_diagonal: bool = False) -> torch.Tensor:
    """X with L X = B, L the lower triangle of ``l`` (the strict lower
    triangle and a unit diagonal when ``unit_diagonal``)."""
    _check(l, b)
    if not _build.on_cuda(l):
        return _ref.trsm_lower(l, b, unit_diagonal=unit_diagonal)
    return _solve(l, b, rev=False, unit_diagonal=unit_diagonal)


def trsm_upper(u: torch.Tensor, b: torch.Tensor, *,
               unit_diagonal: bool = False) -> torch.Tensor:
    """X with U X = B, U the upper triangle of ``u``: the lower kernel under
    index reversal, (J U J)(J X) = J B, read in place."""
    _check(u, b)
    if not _build.on_cuda(u):
        return _ref.trsm_upper(u, b, unit_diagonal=unit_diagonal)
    return _solve(u, b, rev=True, unit_diagonal=unit_diagonal)
