"""BSR sparse matrix–vector (and –matrix) product: wrapper of ``csrc/spmv.cu``.

Port of :mod:`repro.kernels.spmv`'s ``bsr_spmm`` / ``bsr_matvec``: Y = A·X
over the ``nb × nb`` bricks of a :class:`~repro_torch.sparse.formats.BSR`,
for X of shape (n,) or (n, k), any ``nb``, square or rectangular A,
float32 (float32 accumulation) or float64 (float64 accumulation).  The
kernel reads the BSR's device copies of its structure (``indices_dev``,
``indptr_dev``), made once with the matrix.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`.  ``LAUNCHES["bsr_matvec"]`` counts the
kernel's launches, so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"bsr_matvec": 0}

_LIB_NAME = "spmv"
_P = ctypes.c_void_p
_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    LAUNCHES["bsr_matvec"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB_NAME)
    if not getattr(lib, "_declared", False):
        lib.spmv_bsr.argtypes = [_P] * 5 + [ctypes.c_int] * 5 + [_P]
        lib.spmv_bsr.restype = ctypes.c_int
        lib.spmv_error_string.argtypes = [ctypes.c_int]
        lib.spmv_error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


def bsr_matvec(bsr, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a BSR ``bsr`` and x of shape (n,) or (n, k) on the
    matrix's device; y is (m,) or (m, k) in the matrix's dtype."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a tensor, got {type(x)}")
    if x.device != bsr.data.device:
        raise ValueError(f"x is on {x.device}, the matrix on "
                         f"{bsr.data.device}")
    if not _build.on_cuda(bsr.data):
        return _ref.bsr_matvec(bsr, x)
    if bsr.dtype not in _DTYPES or x.dtype != bsr.dtype:
        raise TypeError(f"the SpMV kernel takes float32 or float64 with x "
                        f"of the matrix's dtype; got {bsr.dtype} and "
                        f"{x.dtype}")
    n = bsr.shape[1]
    if x.ndim not in (1, 2) or x.shape[0] != n or x.numel() == 0:
        raise ValueError(f"x must be ({n},) or ({n}, k) with k ≥ 1, got "
                         f"{tuple(x.shape)}")
    k = 1 if x.ndim == 1 else x.shape[1]
    xk = x.reshape(n, k)
    if bsr.n_pad_cols != n:
        xk = F.pad(xk, (0, 0, 0, bsr.n_pad_cols - n))
    xk = xk.contiguous()
    y = torch.empty((bsr.n_pad, k), dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.spmv_bsr(bsr.data.data_ptr(), bsr.indices_dev.data_ptr(),
                       bsr.indptr_dev.data_ptr(), xk.data_ptr(),
                       y.data_ptr(), bsr.nbr, bsr.nb, k,
                       int(x.dtype == torch.float64), x.device.index, stream)
    _build.raise_on(err, lib.spmv_error_string, "bsr_matvec")
    LAUNCHES["bsr_matvec"] += 1
    y = y[:bsr.shape[0]]
    return y[:, 0] if x.ndim == 1 else y
