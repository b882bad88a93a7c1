"""Tiled matrix product kernel: wrapper of ``csrc/gemm.cu``.

Port of :mod:`repro.kernels.gemm`'s ``matmul``: C = A @ B in float32 with
float32 accumulation.  It serves the unfused (``fuse_panel=False``) routes
of the LU, Cholesky and QR factorizations.

Shape contract.  Unlike the reference, which raises ``ValueError`` unless
M, N and K are multiples of its tiles, the kernel takes any (M, K) @ (K, N)
and masks the ragged edges.  ``a`` and ``b`` may be strided views (a
transpose, a block of a larger matrix); they are read in place.  C is a new
contiguous (M, N) tensor.  An empty M or N gives an empty C and an empty K
a zero C, with no launch.

Dispatch is by the tensors' device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`.  Either way the inputs must be float32
(``TypeError`` otherwise).  ``LAUNCHES["matmul"]`` counts the products
that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"matmul": 0}

_LIB_NAME = "gemm"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    LAUNCHES["matmul"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB_NAME)
    if not getattr(lib, "_declared", False):
        lib.gemm_matmul.argtypes = [_P, _I64, _I64, _P, _I64, _I64, _P, _I64,
                                    _I64, _I64, _P, ctypes.c_int,
                                    ctypes.c_int, _P]
        lib.gemm_matmul.restype = ctypes.c_int
        lib.gemm_splits.argtypes = [_I64, _I64, _I64, ctypes.c_int]
        lib.gemm_splits.restype = ctypes.c_int
        lib.gemm_error_string.argtypes = [ctypes.c_int]
        lib.gemm_error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D matrix, got shape "
                             f"{tuple(t.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for float32 (M, K) ``a`` and (K, N) ``b``, any shapes."""
    _check(a, b)
    if not _build.on_cuda(a):
        return _ref.matmul(a, b)
    (m, k), n = a.shape, b.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros(m, n, dtype=a.dtype, device=a.device)
    lib = _lib()
    dev = a.device
    c = torch.empty(m, n, dtype=a.dtype, device=dev)
    splits = lib.gemm_splits(m, n, k, dev.index)
    if splits < 1:
        raise RuntimeError("matmul: the device's SM count could not be read")
    scratch = torch.empty(splits * m * n, dtype=a.dtype, device=dev) \
        if splits > 1 else None
    err = lib.gemm_matmul(a.data_ptr(), *a.stride(), b.data_ptr(),
                          *b.stride(), c.data_ptr(), m, n, k,
                          None if scratch is None else scratch.data_ptr(),
                          splits, dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, lib.gemm_error_string, "matmul")
    LAUNCHES["matmul"] += 1
    return c
