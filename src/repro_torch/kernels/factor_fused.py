"""Fused factorization panel-update kernels: wrappers of
``csrc/factor_fused.cu``.

Port of :mod:`repro.kernels.factor_fused`'s ``lu_panel_update`` and
``cholesky_panel_update``: after the panel of a blocked LU / Cholesky step
is factored, one call solves the panel's off-diagonal block with the
pre-inverted diagonal block and applies the rank-nb update of the trailing
matrix.

Unlike the reference, which returns a new matrix, both work **in place** on
the (n, n) working matrix they are given and return it: the factorizations
of :mod:`repro_torch.core.lu` / :mod:`repro_torch.core.cholesky` pass their
own working copy, never the caller's matrix.  The step offset ``k`` is a
host integer, so the kernels cover only the active window.

Dispatch is by the tensors' device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`.  ``LAUNCHES`` counts the calls that
launched the kernel (the last step, with nothing right of the panel,
launches nothing).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"lu_panel_update": 0, "cholesky_panel_update": 0}

_LIB_NAME = "factor_fused"
_P = ctypes.c_void_p


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB_NAME)
    if not getattr(lib, "_declared", False):
        for fn in (lib.factor_lu_panel_update,
                   lib.factor_cholesky_panel_update):
            fn.argtypes = [_P, ctypes.c_int64, _P, ctypes.c_int64,
                           ctypes.c_int, _P, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.factor_lower_tile.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.factor_lower_tile.restype = None
        lib.factor_error_string.argtypes = [ctypes.c_int]
        lib.factor_error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


def lower_tile(b: int) -> tuple[int, int]:
    """The tile (i, j), i ≥ j, of the trailing block's 128 × 128 tiles
    that block ``b`` of the built symmetric update owns (the tests hold
    their emulation's map against it)."""
    lib = _lib()
    ti, tj = ctypes.c_int(), ctypes.c_int()
    lib.factor_lower_tile(b, ctypes.byref(ti), ctypes.byref(tj))
    return ti.value, tj.value


def _check(a: torch.Tensor, linv: torch.Tensor, k: int, nb: int) -> None:
    """(n, n) contiguous and (nb, nb) float32 tensors on one device, nb
    dividing n (the reference's tiling contract) and 0 ≤ k ≤ n − nb."""
    for name, t in (("a", a), ("linv", linv)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous (it is updated in place)")
    n = a.shape[0]
    if a.ndim != 2 or a.shape[1] != n or n == 0:
        raise ValueError(f"a must be a square (n, n) matrix, got "
                         f"{tuple(a.shape)}")
    if linv.device != a.device:
        raise ValueError(f"linv is on {linv.device}, a on {a.device}")
    if nb < 1 or n % nb:
        raise ValueError(f"n={n} not tiled by nb={nb}")
    if tuple(linv.shape) != (nb, nb):
        raise ValueError(f"linv must be ({nb}, {nb}), got "
                         f"{tuple(linv.shape)}")
    if not 0 <= k <= n - nb:
        raise ValueError(f"step offset k={k} outside [0, {n - nb}]")


def _launch(fn_name: str, a, linv, k: int, nb: int, scratch_rows: int):
    lib = _lib()
    n = a.shape[0]
    if not linv.mT.is_contiguous():    # the kernels read it column-major,
        linv = linv.mT.contiguous().mT  # as solve_triangular returns it
    scratch = torch.empty(scratch_rows * nb, dtype=torch.float32,
                          device=a.device)
    stream = _build.current_stream(a.device)
    err = getattr(lib, fn_name)(a.data_ptr(), n, linv.data_ptr(), k, nb,
                                scratch.data_ptr(), a.device.index, stream)
    _build.raise_on(err, lib.factor_error_string, fn_name)


def lu_panel_update(a: torch.Tensor, linv: torch.Tensor, k: int, *,
                    nb: int) -> torch.Tensor:
    """One fused LU step, in place: U12 = L11⁻¹·A12 into the panel row
    block (columns ≥ k + nb), then A22 −= L21·U12 (rows and columns
    ≥ k + nb).  ``a`` holds the pivoted, factored panel in columns
    [k, k + nb); ``linv`` is the inverse of its unit-lower diagonal
    block.  Returns ``a``."""
    _check(a, linv, k, nb)
    if not _build.on_cuda(a):
        return _ref.lu_panel_update(a, linv, k, nb=nb)
    m = a.shape[0] - k - nb
    if m:
        _launch("factor_lu_panel_update", a, linv, k, nb, m)
        LAUNCHES["lu_panel_update"] += 1
    return a


def cholesky_panel_update(a: torch.Tensor, linv: torch.Tensor, k: int, *,
                          nb: int) -> torch.Tensor:
    """One fused Cholesky step, in place: L21 = C·Lkk⁻ᵀ into the panel
    column block (rows ≥ k + nb), then A22 −= L21·L21ᵀ over the whole
    trailing block (the kernel computes the tiles on and below the
    diagonal and mirrors them; each tile reads its own A22).  ``a`` holds
    Lkk in its diagonal block at (k, k); ``linv`` is Lkk⁻¹.  Returns
    ``a``."""
    _check(a, linv, k, nb)
    if not _build.on_cuda(a):
        return _ref.cholesky_panel_update(a, linv, k, nb=nb)
    m = a.shape[0] - k - nb
    if m:
        _launch("factor_cholesky_panel_update", a, linv, k, nb, m)
        LAUNCHES["cholesky_panel_update"] += 1
    return a
