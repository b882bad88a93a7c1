"""QR trailing-update kernel: wrapper of ``csrc/qr_fused.cu``.

Port of :mod:`repro.kernels.qr_fused`'s ``qr_panel_update``: after the panel
of a blocked Householder QR step is factored, one call applies
A ← (I − V·Tᵀ·Vᵀ)·A to the columns ≥ k + nb.

Unlike the reference, which returns a new matrix, it works **in place** on
the (m, n) working matrix it is given and returns it; the factorization of
:mod:`repro_torch.core.qr` passes its own working copy.  ``k`` is a host
integer and the full V is zero above row k, so ``v`` is only its active
(m − k, nb) block, and only the window of rows [k, m) and columns
[k + nb, n) is read and written; the columns left of it are untouched, as
in the reference.

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

LAUNCHES = {"qr_panel_update": 0}

_LIB_NAME = "qr_fused"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    LAUNCHES["qr_panel_update"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB_NAME)
    if not getattr(lib, "_declared", False):
        lib.qr_panel_update.argtypes = [_P, _I64, _I64, _P, _P, _I64,
                                        ctypes.c_int, _P, _I64,
                                        ctypes.c_int, _P]
        lib.qr_panel_update.restype = ctypes.c_int
        lib.qr_workspace_floats.argtypes = [_I64, _I64, _I64, ctypes.c_int,
                                            ctypes.c_int]
        lib.qr_workspace_floats.restype = _I64
        lib.qr_plan_parts.argtypes = [_I64, _I64, _I64, ctypes.c_int,
                                      ctypes.c_int, _P, _P]
        lib.qr_plan_parts.restype = ctypes.c_int
        lib.qr_error_string.argtypes = [ctypes.c_int]
        lib.qr_error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


def _check(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor, k: int,
           nb: int) -> None:
    """(m, n) contiguous ``a`` with m ≥ n, (m − k, nb) ``v`` and (nb, nb)
    ``t``, float32, on one device; nb dividing n (the reference's tiling)
    and 0 ≤ k ≤ n − nb."""
    for name, x in (("a", a), ("v", v), ("t", t)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous (it is updated in place)")
    if a.ndim != 2 or a.shape[0] < a.shape[1] or a.numel() == 0:
        raise ValueError(f"a must be an (m, n) matrix with m >= n, got "
                         f"{tuple(a.shape)}")
    m, n = a.shape
    if nb < 1 or n % nb or tuple(t.shape) != (nb, nb):
        raise ValueError(f"shapes not tiled: a={tuple(a.shape)} "
                         f"t={tuple(t.shape)} nb={nb}")
    if not 0 <= k <= n - nb:
        raise ValueError(f"step offset k={k} outside [0, {n - nb}]")
    if tuple(v.shape) != (m - k, nb):
        raise ValueError(f"v must be the ({m - k}, {nb}) active block at "
                         f"k={k}, got {tuple(v.shape)}")


def plan_parts(m: int, n: int, k: int, nb: int,
               device: torch.device) -> tuple[int, int]:
    """The parts that hold a sum in the kernel's update at step ``k`` on the
    CUDA ``device``: W = VᵀA's (its depth R = m − k split by the card's SM
    count) and A −= V·Y's (its depth nb split); (0, 0) at the last step."""
    lib = _lib()
    w, u = ctypes.c_int(), ctypes.c_int()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    err = lib.qr_plan_parts(m, n, k, nb, index, ctypes.byref(w),
                            ctypes.byref(u))
    _build.raise_on(err, lib.qr_error_string, "qr_plan_parts")
    return w.value, u.value


def qr_panel_update(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                    k: int, *, nb: int) -> torch.Tensor:
    """One QR trailing update, in place: A ← A − V·(Tᵀ·(Vᵀ·A)) on rows
    [k, m) and columns [k + nb, n).  ``v`` is the (m − k, nb) active
    Householder block (unit diagonal at row j), ``t`` its compact-WY
    triangle.  Returns ``a``."""
    _check(a, v, t, k, nb)
    if not _build.on_cuda(a):
        return _ref.qr_panel_update(a, v, t, k, nb=nb)
    m, n = a.shape
    cols = n - k - nb
    if cols == 0:
        return a
    lib = _lib()
    dev = a.device
    floats = lib.qr_workspace_floats(m, n, k, nb, dev.index)
    if floats < 0:
        raise RuntimeError("qr_panel_update: no workspace size (a CUDA "
                           "error, or more rows than the grid takes)")
    v, t = v.contiguous(), t.contiguous()
    ws = torch.empty(floats, dtype=a.dtype, device=dev)
    err = lib.qr_panel_update(a.data_ptr(), m, n, v.data_ptr(), t.data_ptr(),
                              k, nb, ws.data_ptr(), floats, dev.index,
                              _build.current_stream(dev))
    _build.raise_on(err, lib.qr_error_string, "qr_panel_update")
    LAUNCHES["qr_panel_update"] += 1
    return a
