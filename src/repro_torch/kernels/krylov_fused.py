"""Fused Krylov vector kernels: wrappers of ``csrc/krylov_fused.cu``.

Port of :mod:`repro.kernels.krylov_fused`'s ``fused_cg_update``,
``fused_pipelined_dots`` and ``fused_gram`` (their ``_auto`` forms: any
``n``, and any ``k`` for the Gram matrix).  A CG step's x += αp; r −= αAp;
⟨r,r⟩ is one pass over four vectors in place of three separate passes,
pipelined CG's three inner products share one read, and the s-step
methods' Gram matrix V·Vᵀ of a (k, n) row-stack is one read of V.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.ref`.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"fused_cg_update": 0, "fused_pipelined_dots": 0,
            "fused_gram": 0}

_LIB_NAME = "krylov_fused"
_P = ctypes.c_void_p


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB_NAME)
    if not getattr(lib, "_declared", False):
        lib.krylov_fused_cg_update.argtypes = [_P] * 9 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P]
        lib.krylov_fused_cg_update.restype = ctypes.c_int
        lib.krylov_fused_pipelined_dots.argtypes = [_P] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P]
        lib.krylov_fused_pipelined_dots.restype = ctypes.c_int
        lib.krylov_fused_gram.argtypes = [_P] * 4 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P]
        lib.krylov_fused_gram.restype = ctypes.c_int
        for fn in ("krylov_gram_blocks", "krylov_gram_stream_blocks"):
            getattr(lib, fn).argtypes = [ctypes.c_int, ctypes.c_int64]
            getattr(lib, fn).restype = ctypes.c_int
        lib.krylov_gram_work_floats.restype = ctypes.c_int64
        lib.krylov_error_string.argtypes = [ctypes.c_int]
        lib.krylov_error_string.restype = ctypes.c_char_p
        for fn in ("krylov_threads", "krylov_max_blocks",
                   "krylov_gram_stream_max_k"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.threads, lib.max_blocks = (lib.krylov_threads(),
                                       lib.krylov_max_blocks())
        lib.gram_stream_max_k = lib.krylov_gram_stream_max_k()
        lib._declared = True
    return lib


# One workspace a stream for the one-launch reductions (kernel 1, and
# kernel 3 for k <= 16): the ticket by which the last block of a launch
# finds itself (it sets the ticket back to 0) and the blocks' partials.
# Calls on one stream run in order, so they share it; calls on two streams
# have one each and may run at the same time.  Keys are (device index, raw
# stream handle); torch hands out streams from a fixed pool a device, so the
# table stays small.
_WORK: dict[tuple[int, int], torch.Tensor] = {}


def _work(lib, device: torch.device, stream: int) -> torch.Tensor:
    work = _WORK.get((device.index, stream))
    if work is None:
        work = _WORK[device.index, stream] = torch.zeros(
            lib.krylov_gram_work_floats(), dtype=torch.float32,
            device=device)
    return work


def _blocks(lib, n: int) -> int:
    """Grid size: one thread per element up to the partials buffer's size
    (a function of n alone, so reruns reduce in the same order)."""
    return min(-(-n // lib.threads), lib.max_blocks)


_F32 = torch.float32


def _check_vectors(names: str, *vs) -> None:
    """Same device, float32, 1-D, equal nonzero lengths, contiguous.  A set
    that passes is recognised in a few attribute reads (a small kernel's
    call is host-bound); only a set that fails is walked for its error."""
    v0 = vs[0]
    if isinstance(v0, torch.Tensor) and v0.dim() == 1 and v0.shape[0] > 0 \
            and all(isinstance(v, torch.Tensor) and v.dtype is _F32
                    and v.shape == v0.shape and v.device == v0.device
                    and v.is_contiguous() for v in vs):
        return
    names = names.split()
    for name, v in zip(names, vs):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(v)}")
    dev, n = vs[0].device, vs[0].shape[0] if vs[0].ndim == 1 else -1
    for name, v in zip(names, vs):
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, {names[0]} on {dev}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
        if v.ndim != 1 or v.shape[0] != n or n == 0:
            raise ValueError(f"{name} must be 1-D of the same nonzero length "
                             f"as {names[0]}; got shape {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_cg_update(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                    ap: torch.Tensor, alpha):
    """``(x + αp, r − αAp, ⟨r', r'⟩)`` in one pass.  On CUDA, ``alpha`` is a
    0-d float32 tensor on the same device (the kernel reads it from device
    memory); ``rr`` comes back as a 0-d tensor.  One launch a call, on the
    current stream's workspace; the wrapper allocates only what it
    returns."""
    _check_vectors("x r p ap", x, r, p, ap)
    if not _build.on_cuda(x):
        return _ref.fused_cg_update(x, r, p, ap, alpha)
    dev = x.device
    if not (isinstance(alpha, torch.Tensor) and alpha.ndim == 0
            and alpha.dtype is _F32 and alpha.device == dev):
        raise TypeError("alpha must be a 0-d float32 tensor on "
                        f"{x.device}, got {alpha!r}")
    lib = _lib()
    n = x.shape[0]
    xo, ro = torch.empty_like(x), torch.empty_like(r)
    rr = torch.empty_like(alpha)
    stream = _build.current_stream(dev)
    err = lib.krylov_fused_cg_update(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
        alpha.data_ptr(), xo.data_ptr(), ro.data_ptr(),
        _work(lib, dev, stream).data_ptr(), rr.data_ptr(), n,
        _blocks(lib, n), dev.index, stream)
    _build.raise_on(err, lib.krylov_error_string, "fused_cg_update")
    LAUNCHES["fused_cg_update"] += 1
    return xo, ro, rr


def fused_pipelined_dots(r: torch.Tensor, u: torch.Tensor, w: torch.Tensor):
    """``(⟨r,u⟩, ⟨w,u⟩, ⟨r,r⟩)`` in one read of three vectors, as three 0-d
    float32 tensors."""
    _check_vectors("r u w", r, u, w)
    if not _build.on_cuda(r):
        return _ref.fused_pipelined_dots(r, u, w)
    lib = _lib()
    n = r.shape[0]
    blocks = _blocks(lib, n)
    partials = torch.empty(3 * blocks, dtype=torch.float32, device=r.device)
    out = torch.empty(3, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.krylov_fused_pipelined_dots(
        r.data_ptr(), u.data_ptr(), w.data_ptr(), partials.data_ptr(),
        out.data_ptr(), n, blocks, r.device.index, stream)
    _build.raise_on(err, lib.krylov_error_string, "fused_pipelined_dots")
    LAUNCHES["fused_pipelined_dots"] += 1
    return out[0], out[1], out[2]


def fused_gram(v: torch.Tensor) -> torch.Tensor:
    """G = V·Vᵀ of a contiguous (k, n) float32 row-stack in one read of V,
    as a (k, k) float32 tensor on V's device (exactly symmetric on CUDA:
    one launch for k ≤ 16, on the current stream's workspace; two for
    a larger k)."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"v must be a tensor, got {type(v)}")
    if v.dtype != torch.float32:
        raise TypeError(f"v must be float32, got {v.dtype}")
    if v.ndim != 2 or v.shape[0] == 0 or v.shape[1] == 0:
        raise ValueError(f"v must be a nonempty (k, n) row-stack; got shape "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    if not _build.on_cuda(v):
        return _ref.fused_gram(v)
    lib = _lib()
    k, n = v.shape
    dev = v.device
    g = torch.empty((k, k), dtype=torch.float32, device=dev)
    partials = None if k <= lib.gram_stream_max_k else torch.empty(
        lib.krylov_gram_blocks(k, n) * k * k, dtype=torch.float32,
        device=dev)
    stream = _build.current_stream(dev)
    err = lib.krylov_fused_gram(
        v.data_ptr(), _work(lib, dev, stream).data_ptr(),
        None if partials is None else partials.data_ptr(), g.data_ptr(), k,
        n, dev.index, stream)
    _build.raise_on(err, lib.krylov_error_string, "fused_gram")
    LAUNCHES["fused_gram"] += 1
    return g
