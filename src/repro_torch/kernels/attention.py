"""Flash-attention forward kernels: wrapper of ``csrc/attention_wgmma.cu``
(bfloat16 and float16, on the tensor cores) and ``csrc/attention.cu``
(float32).

Port of :mod:`repro.kernels.attention`'s ``flash_attention``: grouped-query
softmax attention with an online softmax, causal masking with the query
ends aligned to the key ends, an optional sliding window.  q is
(B, Hq, Tq, D), k and v (B, Hkv, Tk, D) with Hq % Hkv == 0; the output is a
new contiguous (B, Hq, Tq, D) tensor in q's dtype, computed in float32.

Contract, the reference's: Tq and Tk are tiled by min(128, T)
(``ValueError`` otherwise).  Added here: D ≤ 256 (``ValueError``), dtypes
bfloat16, float16 and float32 (``TypeError``), and inputs that need no
gradient (``ValueError``: the kernel has no backward, and a gradient may not
come back silently wrong).  q, k and v may be strided views, such as the
head-transposed projections of the attention layer: the kernel reads their
strides and copies nothing.

Rows with no visible key (causal with Tq > Tk) follow the reference kernel,
not its plain version: a masked score is the finite −1e30, so such a row
returns the mean of the values in the reference's live tiles, or 0 where
every tile is skipped.  The plain version
(:func:`repro_torch.kernels.ref.attention`, as the reference's
``ref.attention``) masks with −inf and returns NaN there.
On the serving path (Tq ≤ Tk, causal) every row sees at least itself.

Dispatch is by the tensors' device, then by dtype alone: a CPU tensor takes
the plain version; a CUDA tensor launches a kernel (or raises), the
tensor-core kernel for bfloat16 and float16, the float32 kernel for
float32.  ``LAUNCHES["flash_attention"]`` counts every launch,
``LAUNCHES["flash_attention_wgmma"]`` and ``LAUNCHES["flash_attention_f32"]``
those of each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_f32": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.c_int64 * 4
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the kernel of each dtype: its library (and C prefix), its counter
_KERNELS = {torch.float32: ("attention", "flash_attention_f32"),
            torch.float16: ("attention_wgmma", "flash_attention_wgmma"),
            torch.bfloat16: ("attention_wgmma", "flash_attention_wgmma")}
MAX_HEAD_DIM = 256
TILE = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    if not getattr(lib, "_declared", False):
        forward = getattr(lib, f"{name}_forward")
        forward.argtypes = [
            _I, _P, _STRIDES, _P, _STRIDES, _P, _STRIDES, _P,
            _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I,
            _P]
        forward.restype = _I
        error_string = getattr(lib, f"{name}_error_string")
        error_string.argtypes = [_I]
        error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> tuple[int, int]:
    """The reference's tiles (bq, bk) after checking the contract."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be bfloat16, float16 or float32, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, H, T, D), got shape "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but flash_attention "
                             "has no backward; run it under "
                             "torch.inference_mode() or detach the inputs")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}")
    bq, bk = min(TILE, tq), min(TILE, tk)
    if tq % bq or tk % bk:
        raise ValueError(f"seq lens {(tq, tk)} not tiled by {(bq, bk)}")
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention of q (B, Hq, Tq, D) over k, v (B, Hkv, Tk, D);
    ``window`` counts the visible past positions, self included."""
    bq, bk = _check(q, k, v)
    if not _build.on_cuda(q):
        return _ref.attention(q, k, v, causal=causal, window=window,
                              scale=scale)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    o = torch.empty(b, hq, tq, d, dtype=q.dtype, device=q.device)
    name, counter = _KERNELS[q.dtype]
    lib = _lib(name)
    stream = _build.current_stream(q.device)
    err = getattr(lib, f"{name}_forward")(
        _DTYPES[q.dtype], q.data_ptr(), _STRIDES(*q.stride()), k.data_ptr(),
        _STRIDES(*k.stride()), v.data_ptr(), _STRIDES(*v.stride()),
        o.data_ptr(), b, hq, hkv, tq, tk, d, bq, bk, float(scale),
        int(causal), int(window is not None),
        0 if window is None else int(window), q.device.index, stream)
    _build.raise_on(err, getattr(lib, f"{name}_error_string"),
                    "flash_attention")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[counter] += 1
    return o
