"""Where the port runs: device resolution and the float32 precision rule.

Every entry point takes ``device=None``, which means the GPU.  There is no
silent move to the CPU: a caller without a GPU passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on (``None`` → ``"cuda"``).
    Raises when a CUDA device is asked for and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} (the default is 'cuda') but torch sees no "
            "CUDA device; pass device='cpu' to run the plain tensor path "
            "on the CPU")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in full float32, never TF32, and restore
    the caller's settings on exit.  The reference computes its float32
    matvecs in float32; TF32 keeps about three decimal digits and would
    change iteration counts."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
