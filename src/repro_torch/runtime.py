"""The kernel switch of the model layers (port of
:func:`repro.runtime.use_pallas` and :func:`repro.runtime.force_pallas`).

``use_kernel(device)`` says whether a model routes its hot spot (attention)
through :mod:`repro_torch.kernels.ops`.  By default it is true exactly for
CUDA tensors, as ``use_pallas()`` is true exactly on a TPU.
``force_kernel(True)`` routes CPU tensors through ``ops`` too, where the
wrapper takes its plain version; ``force_kernel(False)`` runs the plain
tensor paths of the layers on any device.  Both are explicit choices of the
caller, never a fallback.
"""
from __future__ import annotations

import contextlib

import torch

_FORCED: bool | None = None


def use_kernel(device) -> bool:
    if _FORCED is not None:
        return _FORCED
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def force_kernel(value: bool | None):
    global _FORCED
    prev = _FORCED
    _FORCED = value
    try:
        yield
    finally:
        _FORCED = prev
