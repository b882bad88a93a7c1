"""Public dispatch for the kernels (port of :mod:`repro.kernels.ops` for the
ported kernels).

``use_kernel=False`` runs the plain version (:mod:`repro_torch.kernels.ref`)
on any device.  Otherwise the wrapper decides by the tensors' device alone:
a CUDA tensor launches the hand-written kernel or raises, a CPU tensor runs
the plain version.  Callers never know which executed the math.
"""
from __future__ import annotations

from repro_torch.kernels import krylov_fused as _krylov_fused
from repro_torch.kernels import ref as _ref


def fused_cg_update(x, r, p, ap, alpha, *, use_kernel: bool = True):
    if not use_kernel:
        return _ref.fused_cg_update(x, r, p, ap, alpha)
    return _krylov_fused.fused_cg_update(x, r, p, ap, alpha)


def fused_pipelined_dots(r, u, w, *, use_kernel: bool = True):
    if not use_kernel:
        return _ref.fused_pipelined_dots(r, u, w)
    return _krylov_fused.fused_pipelined_dots(r, u, w)
