"""Plain PyTorch versions of the hand-written kernels (port of the matching
functions of :mod:`repro.kernels.ref`).

Each is the mathematical definition with no tiling.  A kernel wrapper uses
its plain version for tensors on the CPU; on the GPU, ``chip_smoke.py``
holds each kernel against its plain version on the same inputs.
"""
from __future__ import annotations

import torch


def fused_cg_update(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                    ap: torch.Tensor, alpha
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass CG vector update: x + α p, r − α Ap and ⟨r', r'⟩ (float32
    accumulation)."""
    xn = x + alpha * p
    rn = r - alpha * ap
    rf = rn.float()
    return xn, rn, torch.dot(rf, rf)


def fused_pipelined_dots(r: torch.Tensor, u: torch.Tensor, w: torch.Tensor):
    """Pipelined-CG reduction: (⟨r,u⟩, ⟨w,u⟩, ⟨r,r⟩) in float32."""
    rf, uf, wf = r.float(), u.float(), w.float()
    return torch.dot(rf, uf), torch.dot(wf, uf), torch.dot(rf, rf)
