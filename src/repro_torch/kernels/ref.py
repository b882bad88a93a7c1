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


def fused_gram(v: torch.Tensor) -> torch.Tensor:
    """The (k, k) Gram matrix G = V Vᵀ of a (k, n) row-stack, accumulated
    in float32 and returned in ``v``'s dtype, as the reference's
    ``fused_gram_auto`` returns it."""
    vf = v.to(torch.float32)
    return (vf @ vf.T).to(v.dtype)


def lu_panel_update(a: torch.Tensor, linv: torch.Tensor, k: int, *,
                    nb: int) -> torch.Tensor:
    """One LU step on the (n, n) working matrix, in place: U12 = L11⁻¹·A12
    (``linv`` = L11⁻¹) into the panel row block, then A22 −= L21·U12.  Rows
    above k and columns left of k + nb are untouched.  Returns ``a``."""
    u12 = linv @ a[k:k + nb, k + nb:]
    a[k + nb:, k + nb:] -= a[k + nb:, k:k + nb] @ u12
    a[k:k + nb, k + nb:] = u12
    return a


def cholesky_panel_update(a: torch.Tensor, linv: torch.Tensor, k: int, *,
                          nb: int) -> torch.Tensor:
    """One Cholesky step on the (n, n) working matrix, in place:
    L21 = C·Lkk⁻ᵀ (``linv`` = Lkk⁻¹) into the panel column block, then
    A22 −= L21·L21ᵀ over the whole trailing block (both triangles).
    Returns ``a``."""
    l21 = a[k + nb:, k:k + nb] @ linv.T
    a[k + nb:, k:k + nb] = l21
    a[k + nb:, k + nb:] -= l21 @ l21.T
    return a


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B (float32 accumulation for float32 inputs)."""
    return a @ b


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Grouped-query softmax attention.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) with Hq % Hkv == 0.  Query i
    sits at position i + (Tk − Tq), so the ends align (prefill, decode).
    ``window``: the number of visible past positions, self included
    (``None``: all).  Logits in float32; a masked logit is −inf, so a row
    with no visible key is NaN.  Output in q's dtype.
    """
    _, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)


def qr_panel_update(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                    k: int, *, nb: int) -> torch.Tensor:
    """One QR trailing update on the (m, n) working matrix, in place:
    A ← A − V·(Tᵀ·(Vᵀ·A)) on rows [k, m) and columns [k + nb, n), with V
    the (m − k, nb) active Householder block (the full V is zero above
    row k), so the rows above k and the columns left of k + nb are
    untouched.  Returns ``a``."""
    win = a[k:, k + nb:]
    win -= v @ (t.T @ (v.T @ win))
    return a


def _solve_triangular(t, b, *, upper: bool, unit_diagonal: bool):
    x = torch.linalg.solve_triangular(t, b[:, None] if b.ndim == 1 else b,
                                      upper=upper,
                                      unitriangular=unit_diagonal)
    return x[:, 0] if b.ndim == 1 else x


def trsm_lower(l: torch.Tensor, b: torch.Tensor, *,
               unit_diagonal: bool = False) -> torch.Tensor:
    """X with L X = B for the lower triangle of ``l``; ``b`` is (n,) or
    (n, m)."""
    return _solve_triangular(l, b, upper=False, unit_diagonal=unit_diagonal)


def trsm_upper(u: torch.Tensor, b: torch.Tensor, *,
               unit_diagonal: bool = False) -> torch.Tensor:
    """X with U X = B for the upper triangle of ``u``; ``b`` is (n,) or
    (n, m)."""
    return _solve_triangular(u, b, upper=True, unit_diagonal=unit_diagonal)


def bsr_matvec(bsr, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a BSR matrix and x of shape (n,) or (n, k), float32 or
    float64: the matrix's own plain product (gather of x blocks, batched
    brick products, slot-ordered row sums), as the reference's
    ``bsr_matvec_ref`` is ``BSR.matvec``."""
    return bsr.matvec(x)
