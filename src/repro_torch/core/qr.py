"""Blocked Householder QR factorization and least-squares solve (port of
:mod:`repro.core.qr`, the single-device path).

The rectangular member of the direct family: ``min ‖b − A x‖`` for an
(m, n) ``A``, m ≥ n.  Per block step at column k:

1. *panel*: Householder QR of the (m − k, nb) column block
   (:func:`_panel_qr`), packed as LAPACK's ``geqrf`` packs it (R on and
   above the diagonal, the vectors' tails below, v₁ = 1 implicit, one τ a
   column);
2. *T matrix*: the compact-WY triangle of the panel's reflectors
   (:func:`_form_t`, LAPACK's ``larft``), ``Q_panel = I − V T Vᵀ``;
3. *trailing update*: ``A ← (I − V Tᵀ Vᵀ) A`` on the columns right of the
   panel.  ``backend="cuda"`` with float32 runs it as one call of the
   hand-written kernel (:mod:`repro_torch.kernels.qr_fused`); with
   ``fuse_panel=False`` it is three products of the tiled GEMM kernel
   (:mod:`repro_torch.kernels.gemm`); otherwise plain products in the
   input's dtype.

The reference steps a fixed-shape ``lax.fori_loop`` over masked full-height
windows.  Here k is a host integer, so each step slices its active window
(rows [k, m)), and the factorization works in place on one working copy.
The panel and T loops run column by column on the device, with no host
read per column.  ``m``/``n`` that are not block multiples go through
:func:`repro_torch.core.blocking.pad_rect` (exact).

The factor state keeps the packed matrix, the τs and each panel's T, so
:func:`qr_apply` is Qᵀb panel by panel (plain products, as in the
reference) and one blocked triangular solve with R, which is the
triangular-solve kernel on ``backend="cuda"``.  The distributed
factorization (TSQR, ``engine="spmd"``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import blocking
from repro_torch.core.triangular import solve_upper_blocked
from repro_torch.kernels import ops


def _panel_qr(pan: torch.Tensor) -> torch.Tensor:
    """Householder QR of the active panel ``pan`` (r, nb), r ≥ nb, in place:
    R on and above the diagonal, the Householder tails below it.  Returns
    the (nb,) τs.

    The panel is worked on transposed, ``pan.T`` row by row, so that each
    column is contiguous.  A zero column gives τ = 0 (H = I), as in the
    reference; everything stays on the device.
    """
    nb = pan.shape[1]
    pt = pan.T.contiguous()                 # (nb, r): row j = column j
    taus = pan.new_zeros(nb)
    one, zero = pan.new_ones(()), pan.new_zeros(())
    for j in range(nb):
        col = pt[j, j:]                     # the active tail, from row j
        x1 = col[0]
        xnorm = torch.sqrt(torch.dot(col, col))
        beta = torch.where(x1 >= 0, -xnorm, xnorm)     # the R diagonal
        degenerate = xnorm == 0
        v = col / torch.where(degenerate, one, x1 - beta)
        v[0] = torch.where(degenerate, zero, one)
        tau = torch.where(degenerate, zero, (beta - x1) / beta)
        taus[j] = tau
        # H = I − τ v vᵀ on the panel's columns right of j
        rest = pt[j + 1:, j:]
        rest -= torch.outer(rest @ v, tau * v)
        col[1:] = v[1:]
        col[0] = torch.where(degenerate, x1, beta)
    pan.copy_(pt.T)
    return taus


def _panel_v(pan: torch.Tensor) -> torch.Tensor:
    """The (r, nb) V of a packed active panel: unit diagonal, the stored
    tails below it, zeros above."""
    r, nb = pan.shape
    return torch.tril(pan, -1) + torch.eye(r, nb, dtype=pan.dtype,
                                           device=pan.device)


def _form_t(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY triangle (LAPACK ``larft``): upper-triangular T with
    ``H_1 ⋯ H_nb = I − V T Vᵀ``, column by column."""
    nb = taus.shape[0]
    gram = v.T @ v
    t = torch.zeros_like(gram)
    for j in range(nb):
        t[:j, j] = -taus[j] * (t[:j, :j] @ gram[:j, j])
        t[j, j] = taus[j]
    return t


@dataclasses.dataclass(frozen=True)
class QrState:
    """Factor state: the packed QR of the padded system, its τs and each
    panel's compact-WY T.  ``m0``/``n0`` are the logical shape (−1 when not
    recorded); the tensors cover the padded one."""
    qr: torch.Tensor       # (m_pad, n_pad) packed R / Householder tails
    taus: torch.Tensor     # (n_pad,)
    tmats: torch.Tensor    # (n_pad // nb, nb, nb)
    m0: int
    n0: int
    nb: int


def qr_factor(a: torch.Tensor, *, block_size: int = 128, mesh=None,
              backend: str = "ref", fuse_panel: bool = True) -> QrState:
    """Blocked Householder QR of an (m, n) matrix, m ≥ n."""
    if mesh is not None:
        raise ValueError("qr_factor is single-device; the distributed "
                         "factorization is TSQR (engine='spmd'), which is "
                         "not ported yet; drop mesh=")
    blocking.check_backend(backend, mesh)
    kernels = blocking.effective_backend(backend, a.dtype) == "cuda"
    a0 = a
    a, nb, m, n = blocking.pad_rect(a, block_size)
    if a is a0:
        a = a.clone(memory_format=torch.contiguous_format)
    taus_all = a.new_zeros(n)
    tmats = a.new_zeros((n // nb, nb, nb))
    for s, k in enumerate(range(0, n, nb)):
        pan = a[k:, k:k + nb]
        taus = _panel_qr(pan)
        v = _panel_v(pan)
        t = _form_t(v, taus)
        if kernels and fuse_panel:
            ops.qr_panel_update(a, v, t, k, nb=nb)
        elif k + nb < n:
            win = a[k:, k + nb:]
            if kernels:
                w = ops.matmul(v.T, win)
                win -= ops.matmul(v, ops.matmul(t.T, w))
            else:
                win -= v @ (t.T @ (v.T @ win))
        taus_all[k:k + nb] = taus
        tmats[s] = t
    return QrState(a, taus_all, tmats, m0=-1, n0=-1, nb=nb)


def qr_factor_state(a: torch.Tensor, *, block_size: int = 128, mesh=None,
                    backend: str = "ref") -> QrState:
    """Registry ``factor`` entry: records the logical shape on the state."""
    m0, n0 = a.shape
    return dataclasses.replace(
        qr_factor(a, block_size=block_size, mesh=mesh, backend=backend),
        m0=m0, n0=n0)


def _panels(state: QrState, order):
    """(k, V of the active rows, T) of the panels, in ``order`` of panel
    index."""
    nb = state.nb
    for s in order:
        k = s * nb
        yield k, _panel_v(state.qr[k:, k:k + nb]), state.tmats[s]


def apply_qt(state: QrState, b: torch.Tensor) -> torch.Tensor:
    """y = Qᵀ b for a padded (m_pad,) / (m_pad, k) right-hand side: the
    panels first to last, each as two skinny products on rows [k, m)."""
    y = (b[:, None] if b.ndim == 1 else b).clone()
    for k, v, t in _panels(state, range(state.tmats.shape[0])):
        y[k:] -= v @ (t.T @ (v.T @ y[k:]))
    return y[:, 0] if b.ndim == 1 else y


def apply_q(state: QrState, y: torch.Tensor) -> torch.Tensor:
    """x = Q y (the panels last to first): Q's reconstitution."""
    x = (y[:, None] if y.ndim == 1 else y).clone()
    for k, v, t in _panels(state, reversed(range(state.tmats.shape[0]))):
        x[k:] -= v @ (t @ (v.T @ x[k:]))
    return x[:, 0] if y.ndim == 1 else x


def qr_apply(state: QrState, b: torch.Tensor, *, block_size: int = 128,
             mesh=None, backend: str = "ref") -> torch.Tensor:
    """Registry ``apply``: the least-squares solve min ‖b − A x‖ from a
    :func:`qr_factor_state` factor — Qᵀb, then the blocked R solve."""
    m, n = state.qr.shape
    n0 = state.n0 if state.n0 >= 0 else n
    if state.m0 >= 0 and b.shape[0] != state.m0:
        raise ValueError(f"rhs has {b.shape[0]} rows; this factor solves "
                         f"an m = {state.m0} system")
    y = apply_qt(state, blocking.pad_rhs(b, m))[:n]
    r = state.qr[:n]                     # R lives in the top (n, n) rows
    x = solve_upper_blocked(r, y, block_size=state.nb, mesh=mesh,
                            backend=backend)
    return x[:n0]


def solve(a: torch.Tensor, b: torch.Tensor, block_size: int = 128, mesh=None,
          backend: str = "ref") -> torch.Tensor:
    """One-shot least-squares solve via blocked Householder QR."""
    return qr_apply(qr_factor_state(a, block_size=block_size, mesh=mesh,
                                    backend=backend), b,
                    block_size=block_size, mesh=mesh, backend=backend)


def reduced(a: torch.Tensor, *, block_size: int = 128, backend: str = "ref"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced (thin) QR: (m, n) → Q (m, n), R (n, n), with R's diagonal
    made non-negative (the deterministic form the parity tests use)."""
    m0, n0 = a.shape
    state = qr_factor_state(a, block_size=block_size, backend=backend)
    m, n = state.qr.shape
    eye = torch.eye(m, n, dtype=state.qr.dtype, device=state.qr.device)
    q = apply_q(state, eye)[:m0, :n0]
    r = torch.triu(state.qr[:n])[:n0, :n0]
    s = torch.where(torch.diagonal(r) < 0, -1, 1).to(r.dtype)
    return q * s[None, :], r * s[:, None]
