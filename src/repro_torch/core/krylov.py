"""Non-stationary iterative solvers (port of :mod:`repro.core.krylov`): CG,
pipelined CG, BiCG, BiCGSTAB and GMRES(m).

Each solver is written once against the
:class:`repro_torch.core.operator.LinearOperator` primitive set, and also
accepts a bare ``matvec`` callable in place of the operator.

The reference runs ``lax.while_loop``, whose stop test stays on the device.
Here the loop is a Python loop with the same test,
``sqrt(rr) > atol & ok(health) & k < maxiter``, evaluated once per
iteration: one host synchronisation per iteration (per restart cycle for
GMRES), which keeps the iteration counts equal to the reference's.  All
other scalars (α, β, ⟨r,r⟩, the health record) stay on the device as 0-d
tensors, so the fused update kernel reads α from device memory.

Every solver carries a :mod:`repro_torch.resilience.monitor` health record
and reports it as ``SolveResult.info['fail_code'/'fail_iter']``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.operator import LinearOperator, as_operator
from repro_torch.resilience import monitor

# divergence cutoffs, in the metric each solver carries: the CG family
# tracks SQUARED norms (1e8 on ⟨r,r⟩ is 1e4 on ‖r‖), GMRES plain norms
_DIV_SQ = 1e8
_DIV_NORM = 1e6

# arnoldi_process's continuation directions are drawn from a generator
# with this seed (the reference uses jax.random.key(7); the draws differ)
_CONTINUATION_SEED = 7


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor    # final ||b - Ax|| (2-norm; recurrence-based)
    converged: torch.Tensor
    info: dict | None = None  # health taxonomy: fail_code / fail_iter


def _safe_div(num, den):
    """num/den with 0 where den == 0 (the classic BiCGSTAB omega guard)."""
    den_ok = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / den_ok)


def _setup(op: LinearOperator, b, x0):
    x0 = torch.zeros_like(b) if x0 is None else x0
    bnorm = op.norm(b)
    atol = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    return x0, atol


def _running(metric, atol, h, *, sq: bool = True) -> bool:
    """The loop's stop test on the host (the one sync per iteration)."""
    res = torch.sqrt(metric) if sq else metric
    return bool((res > atol) & monitor.ok(h))


# --------------------------------------------------------------------------
# Conjugate Gradient (SPD)
# --------------------------------------------------------------------------

def cg(op: LinearOperator | Callable, b: torch.Tensor,
       x0: torch.Tensor | None = None, *, tol: float = 1e-6,
       maxiter: int = 1000, precond: Callable | None = None) -> SolveResult:
    op = as_operator(op)
    m = precond
    x, atol = _setup(op, b, x0)
    atol = tol * atol

    r = b - op.matvec(x)
    z = r if m is None else m(r)
    p = z
    rz = op.dot(r, z)
    rr = rz if m is None else op.dot(r, r)
    h = monitor.init(rr)
    k = 0
    while k < maxiter and _running(rr, atol, h):
        ap = op.matvec(p)
        alpha = _safe_div(rz, op.dot(p, ap))
        x, r, rr = op.update(x, r, p, ap, alpha)    # fused single pass
        z = r if m is None else m(r)
        rz_new = rr if m is None else op.dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + op.scale(beta, p)
        # alpha = 0 only via _safe_div breakdown (⟨p, Ap⟩ vanished — A
        # singular / not SPD); flag it unless the residual converged.
        brk = (alpha.abs() == 0) & (torch.sqrt(rr) > atol)
        h = monitor.update(h, rr, k + 1, breakdown=brk, divergence=_DIV_SQ)
        rz = rz_new
        k += 1
    res = torch.sqrt(rr)
    return SolveResult(x, k, res, res <= atol, monitor.info(h))


# --------------------------------------------------------------------------
# Pipelined CG (Chronopoulos–Gear): one mat-vec and ONE fused reduction
# (⟨r,u⟩, ⟨w,u⟩, ⟨r,r⟩ in a single pass) per iteration.
# --------------------------------------------------------------------------

def pipelined_cg(op: LinearOperator | Callable, b: torch.Tensor,
                 x0: torch.Tensor | None = None, *, tol: float = 1e-6,
                 maxiter: int = 1000,
                 precond: Callable | None = None) -> SolveResult:
    op = as_operator(op)
    m = precond
    x, atol = _setup(op, b, x0)
    atol = tol * atol

    r = b - op.matvec(x)
    u = r if m is None else m(r)
    w = op.matvec(u)
    gamma, delta, rr = op.pipelined_dots(r, u, w)
    alpha = _safe_div(gamma, delta)
    beta = torch.zeros_like(gamma)
    p = s = torch.zeros_like(b)
    h = monitor.init(rr)
    k = 0
    while k < maxiter and _running(rr, atol, h):
        p = u + op.scale(beta, p)
        s = w + op.scale(beta, s)              # s = A p, by recurrence
        x = x + op.scale(alpha, p)
        r = r - op.scale(alpha, s)
        u = r if m is None else m(r)
        w = op.matvec(u)
        gamma_new, delta, rr = op.pipelined_dots(r, u, w)   # ONE reduction
        beta = _safe_div(gamma_new, gamma)
        alpha = _safe_div(gamma_new, delta - _safe_div(beta * gamma_new,
                                                       alpha))
        # alpha = 0 only via _safe_div breakdown — flag it unless converged
        brk = (alpha.abs() == 0) & (torch.sqrt(rr) > atol)
        h = monitor.update(h, rr, k + 1, breakdown=brk, divergence=_DIV_SQ)
        gamma = gamma_new
        k += 1
    res = torch.sqrt(rr)
    return SolveResult(x, k, res, res <= atol, monitor.info(h))


# --------------------------------------------------------------------------
# BiCG (general; needs Aᵀ)
# --------------------------------------------------------------------------

def bicg(op: LinearOperator | Callable, b: torch.Tensor,
         x0: torch.Tensor | None = None, *, tol: float = 1e-6,
         maxiter: int = 1000, precond: Callable | None = None,
         precond_t: Callable | None = None,
         matvec_t: Callable | None = None) -> SolveResult:
    op = as_operator(op, matvec_t=matvec_t)
    m = precond
    mt = precond_t if precond_t is not None else precond
    x, atol = _setup(op, b, x0)
    atol = tol * atol

    r = b - op.matvec(x)
    rt = r                        # shadow residual
    z = r if m is None else m(r)
    zt = rt if mt is None else mt(rt)
    p, pt = z, zt
    rz = op.dot(rt, z)
    rr = op.dot(r, r)
    h = monitor.init(rr)
    k = 0
    while k < maxiter and _running(rr, atol, h):
        ap = op.matvec(p)
        atpt = op.matvec_t(pt)
        alpha = _safe_div(rz, op.dot(pt, ap))
        x, r, rr = op.update(x, r, p, ap, alpha)    # fused single pass
        rt = rt - op.scale(alpha, atpt)
        z = r if m is None else m(r)
        zt = rt if mt is None else mt(rt)
        rz_new = op.dot(rt, z)
        beta = _safe_div(rz_new, rz)
        p = z + op.scale(beta, p)
        pt = zt + op.scale(beta, pt)
        # the serious BiCG breakdown: ⟨r̃, z⟩ = 0 with r not yet small
        brk = (rz_new.abs() == 0) & (torch.sqrt(rr) > atol)
        h = monitor.update(h, rr, k + 1, breakdown=brk, divergence=_DIV_SQ)
        rz = rz_new
        k += 1
    res = torch.sqrt(rr)
    return SolveResult(x, k, res, res <= atol, monitor.info(h))


# --------------------------------------------------------------------------
# BiCGSTAB (the paper's implemented BiCG variant)
# --------------------------------------------------------------------------

def bicgstab(op: LinearOperator | Callable, b: torch.Tensor,
             x0: torch.Tensor | None = None, *, tol: float = 1e-6,
             maxiter: int = 1000,
             precond: Callable | None = None) -> SolveResult:
    op = as_operator(op)
    m = precond
    x, atol = _setup(op, b, x0)
    atol = tol * atol

    r = b - op.matvec(x)
    rhat = r
    rr = op.dot(r, r)
    rho = alpha = omega = torch.ones_like(rr)
    v = p = torch.zeros_like(b)
    h = monitor.init(rr)
    k = 0
    while k < maxiter and _running(rr, atol, h):
        rho_new = op.dot(rhat, r)
        # ratio-of-ratios, not a product quotient: rho*omega can underflow
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + op.scale(beta, p - op.scale(omega, v))
        phat = p if m is None else m(p)
        v = op.matvec(phat)
        alpha = _safe_div(rho_new, op.dot(rhat, v))
        s = r - op.scale(alpha, v)
        shat = s if m is None else m(s)
        t = op.matvec(shat)
        omega = _safe_div(*op.dots(((t, s), (t, t))))  # one reduction
        xh = x + op.scale(alpha, phat)
        x, r, rr = op.update(xh, s, shat, t, omega)   # x=xh+ωŝ, r=s−ωt, ⟨r,r⟩
        # rho = 0 or omega = 0 is the classic BiCGSTAB breakdown; with
        # _safe_div the iterates stay finite, so classify explicitly.
        brk = ((rho_new.abs() == 0) | (omega.abs() == 0)) \
            & (torch.sqrt(rr) > atol)
        h = monitor.update(h, rr, k + 1, breakdown=brk, divergence=_DIV_SQ)
        rho = rho_new
        k += 1
    res = torch.sqrt(rr)
    return SolveResult(x, k, res, res <= atol, monitor.info(h))


# --------------------------------------------------------------------------
# Arnoldi process (CGS2 re-orthogonalized Gram-Schmidt) and GMRES(m)
# --------------------------------------------------------------------------

def arnoldi_process(op: LinearOperator, v0: torch.Tensor, m: int, *,
                    apply: Callable | None = None):
    """Run ``m`` Arnoldi steps from the unit vector ``v0``.

    Returns ``(basis, hmat)``: the (m+1, n) orthonormal Krylov basis and the
    (m+1, m) upper-Hessenberg projection ``A V_m = V_{m+1} H``.  ``apply``
    composes a (right) preconditioner into the operator (GMRES's M⁻¹).
    Step j orthogonalizes against the j+1 basis rows built so far (the
    reference masks a fixed-shape basis to the same rows).
    """
    n = v0.shape[0]
    tiny = torch.tensor(1e-30, dtype=v0.dtype, device=v0.device)
    eps = torch.finfo(v0.dtype).eps
    ap = apply if apply is not None else (lambda v: v)
    basis = v0.new_zeros((m + 1, n))
    basis[0] = v0
    hmat = v0.new_zeros((m + 1, m))
    gen = None
    for j in range(m):
        w = op.matvec(ap(basis[j]))
        scale = op.norm(w)
        vs = basis[:j + 1]
        for _ in range(2):                      # CGS2: re-orthogonalize
            h = op.dotm(vs, w)
            w = w - vs.T @ h
            hmat[:j + 1, j] += h
        hnorm = op.norm(w)
        # lucky breakdown: A vj ∈ span(basis) — the Krylov space closed.
        # Record β = 0 (H decouples exactly there) and continue with a fresh
        # direction orthogonalized into the complement, as the reference
        # does.  Reading the flag is one host sync per step.
        if bool(hnorm <= 100 * eps * scale):
            if gen is None:
                gen = torch.Generator(device=v0.device)
                gen.manual_seed(_CONTINUATION_SEED)
            f = torch.randn(n, generator=gen, dtype=v0.dtype,
                            device=v0.device)
            for _ in range(2):
                f = f - vs.T @ op.dotm(vs, f)
            basis[j + 1] = f / torch.maximum(op.norm(f), tiny)
        else:
            basis[j + 1] = w / torch.maximum(hnorm, tiny)
            hmat[j + 1, j] = hnorm
    return basis, hmat


def _lstsq(hmat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """min ‖rhs − H y‖ by an SVD-based pseudo-inverse.  H loses rank on a
    lucky breakdown, so a QR-based solve (on CUDA, torch's lstsq has only
    gels) will not do; ``pinv`` cuts singular values below
    max(m, n)·eps·σ₁, the rule of ``jnp.linalg.lstsq``'s default
    ``rcond``."""
    return torch.linalg.pinv(hmat) @ rhs


def gmres(op: LinearOperator | Callable, b: torch.Tensor,
          x0: torch.Tensor | None = None, *, tol: float = 1e-6,
          restart: int = 32, maxiter: int = 100,
          precond: Callable | None = None) -> SolveResult:
    """``maxiter`` counts restart cycles; total matvecs <= maxiter*restart."""
    op = as_operator(op)
    m_apply = precond if precond is not None else (lambda v: v)
    x, atol = _setup(op, b, x0)
    atol = tol * atol
    m = restart
    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def cycle(x):
        r = b - op.matvec(x)
        beta = op.norm(r)
        v0 = r / torch.maximum(beta, tiny)
        basis, hmat = arnoldi_process(op, v0, m, apply=m_apply)
        e1 = b.new_zeros(m + 1)
        e1[0] = beta
        y = _lstsq(hmat, e1)
        return x + m_apply(basis[:m].T @ y)

    res = op.norm(b - op.matvec(x))
    h = monitor.init(res)
    k = 0
    while k < maxiter and _running(res, atol, h, sq=False):
        x = cycle(x)
        res = op.norm(b - op.matvec(x))
        # taxonomy only: three whole cycles without a new best residual
        # means the restart space stopped helping
        h = monitor.update(h, res, k + 1, divergence=_DIV_NORM,
                           stagnation=3)
        k += 1
    return SolveResult(x, k, res, res <= atol, monitor.info(h))
