"""Non-stationary iterative solvers (port of :mod:`repro.core.krylov`): CG,
pipelined CG, the s-step CA-CG and CA-GMRES, BiCG, BiCGSTAB and GMRES(m),
and the least-squares CGLS and LSQR.

Each solver is written once against the
:class:`repro_torch.core.operator.LinearOperator` primitive set, and also
accepts a bare ``matvec`` callable in place of the operator.

The reference runs ``lax.while_loop``, whose stop test stays on the device.
Here the loop is a Python loop with the same test,
``sqrt(rr) > atol & ok(health) & k < maxiter``, evaluated once per
iteration: one host synchronisation per iteration (per restart cycle for
GMRES, per outer step for CA-CG, per cycle for CA-GMRES), which keeps the
iteration counts equal to the reference's.  All other scalars (α, β,
⟨r,r⟩, the health record, the s-step methods' effective s and inner
iteration count) stay on the device as 0-d tensors, so the fused update
kernel reads α from device memory.

Every solver carries a :mod:`repro_torch.resilience.monitor` health record
and reports it as ``SolveResult.info['fail_code'/'fail_iter']``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.operator import LinearOperator, as_operator
from repro_torch.resilience import monitor

# divergence cutoffs, in the metric each solver carries: the CG family
# tracks SQUARED norms (1e8 on ⟨r,r⟩ is 1e4 on ‖r‖), GMRES and LSQR plain
# norms; CGLS cuts off early on ‖Aᵀr‖², since the normal equations square
# cond(A)
_DIV_SQ = 1e8
_DIV_CA_SQ = 1e4       # ca_cg on ⟨r,r⟩ (diverges hard at the f32 floor)
_DIV_CGLS_SQ = 1e2
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
# s-step (communication-avoiding) Krylov: CA-CG and CA-GMRES.  Per outer
# step a matrix-powers sweep (matvecs only) builds a monomial basis, ONE
# block_dots reduction forms its Gram matrix, and the iterations run on
# coefficient vectors of length 2s+1 (CA-CG) or s+1 (CA-GMRES) whose inner
# products are read out of the Gram matrix.  The monomial basis conditions
# like cond(A)^s, hence the Gram-factor check and the shrink-s fallback.
#
# The reference unrolls the s inner steps with masks inside its while loop;
# here the masks, the effective s and the inner-iteration count stay on the
# device as 0-d tensors, so an outer step reads nothing back but the stop
# test.  The shrink-s probes factor with cholesky_ex, which neither raises
# nor synchronises on a block that is not positive definite, and test its
# info as well as the factor's diagonal: jnp.linalg.cholesky NaNs such a
# factor, cholesky_ex leaves a finite partial one.
# --------------------------------------------------------------------------

def _matrix_powers(op: LinearOperator, v: torch.Tensor, deg: int) -> list:
    """[v, Av, …, A^deg v] — the matrix-powers sweep (matvecs only)."""
    rows = [v]
    for _ in range(deg):
        rows.append(op.matvec(rows[-1]))
    return rows


def _no_ca_precond(precond, name):
    if precond is not None:
        raise ValueError(
            f"{name} is unpreconditioned (M would have to enter the "
            "matrix-powers basis as (MA)^k, changing the operator); use "
            "method='pipelined_cg' or 'gmres' for preconditioned solves")


def _factor_ok(sub: torch.Tensor, floor) -> torch.Tensor:
    """Whether ``sub`` has a Cholesky factor whose pivots are finite and all
    above ``floor``, as a 0-d bool tensor (no host read)."""
    l, info = torch.linalg.cholesky_ex(sub)
    dd = torch.diagonal(l)
    return (info == 0) & torch.isfinite(dd).all() & (dd > floor).all()


def _unit_scale(g: torch.Tensor):
    """The symmetrized Gram matrix, the scale d = 1/sqrt(diag) (guarded
    against a zero diagonal) and the unit-diagonal Gram matrix D g D."""
    g = 0.5 * (g + g.T)
    d = torch.rsqrt(torch.clamp_min(torch.diagonal(g),
                                    torch.finfo(g.dtype).tiny))
    return g, d, g * d[:, None] * d[None, :]


def ca_cg(op: LinearOperator | Callable, b: torch.Tensor,
          x0: torch.Tensor | None = None, *, tol: float = 1e-6,
          maxiter: int = 1000, precond: Callable | None = None,
          s: int = 4) -> SolveResult:
    """s-step CG on the monomial basis: per OUTER step, 2s−1 matvecs build
    [p, Ap, …, Aˢp, r, Ar, …, Aˢ⁻¹r], ONE ``block_dots`` reduction forms
    the (2s+1)² Gram matrix, and s plain-CG iterations run on coefficient
    vectors with every inner product read out of the Gram matrix.

    Numerical breakdown (the monomial basis losing rank in finite
    precision) is detected per outer step by Cholesky-factoring nested
    leading Gram blocks; the step falls back to the largest s' ≤ s whose
    factor is well-conditioned, and terminates if even s' = 1 fails.
    ``maxiter`` counts CG iterations (inner steps), as in ``cg``.
    """
    _no_ca_precond(precond, "ca_cg")
    if s < 1:
        raise ValueError(f"ca_cg needs s >= 1, got s={s}")
    op = as_operator(op)
    x, atol = _setup(op, b, x0)
    atol = tol * atol
    nn = 2 * s + 1
    dev, dt = b.device, b.dtype
    sqrt_eps = torch.tensor(torch.finfo(dt).eps, dtype=dt, device=dev).sqrt()

    # shift matrix: A·(basisᵀ c) = basisᵀ (B c).  Two independent
    # sub-diagonals — one per power chain; the chains never mix.
    bshift = torch.zeros((nn, nn), dtype=dt, device=dev)
    j = torch.arange(s, device=dev)
    bshift[j + 1, j] = 1
    if s > 1:
        j = torch.arange(s + 1, nn - 1, device=dev)
        bshift[j + 1, j] = 1

    r = b - op.matvec(x)
    rr = op.dot(r, r)
    p = r
    h = monitor.init(rr)
    xb, rrb = x, rr
    k = torch.zeros((), dtype=torch.int32, device=dev)
    # the stop test, read back once per outer step
    while bool((torch.sqrt(torch.clamp_min(rr, 0)) > atol) & monitor.ok(h)
               & (k < maxiter)):
        rows = _matrix_powers(op, p, s) + _matrix_powers(op, r, s - 1)
        basis = torch.stack(rows)                   # (2s+1, n) row-stack
        g, d, gs = _unit_scale(op.block_dots(basis))  # ONE reduction
        # the basis rescaled to unit norm, free in coefficient space: it
        # folds into the Gram (D g D), the shift matrix (D⁻¹ B D) and the
        # seed / readout coefficients
        bs = bshift * (d[None, :] / d[:, None])

        # breakdown fallback: the largest s' for which both power chains
        # keep numerical rank — each basis vector keeps > sqrt(eps) of its
        # norm after orthogonalization against its own chain
        s_eff = torch.zeros((), dtype=torch.int32, device=dev)
        for cand in range(1, s + 1):
            ok = torch.ones((), dtype=torch.bool, device=dev)
            for lo, size in ((0, cand + 1), (s + 1, cand)):
                sub = g[lo:lo + size, lo:lo + size]
                ok = ok & _factor_ok(
                    sub, sqrt_eps * torch.sqrt(torch.diagonal(sub)))
            s_eff = torch.where(ok, cand, s_eff).to(torch.int32)

        # s CG steps on the scaled coefficient vectors; a masked step
        # carries its state unchanged.  Seeds carry 1/d.
        pc = torch.zeros(nn, dtype=dt, device=dev)
        pc[0] = 1 / d[0]
        rc = torch.zeros(nn, dtype=dt, device=dev)
        rc[s + 1] = 1 / d[s + 1]
        xc = torch.zeros(nn, dtype=dt, device=dev)
        rr = g[s + 1, s + 1]                        # fresh ⟨r,r⟩ from Gram
        kk = k
        for j in range(s):
            active = (s_eff > j) & (rr > 0)
            w = bs @ pc                             # coeffs of A p
            alpha = _safe_div(rr, pc @ (gs @ w))
            xc_n = xc + alpha * pc
            rc_n = rc - alpha * w
            rr_n = torch.clamp_min(rc_n @ (gs @ rc_n), 0)
            beta = _safe_div(rr_n, rr)
            pc_n = rc_n + beta * pc
            xc = torch.where(active, xc_n, xc)
            rc = torch.where(active, rc_n, rc)
            pc = torch.where(active, pc_n, pc)
            rr = torch.where(active, rr_n, rr)
            kk = kk + active.to(torch.int32)

        # coefficients back to vectors (un-scaled with d)
        x = x + (xc * d) @ basis
        r = (rc * d) @ basis
        p = (pc * d) @ basis
        # at the attainable accuracy of the working precision the s-step
        # recurrence diverges rather than stalls: keep the best iterate;
        # the monitor classifies the blow-up (_DIV_CA_SQ past the best
        # ⟨r,r⟩) and a basis with no rank left (s_eff = 0)
        better = rr < rrb
        xb = torch.where(better, x, xb)
        rrb = torch.where(better, rr, rrb)
        brk = (s_eff == 0) & (torch.sqrt(torch.clamp_min(rr, 0)) > atol)
        h = monitor.update(h, rr, kk, breakdown=brk, divergence=_DIV_CA_SQ)
        k = kk
    res = torch.sqrt(torch.clamp_min(rrb, 0))
    return SolveResult(xb, int(k), res, res <= atol, monitor.info(h))


def ca_gmres(op: LinearOperator | Callable, b: torch.Tensor,
             x0: torch.Tensor | None = None, *, tol: float = 1e-6,
             maxiter: int = 100, precond: Callable | None = None,
             s: int = 8) -> SolveResult:
    """s-step GMRES: per cycle, a matrix-powers sweep builds the s+1
    monomial basis vectors (matvecs only), then ONE ``block_dots``
    reduction feeds CholeskyQR, in place of the ~2s synchronizations of
    Arnoldi's Gram-Schmidt.  The Hessenberg projection comes from the shift
    identity A·K[:s] = K[1:] as H = R[:,1:] R[:s,:s]⁻¹, and the cycle's
    least-squares residual is read off locally.  A prefix condition mask on
    the Cholesky factor truncates the cycle to the numerically independent
    basis columns (the shrink-s fallback).  ``maxiter`` counts cycles.

    Each cycle reads the stop test back once; the small least-squares
    solve (:func:`_lstsq`, an SVD) synchronizes on CUDA as well."""
    _no_ca_precond(precond, "ca_gmres")
    if s < 1:
        raise ValueError(f"ca_gmres needs s >= 1, got s={s}")
    op = as_operator(op)
    x, atol = _setup(op, b, x0)
    atol = tol * atol
    dev, dt = b.device, b.dtype
    sqrt_eps = torch.tensor(torch.finfo(dt).eps, dtype=dt, device=dev).sqrt()
    eye = torch.eye(s + 1, dtype=dt, device=dev)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    idx = torch.arange(s + 1, device=dev)

    def cycle(x):
        r = b - op.matvec(x)
        kmat = torch.stack(_matrix_powers(op, r, s))  # (s+1, n) row-stack
        g, d, gs = _unit_scale(op.block_dots(kmat))    # ONE reduction
        # shrink-s fallback on the unit-diagonal Gram: basis vector i
        # survives iff it keeps > sqrt(eps) of its norm after
        # orthogonalization against its predecessors
        s_eff = torch.zeros((), dtype=torch.int32, device=dev)
        for cand in range(1, s + 1):
            ok = _factor_ok(gs[:cand + 1, :cand + 1], sqrt_eps)
            s_eff = torch.where(ok, cand, s_eff).to(torch.int32)
        msk = ((idx <= s_eff) & (g[0, 0] > 0)).to(dt)
        g_safe = torch.where(torch.outer(msk, msk) > 0, gs, eye)
        # positive definite by construction; a non-finite Gram fails, and
        # then the factor is NaN, as jnp.linalg.cholesky returns it
        l, info = torch.linalg.cholesky_ex(g_safe)
        l = torch.where(info == 0, l, nan)
        # CholeskyQR of the scaled basis Ks = diag(d)·K: the rows of
        # Q̃ = L⁻¹·Ks are orthonormal, Ksᵀ = Q̃ᵀ·rc with rc = Lᵀ
        # upper-triangular.  Only y·Q̃[:s] is used, so the triangular solve
        # runs on the (s+1)² matrix L⁻¹·diag(d) and one product with K
        # makes the update (the reference solves against the (s+1, n) Ks;
        # on the card a solve with n right-hand sides is far slower)
        ld = torch.linalg.solve_triangular(l, torch.diag(d), upper=False)
        rc = l.T
        # shift identity on the scaled basis: A·Ks[j] = (d[j]/d[j+1])
        # Ks[j+1].  A basis vector whose norm² overflowed has d = 0 and an
        # inf ratio: zero it (its columns are masked) before the product
        ratio = d[:s] / d[1:]
        ratio = torch.where(torch.isfinite(ratio), ratio, 0)
        rinv, _ = torch.linalg.inv_ex(rc[:s, :s])
        hmat = (rc[:, 1:] * ratio[None, :]) @ rinv   # (s+1, s) Hessenberg
        mask2d = (torch.outer(msk, msk[1:]) > 0) & torch.isfinite(hmat)
        hmat = torch.where(mask2d, hmat, 0)          # where, not *: 0·inf
        # r's coordinates in the Q̃ basis: r = Ks[0]/d[0] = Q̃ᵀrc[:,0]/d[0]
        c = torch.where(msk[0] > 0, rc[:, 0] / d[0], torch.zeros_like(d))
        y = _lstsq(hmat, c)
        y = torch.where(torch.isfinite(y), y, 0)
        res = torch.linalg.norm(c - hmat @ y)
        return x + (y @ ld[:s]) @ kmat, res, s_eff >= 1

    res = op.norm(b - op.matvec(x))
    h = monitor.init(res)
    k = 0
    while k < maxiter and _running(res, atol, h, sq=False):
        x2, res2, ok = cycle(x)
        # a cycle that does not strictly improve the least-squares residual
        # (stagnation, or NaNs past every mask) is discarded and ends the
        # iteration; the monitor classifies it (a non-finite residual, a
        # basis with no independent column, or stagnation with window 1)
        better = torch.isfinite(res2) & (res2 < res)
        h = monitor.update(h, res2, k + 1, breakdown=(~ok) & (res > atol),
                           stagnation=1)
        x = torch.where(better, x2, x)
        res = torch.where(better, res2, res)
        k += 1
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


# --------------------------------------------------------------------------
# Iterative least squares: CGLS and LSQR.  They need only matvec / matvec_t,
# so every engine runs them; x lives in the n-space and r in the m-space.
# Convergence is on the normal-equations residual ‖Aᵀr‖ ≤ tol·‖Aᵀb‖, which
# vanishes at the least-squares solution when ‖r‖ does not, and
# ``SolveResult.residual`` reports ‖Aᵀr‖.
# --------------------------------------------------------------------------

def _ls_setup(op: LinearOperator, b, x0):
    """(x0, r0, the atol reference ‖Aᵀb‖) of the least-squares drivers."""
    sb = op.matvec_t(b)
    x0 = torch.zeros_like(sb) if x0 is None else x0
    r0 = b - op.matvec(x0)
    ref = op.norm(sb)
    return x0, r0, torch.where(ref == 0, torch.ones_like(ref), ref)


def cgls(op: LinearOperator | Callable, b: torch.Tensor,
         x0: torch.Tensor | None = None, *, tol: float = 1e-6,
         maxiter: int = 1000, precond: Callable | None = None,
         matvec_t: Callable | None = None) -> SolveResult:
    """CG on the normal equations AᵀA x = Aᵀb without forming AᵀA
    (Björck); ``precond`` acts on the n-space normal-equations residual
    (M ≈ (AᵀA)⁻¹).  In float32 CGLS reaches its attainable accuracy early
    and then diverges, so the best iterate is carried and returned, and
    the monitor stops once ‖Aᵀr‖² grows ``_DIV_CGLS_SQ``× past its best."""
    op = as_operator(op, matvec_t=matvec_t)
    m = precond
    x, r, ref = _ls_setup(op, b, x0)
    atol = tol * ref

    s = op.matvec_t(r)
    z = s if m is None else m(s)
    p = z
    gamma = op.dot(s, z)
    ss = gamma if m is None else op.dot(s, s)
    h = monitor.init(ss)
    xb, ssb = x, ss
    k = 0
    while k < maxiter and _running(ss, atol, h):
        q = op.matvec(p)
        alpha = _safe_div(gamma, op.dot(q, q))
        x, r = op.axpy_pair(x, p, r, q, alpha)     # fused when m == n
        s = op.matvec_t(r)
        z = s if m is None else m(s)
        gamma_new = op.dot(s, z)
        ss = gamma_new if m is None else op.dot(s, s)
        improved = (ss < ssb).to(x.dtype)
        xb = xb + op.scale(improved, x - xb)
        ssb = torch.minimum(ss, ssb)
        beta = _safe_div(gamma_new, gamma)
        p = z + op.scale(beta, p)
        # gamma = 0 only via breakdown (⟨q, q⟩ or ⟨s, z⟩ vanished: the
        # solution reached, or M indefinite)
        brk = (gamma_new.abs() == 0) & (torch.sqrt(ss) > atol)
        h = monitor.update(h, ss, k + 1, breakdown=brk,
                           divergence=_DIV_CGLS_SQ)
        gamma = gamma_new
        k += 1
    res = torch.sqrt(ssb)
    return SolveResult(xb, k, res, res <= atol, monitor.info(h))


def lsqr(op: LinearOperator | Callable, b: torch.Tensor,
         x0: torch.Tensor | None = None, *, tol: float = 1e-6,
         maxiter: int = 1000, precond: Callable | None = None,
         matvec_t: Callable | None = None) -> SolveResult:
    """LSQR (Paige & Saunders 1982): Golub-Kahan bidiagonalization with
    the QR factors updated by Givens rotations — analytically CGLS, but
    more reliable on ill-conditioned systems."""
    if precond is not None:
        raise ValueError("lsqr is unpreconditioned (the bidiagonalization "
                         "has no symmetric place to put M); use method="
                         "'cgls', whose preconditioner acts on the normal "
                         "equations")
    op = as_operator(op, matvec_t=matvec_t)
    x, r, ref = _ls_setup(op, b, x0)
    atol = tol * ref

    beta = op.norm(r)
    one = torch.ones_like(beta)
    u = op.scale(_safe_div(one, beta), r)
    av = op.matvec_t(u)
    alfa = op.norm(av)
    v = op.scale(_safe_div(one, alfa), av)
    w, phibar, rhobar = v, beta, alfa
    arnorm = alfa * beta                      # ‖Aᵀr₀‖ exactly at x₀
    h = monitor.init(arnorm)
    k = 0
    while k < maxiter and _running(arnorm, atol, h, sq=False):
        # continue the bidiagonalization
        u = op.matvec(v) - op.scale(alfa, u)
        beta = op.norm(u)
        u = op.scale(_safe_div(one, beta), u)
        v = op.matvec_t(u) - op.scale(beta, v)
        alfa = op.norm(v)
        v = op.scale(_safe_div(one, alfa), v)
        # Givens rotation on the lower-bidiagonal R
        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        cs = _safe_div(rhobar, rho)
        sn = _safe_div(beta, rho)
        theta = sn * alfa
        rhobar = -cs * alfa
        phi = cs * phibar
        phibar = sn * phibar
        # solution and direction update
        x = x + op.scale(_safe_div(phi, rho), w)
        w = v - op.scale(_safe_div(theta, rho), w)
        # ‖Aᵀr_k‖ = φ̄_{k+1} α_{k+1} |c_k|; an exact breakdown (β or α hit
        # zero: the solution reached) reports as converged
        arnorm = phibar * alfa * cs.abs()
        arnorm = torch.where((beta == 0) | (alfa == 0),
                             torch.zeros_like(arnorm), arnorm)
        h = monitor.update(h, arnorm, k + 1, divergence=_DIV_NORM)
        k += 1
    return SolveResult(x, k, arnorm, arnorm <= atol, monitor.info(h))
