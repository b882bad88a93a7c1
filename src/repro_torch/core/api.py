"""User API (port of :mod:`repro.core.api`): one ``solve`` entry point over
a registry of methods.

    >>> x = solve(a, b, method="cg")                       # on the GPU
    >>> r = solve(a, b, method="cg", return_info=True)     # full SolveResult
    >>> x = solve(a, b, method="cg", backend="cuda")       # fused kernels
    >>> x = solve(a, b, method="cg", device="cpu")         # plain CPU path
    >>> x = solve(a, b)                                    # direct LU
    >>> f = factorize(a, method="cholesky"); x = f(b)      # factor once

Ported so far, on one device: the iterative methods (``cg``,
``pipelined_cg``, ``bicg``, ``bicgstab``, ``gmres`` and the s-step
``ca_cg`` / ``ca_gmres``, with ``s=``) on a dense (n, n)
tensor or a sparse :class:`~repro_torch.sparse.formats.BSR` /
:class:`~repro_torch.sparse.formats.ELL` matrix, the direct methods
(``lu``, ``cholesky``, ``qr``) with :func:`factorize` on a dense one, and
least squares on a rectangular (m, n) system, m ≥ n: ``qr`` (direct) and
``lsqr`` / ``cgls`` (iterative, dense or BSR).  A method that is not
registered raises the reference's "unknown method" error, which lists what
is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.core import blocking as _blocking
from repro_torch.core import cholesky as _chol
from repro_torch.core import krylov
from repro_torch.core import lu as _lu
from repro_torch.core import operator as _operator
from repro_torch.core import precond as _precond
from repro_torch.core import qr as _qr
from repro_torch.core.krylov import SolveResult
from repro_torch.resilience import monitor as _monitor

ENGINES = ("gspmd", "spmd")
KINDS = ("iterative", "direct")


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    fn: Callable
    kind: str = "iterative"       # "iterative" | "direct"
    requires: tuple = ()          # subset of {"matvec_t", "gram"}
    extra: tuple = ()             # accepted solver-specific kwargs
    factor: Callable | None = None   # direct: a -> opaque factor state
    apply: Callable | None = None    # direct: (state, b) -> x
    rectangular: bool = False     # accepts a non-square (m, n) system


_REGISTRY: dict[str, SolverEntry] = {}


def register_method(name: str, fn: Callable, *, kind: str = "iterative",
                    requires: tuple = (), extra: tuple = (),
                    factor: Callable | None = None,
                    apply: Callable | None = None,
                    rectangular: bool = False) -> SolverEntry:
    """Register a solver.  Iterative ``fn(op, b, x0, *, tol, maxiter,
    precond, **extra) -> SolveResult``.  Direct methods register a
    factor/solve split: ``factor(a, *, block_size, mesh, backend) ->
    state`` and ``apply(state, b, *, block_size, mesh, backend) -> x``
    (``fn`` remains the one-shot composition).  ``rectangular=True`` opts
    a method in to non-square (least-squares) systems.  Re-registering a
    name overwrites it."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected {KINDS}")
    if kind == "direct" and (factor is None or apply is None):
        raise ValueError(f"direct method {name!r} needs BOTH factor= and "
                         "apply=")
    entry = SolverEntry(name, fn, kind=kind, requires=tuple(requires),
                        extra=tuple(extra), factor=factor, apply=apply,
                        rectangular=rectangular)
    _REGISTRY[name] = entry
    return entry


def get_method(name: str) -> SolverEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None


def available_methods(kind: str | None = None) -> tuple[str, ...]:
    return tuple(sorted(n for n, e in _REGISTRY.items()
                        if kind is None or e.kind == kind))


register_method("lu", _lu.solve, kind="direct",
                factor=_lu.lu_factor, apply=_lu.lu_apply)
register_method("cholesky", _chol.solve, kind="direct",
                factor=_chol.cholesky_factor_state, apply=_chol.cholesky_apply)
register_method("qr", _qr.solve, kind="direct", rectangular=True,
                factor=_qr.qr_factor_state, apply=_qr.qr_apply)
register_method("cg", krylov.cg)
register_method("pipelined_cg", krylov.pipelined_cg)
register_method("bicg", krylov.bicg, requires=("matvec_t",))
register_method("bicgstab", krylov.bicgstab)
register_method("gmres", krylov.gmres, requires=("gram",),
                extra=("restart",))
register_method("ca_cg", krylov.ca_cg, requires=("gram",), extra=("s",))
register_method("ca_gmres", krylov.ca_gmres, requires=("gram",),
                extra=("s",))
register_method("lsqr", krylov.lsqr, requires=("matvec_t",),
                rectangular=True)
register_method("cgls", krylov.cgls, requires=("matvec_t",),
                rectangular=True)

DIRECT = available_methods("direct")
ITERATIVE = available_methods("iterative")


def _validate_inputs(a, b, method: str, sparse: bool = False) -> None:
    """Reject inputs no solver can recover from, with the reference's
    messages: non-finite entries (of the stored values of a sparse ``a``),
    and for ``method="cholesky"`` on a dense ``a`` a non-positive diagonal
    or an asymmetric matrix.  Reads one flag per check back to the
    host."""
    for name, arr in (("a", a.data if sparse else a), ("b", b)):
        if arr is None:
            continue
        if not bool(torch.isfinite(arr).all()):
            raise ValueError(
                f"{name!r} contains non-finite entries (NaN/Inf) — no "
                "solver can recover from a corrupted input; scrub it "
                "(jnp.nan_to_num) or fix the producing computation")
    if method == "cholesky" and not sparse and a.ndim == 2 \
            and a.shape[0] == a.shape[1]:
        if bool((torch.diagonal(a) <= 0).any()):
            raise ValueError(
                "method='cholesky' needs an SPD matrix but the diagonal "
                "has non-positive entries — use method='lu' (general "
                "square systems) or fix the matrix assembly")
        asym = float((a - a.T).abs().max())
        scale = float(a.abs().max())
        if asym > 1e-8 * max(scale, 1.0):
            raise ValueError(
                f"method='cholesky' needs a symmetric matrix but "
                f"max|A - Aᵀ| = {asym:.3e} — symmetrize with "
                "(a + a.T)/2 or use method='lu'")


def _with_fail_reason(result: SolveResult) -> SolveResult:
    """Uniform info schema: ``fail_code`` / ``fail_iter`` / ``fail_reason``
    (the host-side :func:`monitor.classify` of the code)."""
    info = dict(result.info) if result.info else {}
    code = info.get("fail_code")
    info["fail_reason"] = None if code is None \
        else _monitor.classify(int(code))
    return result._replace(info=info)


def _check_dense_direct(a) -> None:
    if a.ndim != 2:
        raise ValueError(
            f"only dense (n, n) systems are ported for the direct methods; "
            f"got shape {tuple(a.shape)} (batched (B, n, n) direct solves "
            "come with the batched slice of the port)")


def _solve_direct(entry: SolverEntry, a, b, *, block_size: int,
                  backend: str, tol: float, return_info: bool):
    """``apply(factor(a), b)``; with ``return_info``, the reference's direct
    SolveResult: iterations 0, the true residual ‖b − Ax‖ (Frobenius for a
    block of right-hand sides) — for a rectangular least-squares system the
    normal-equations residual ‖Aᵀ(b − Ax)‖ against ‖Aᵀb‖, since ‖b − Ax‖
    does not vanish at the solution — converged = residual ≤ tol·‖b‖ (or
    tol·‖Aᵀb‖), and ``fail_code`` / ``fail_iter`` 0."""
    _check_dense_direct(a)
    if b.ndim not in (1, 2) or b.shape[0] != a.shape[0]:
        raise ValueError(f"b must be ({a.shape[0]},) or ({a.shape[0]}, k), "
                         f"got shape {tuple(b.shape)}")
    kw = dict(block_size=block_size, mesh=None, backend=backend)
    with _device.full_fp32():
        x = entry.apply(entry.factor(a, **kw), b, **kw)
        if not return_info:
            return x
        rvec, refvec = b - a @ x, b
        if a.shape[0] != a.shape[1]:
            rvec, refvec = a.T @ rvec, a.T @ b
        res = torch.linalg.norm(rvec)
    bnorm = torch.linalg.norm(refvec)
    atol = tol * torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    return _with_fail_reason(SolveResult(
        x, 0, res, res <= atol, {"fail_code": zero, "fail_iter": zero}))


def _audit_rectangular(entry: SolverEntry, a, precond, engine: str) -> None:
    """The reference's non-square audit: least squares is an explicit
    opt-in (``rectangular=True`` methods), runs unpreconditioned, and is
    not an iterative ``engine='spmd'`` solve."""
    if len(a.shape) < 2 or a.shape[-2] == a.shape[-1]:
        return
    if not entry.rectangular:
        raise ValueError(
            f"matrix is non-square {tuple(a.shape)}; method {entry.name!r} "
            "solves square systems only — rectangular least squares: "
            "method='qr' (direct, TSQR under engine='spmd') or "
            "method='lsqr'/'cgls' (iterative, matrix-free)")
    if precond is not None:
        raise ValueError(
            "preconditioners are square-operator state; the "
            "least-squares path runs unpreconditioned (cgls accepts a "
            "normal-equations M via the driver API)")
    if engine == "spmd" and entry.kind != "direct":
        raise ValueError(
            "rectangular engine='spmd' is the TSQR factorization — "
            "use method='qr'; the iterative least-squares drivers run "
            "on engine='gspmd' (sharded or local)")


def _to_device(v, dev: torch.device):
    """A tensor or numpy array as a contiguous tensor on ``dev``; a sparse
    matrix moves with its structure (``SparseMatrix.to``)."""
    if v is None:
        return None
    if getattr(v, "is_sparse", False):
        return v.to(dev)
    return torch.as_tensor(v, device=dev).contiguous()


def solve(a, b, *, method: str = "lu", mesh=None, engine: str = "gspmd",
          backend: str = "ref", block_size: int = 128, tol: float = 1e-6,
          maxiter: int = 1000, restart: int = 32,
          precond: str | Callable | None = None, x0=None,
          validate: bool = True, return_info: bool = False, device=None,
          **method_kwargs):
    """Solve A x = b.  Returns x, or the full :class:`SolveResult`
    (iterations / residual / converged / info) when ``return_info=True``.

    ``a``, ``b`` and ``x0`` are tensors or numpy arrays, and ``a`` may be
    a sparse :class:`~repro_torch.sparse.formats.BSR` / ``ELL`` matrix
    (iterative methods only); they are moved to ``device`` (``None`` →
    ``"cuda"``, which raises when no GPU is present).  ``backend="cuda"``
    runs float32 solves through the hand-written kernels (the Krylov
    update, or the direct methods' panel update and triangular solves);
    float64 runs the plain tensor path on the same device, except that
    every matvec on a BSR, float32 or float64, runs the SpMV kernel.
    Direct methods (``"lu"``, the default, ``"cholesky"`` and ``"qr"``)
    take ``b`` of shape (n,) or (n, k) and no ``x0``.  A non-square (m, n)
    ``a``, m ≥ n, is a least-squares problem for ``"qr"``, ``"lsqr"`` and
    ``"cgls"`` (``b`` of length m, no preconditioner); ``return_info`` then
    reports the normal-equations residual ‖Aᵀ(b − Ax)‖.  ``precond`` is
    ``None``, ``"jacobi"``, ``"block_jacobi"`` (blocks of ``block_size``; a
    BSR's own bricks), ``"ssor"`` (BSR only), a
    :class:`~repro_torch.core.precond.Preconditioner`, or a callable
    ``v -> M⁻¹ v`` (the s-step methods take none).  ``**method_kwargs``
    forwards the options a method declares in its registry ``extra``
    (``s`` for ``ca_cg`` / ``ca_gmres``).
    """
    dev = _device.resolve(device)
    entry = get_method(method)
    sparse = getattr(a, "is_sparse", False)
    a, b, x0 = (_to_device(v, dev) for v in (a, b, x0))
    if validate:
        _validate_inputs(a, b, method, sparse)
    unknown = set(method_kwargs) - set(entry.extra)
    if unknown:
        raise TypeError(f"method {method!r} does not accept "
                        f"{sorted(unknown)}; declared extras: "
                        f"{list(entry.extra)}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    _blocking.check_backend_name(backend)
    if entry.kind == "direct" and x0 is not None:
        raise ValueError(f"x0 is an iterative-method initial guess; "
                         f"direct method {method!r} ignores it — drop x0 "
                         "or pick an iterative method")
    _audit_rectangular(entry, a, precond, engine)
    if mesh is not None or engine == "spmd":
        raise ValueError("distributed engines (mesh=, engine='spmd') are "
                         "not ported yet; solve on one device with "
                         "mesh=None")
    if entry.kind == "direct":
        if sparse:
            raise ValueError(f"direct method {method!r} is dense-only; "
                             "sparse systems use the iterative methods "
                             "(or densify explicitly with a.to_dense())")
        return _solve_direct(entry, a, b, block_size=block_size,
                             backend=backend, tol=tol,
                             return_info=return_info)
    if b.ndim != 1 or b.shape[0] != a.shape[0]:
        raise ValueError(f"b must be a vector of length {a.shape[0]}, got "
                         f"shape {tuple(b.shape)}")

    op = _operator.make_operator(a, mesh=mesh, backend=backend)
    extra = {"restart": restart} if "restart" in entry.extra else {}
    extra.update(method_kwargs)
    with _device.full_fp32():
        pc = _precond.make(precond, a, block_size)
        result = entry.fn(op, b, x0, tol=tol, maxiter=maxiter,
                          precond=pc.apply if pc is not None else None,
                          **extra)
    return _with_fail_reason(result) if return_info else result.x


def factorize(a, *, method: str = "lu", mesh=None, block_size: int = 128,
              backend: str = "ref", engine: str = "gspmd",
              validate: bool = True, device=None):
    """Factor once, solve many: returns a callable ``b -> x`` for ``b`` of
    shape (n,) or (n, k) (tensors or numpy arrays, moved to the factor's
    device).  Any method registered with ``kind="direct"`` works.
    ``device`` is as for :func:`solve` (``None`` → ``"cuda"``)."""
    if getattr(a, "is_sparse", False):
        raise ValueError("factorize is dense-only; sparse systems use the "
                         "iterative methods (or densify with a.to_dense())")
    dev = _device.resolve(device)
    entry = get_method(method)
    a = _to_device(a, dev)
    if validate:
        _validate_inputs(a, None, method)
    if entry.kind != "direct":
        raise ValueError(f"factorize needs a direct method; {method!r} is "
                         f"{entry.kind}; available: "
                         f"{available_methods('direct')}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    if mesh is not None or engine == "spmd":
        raise ValueError("distributed engines (mesh=, engine='spmd') are "
                         "not ported yet; factor on one device with "
                         "mesh=None")
    _blocking.check_backend(backend, mesh)
    _check_dense_direct(a)
    kw = dict(block_size=block_size, mesh=None, backend=backend)
    with _device.full_fp32():
        state = entry.factor(a, **kw)

    def apply(b):
        with _device.full_fp32():
            return entry.apply(state, _to_device(b, dev), **kw)

    return apply
