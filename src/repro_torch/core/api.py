"""User API (port of :mod:`repro.core.api`): one ``solve`` entry point over
a registry of methods.

    >>> x = solve(a, b, method="cg")                       # on the GPU
    >>> r = solve(a, b, method="cg", return_info=True)     # full SolveResult
    >>> x = solve(a, b, method="cg", backend="cuda")       # fused kernels
    >>> x = solve(a, b, method="cg", device="cpu")         # plain CPU path

Ported so far: the iterative methods on one device with a dense matrix
(``cg``, ``pipelined_cg``, ``bicg``, ``bicgstab``, ``gmres``).  A method
that is not registered raises the reference's "unknown method" error,
which lists what is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.core import blocking as _blocking
from repro_torch.core import krylov
from repro_torch.core import operator as _operator
from repro_torch.core import precond as _precond
from repro_torch.core.krylov import SolveResult
from repro_torch.resilience import monitor as _monitor

ENGINES = ("gspmd", "spmd")


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    fn: Callable
    kind: str = "iterative"       # "iterative" (the only kind ported)
    requires: tuple = ()          # subset of {"matvec_t", "gram"}
    extra: tuple = ()             # accepted solver-specific kwargs


_REGISTRY: dict[str, SolverEntry] = {}


def register_method(name: str, fn: Callable, *, kind: str = "iterative",
                    requires: tuple = (), extra: tuple = ()) -> SolverEntry:
    """Register a solver ``fn(op, b, x0, *, tol, maxiter, precond, **extra)
    -> SolveResult``.  Re-registering a name overwrites it."""
    if kind != "iterative":
        raise ValueError(f"only iterative methods are ported; got "
                         f"kind={kind!r}")
    entry = SolverEntry(name, fn, kind=kind, requires=tuple(requires),
                        extra=tuple(extra))
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


register_method("cg", krylov.cg)
register_method("pipelined_cg", krylov.pipelined_cg)
register_method("bicg", krylov.bicg, requires=("matvec_t",))
register_method("bicgstab", krylov.bicgstab)
register_method("gmres", krylov.gmres, requires=("gram",),
                extra=("restart",))

ITERATIVE = available_methods("iterative")


def _validate_inputs(a, b) -> None:
    """Reject non-finite inputs, which no solver can recover from.  Reads
    one flag per array back to the host."""
    for name, arr in (("a", a), ("b", b)):
        if arr is None:
            continue
        if not bool(torch.isfinite(arr).all()):
            raise ValueError(
                f"{name!r} contains non-finite entries (NaN/Inf) — no "
                "solver can recover from a corrupted input; scrub it "
                "(jnp.nan_to_num) or fix the producing computation")


def _with_fail_reason(result: SolveResult) -> SolveResult:
    """Uniform info schema: ``fail_code`` / ``fail_iter`` / ``fail_reason``
    (the host-side :func:`monitor.classify` of the code)."""
    info = dict(result.info) if result.info else {}
    code = info.get("fail_code")
    info["fail_reason"] = None if code is None \
        else _monitor.classify(int(code))
    return result._replace(info=info)


def _to_device(v, dev: torch.device):
    return None if v is None else torch.as_tensor(v, device=dev).contiguous()


def solve(a, b, *, method: str = "lu", mesh=None, engine: str = "gspmd",
          backend: str = "ref", block_size: int = 128, tol: float = 1e-6,
          maxiter: int = 1000, restart: int = 32,
          precond: str | Callable | None = None, x0=None,
          validate: bool = True, return_info: bool = False, device=None,
          **method_kwargs):
    """Solve A x = b.  Returns x, or the full :class:`SolveResult`
    (iterations / residual / converged / info) when ``return_info=True``.

    ``a``, ``b`` and ``x0`` are tensors or numpy arrays; they are moved to
    ``device`` (``None`` → ``"cuda"``, which raises when no GPU is
    present).  ``backend="cuda"`` runs the float32 hot loop through the
    hand-written kernels; float64 runs the plain tensor path on the same
    device.  ``precond`` is ``None``, ``"jacobi"``, ``"block_jacobi"``
    (blocks of ``block_size``), a :class:`~repro_torch.core.precond
    .Preconditioner`, or a callable ``v -> M⁻¹ v``.  ``**method_kwargs``
    forwards the options a method declares in its registry ``extra``.
    """
    dev = _device.resolve(device)
    entry = get_method(method)
    a, b, x0 = (_to_device(v, dev) for v in (a, b, x0))
    if validate:
        _validate_inputs(a, b)
    unknown = set(method_kwargs) - set(entry.extra)
    if unknown:
        raise TypeError(f"method {method!r} does not accept "
                        f"{sorted(unknown)}; declared extras: "
                        f"{list(entry.extra)}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    if mesh is not None or engine == "spmd":
        raise ValueError("distributed engines (mesh=, engine='spmd') are "
                         "not ported yet; solve on one device with "
                         "mesh=None")
    _blocking.check_backend_name(backend)
    if a.ndim == 2 and a.shape[0] != a.shape[1]:
        raise ValueError(
            f"matrix is non-square {tuple(a.shape)}; method {method!r} "
            "solves square systems only")
    if b.ndim != 1 or b.shape[0] != a.shape[-1]:
        raise ValueError(f"b must be a vector of length {a.shape[-1]}, got "
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
