"""CUPLSS solve CLI on PyTorch — the port of :mod:`repro.launch.solve` for the
ported methods.

    PYTHONPATH=src python -m repro_torch.launch.solve --n 16384 --method lu \\
        --backend cuda

Draws the same synthetic dense system as the reference CLI (numpy,
seed 0): SPD ``a @ a.T / n + 4I`` for cholesky and the CG family (ca_cg
included; ``--s`` sets the s-step methods' basis size),
diagonally dominant ``a + nI`` otherwise, and with ``--m`` other than
``--n`` a Gaussian (m, n) least-squares system (methods qr, lsqr, cgls).
The SPD product is formed on the device (on the host it would take minutes
at n = 16384) and symmetrized, ``(s + sᵀ)/2``, so that it is exactly
symmetric, as Cholesky's input check requires.  Solves it, prints the
relative true residual ‖b − Ax‖/‖b‖ — for a rectangular system the
normal-equations residual ‖Aᵀ(b − Ax)‖/‖Aᵀb‖ — computed in float64, and
the wall time, and exits non-zero when the residual is too large.
``--device`` defaults to cuda.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import api

METHODS = ("lu", "cholesky", "qr", "cg", "pipelined_cg", "ca_cg", "ca_gmres",
           "bicg", "bicgstab", "gmres", "lsqr", "cgls")
SPD_METHODS = ("cholesky", "cg", "pipelined_cg", "ca_cg")


def make_system(n: int, *, spd: bool, m: int | None = None,
                dtype=np.float32, seed: int = 0, device=None):
    """The reference CLI's system, drawn with numpy and formed on
    ``device``: the same draws, in the same order, in the same dtype."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    if m is not None and m != n:                # rectangular: least squares
        a = torch.from_numpy(rng.standard_normal((m, n)).astype(dtype))
        b = torch.from_numpy(rng.standard_normal(m).astype(dtype))
        return a.to(dev), b.to(dev)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(dtype)).to(dev)
    if spd:
        with _device.full_fp32():
            a = a @ a.T / n + torch.eye(n, dtype=a.dtype, device=dev) * 4.0
            a = (a + a.T) / 2
    else:
        a += n * torch.eye(n, dtype=a.dtype, device=dev)
    b = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(dev)
    return a, b


def relative_residual(a: torch.Tensor, b: torch.Tensor,
                      x: torch.Tensor) -> float:
    """‖b − Ax‖/‖b‖ in float64."""
    a64, b64 = a.double(), b.double()
    return float(torch.linalg.vector_norm(b64 - a64 @ x.double())
                 / torch.linalg.vector_norm(b64))


def normal_residual(a: torch.Tensor, b: torch.Tensor,
                    x: torch.Tensor) -> float:
    """‖Aᵀ(b − Ax)‖/‖Aᵀb‖ in float64: the residual of a least-squares
    solution, where ‖b − Ax‖ does not vanish."""
    a64, b64 = a.double(), b.double()
    return float(torch.linalg.vector_norm(a64.T @ (b64 - a64 @ x.double()))
                 / torch.linalg.vector_norm(a64.T @ b64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--m", type=int, default=None,
                    help="rows; m > n makes the system rectangular least "
                         "squares (methods qr/lsqr/cgls)")
    ap.add_argument("--method", default="lu", choices=METHODS)
    ap.add_argument("--s", type=int, default=2,
                    help="s-step basis size for ca_cg/ca_gmres (the "
                         "monomial basis conditions like kappa^s: keep "
                         "s small in float32, raise under --dtype float64)")
    ap.add_argument("--backend", default="ref", choices=["ref", "cuda"])
    ap.add_argument("--precond", default=None,
                    choices=[None, "jacobi", "block_jacobi"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    a, b = make_system(args.n, spd=args.method in SPD_METHODS, m=args.m,
                       dtype=np.dtype(args.dtype), device=args.device)
    extra = {"s": args.s} if args.method.startswith("ca_") else {}
    t0 = time.perf_counter()
    res = api.solve(a, b, method=args.method, backend=args.backend,
                    tol=args.tol, maxiter=args.maxiter,
                    precond=args.precond, return_info=True,
                    device=args.device, **extra)
    if a.device.type == "cuda":
        torch.cuda.synchronize(a.device)
    dt = time.perf_counter() - t0

    if a.shape[0] != a.shape[1]:
        rel, label = normal_residual(a, b, res.x), "||Aᵀ(b - Ax)||/||Aᵀb||"
    else:
        rel, label = relative_residual(a, b, res.x), "||b - Ax||/||b||"
    print(f"method={args.method} backend={args.backend} "
          f"shape={tuple(a.shape)} dtype={args.dtype} device={a.device} "
          f"iterations={res.iterations} "
          f"fail_reason={res.info['fail_reason']}")
    print(f"relative residual {label} = {rel:.3e}   wall = {dt:.3f}s")
    if not rel <= max(args.tol * 100, 1e-4):
        print(f"residual too large: {rel}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
