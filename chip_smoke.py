#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the hand-written kernels, from ``src/repro_torch/kernels/csrc``;
3. kernels: each against its plain PyTorch version on the card, at
   n ∈ {16384, 16384 + 130, 2²⁴} (vectors rtol = atol = 1e-5, dots rtol
   1e-4), bitwise-repeatable, timed with CUDA events beside the plain
   version and the memory bound (bytes ÷ 3.35 TB/s, H100 SXM);
4. main path: ``api.solve(..., backend="cuda")`` at n = 16384 float32 for
   cg, pipelined_cg (SPD ``a aᵀ/n + 4I``), bicg, bicgstab, gmres (``a + nI``)
   and cg with jacobi / block_jacobi: converged, true relative residual
   ≤ 1e-4 (float64), iterations within max(1.2×, +2) of ``backend="ref"``
   on the card, and the kernel launch counters risen; then cg run far
   past its tolerance (≤ 100 iterations) on each backend, six pairs in
   alternating order, for the steady time per iteration;
5. CLI: ``repro_torch.launch.solve.main`` at n = 16384 with cg on the
   kernels.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device-memory rate
N_MAIN = 16384
KERNEL_SIZES = (N_MAIN, N_MAIN + 130, 1 << 24)
TIMED_LAUNCHES = 200
RESIDUAL_LIMIT = 1e-4
STEADY_ITERS = 100
STEADY_PAIRS = 6
KERNEL_RECORD = {
    "fused_cg_update": {
        "source": "src/repro_torch/kernels/csrc/krylov_fused.cu",
        "replaces": "src/repro/kernels/krylov_fused.py:76",
        "streams": 6},               # x, r, p, Ap read; x', r' written
    "fused_pipelined_dots": {
        "source": "src/repro_torch/kernels/csrc/krylov_fused.cu",
        "replaces": "src/repro/kernels/krylov_fused.py:178",
        "streams": 3},               # r, u, w read
}
# (method, system, precond, kernel whose counter must rise or None)
MAIN_PATH = (
    ("cg", "spd", None, "fused_cg_update"),
    ("pipelined_cg", "spd", None, "fused_pipelined_dots"),
    ("bicg", "nonsym", None, "fused_cg_update"),
    ("bicgstab", "nonsym", None, "fused_cg_update"),
    ("gmres", "nonsym", None, None),
    ("cg", "spd", "jacobi", "fused_cg_update"),
    ("cg", "spd", "block_jacobi", "fused_cg_update"),
)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, launches: int = TIMED_LAUNCHES) -> float:
    """Mean device time of one call, by CUDA events over ``launches``
    back-to-back calls after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # the plain versions and the matvecs run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[card] allow_tf32: cuda.matmul=False cudnn=False")
    return card


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    for name in ("krylov_fused",):
        path = _build.build(name)
        _build.library(name)
        print(f"[build] {name}: {path.relative_to(ROOT)}")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] seconds {time.perf_counter() - t0:.3f}")


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import krylov_fused, ref
    dev = torch.device("cuda")
    rows = {}
    for n in KERNEL_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        x, r, p, ap = (torch.randn(n, generator=g, device=dev)
                       for _ in range(4))
        alpha = torch.rand((), generator=g, device=dev)
        cases = {
            "fused_cg_update": (krylov_fused.fused_cg_update,
                                ref.fused_cg_update, (x, r, p, ap, alpha),
                                (1e-5, 1e-5, 1e-4)),
            "fused_pipelined_dots": (krylov_fused.fused_pipelined_dots,
                                     ref.fused_pipelined_dots, (x, r, p),
                                     (None, None, 1e-4)),
        }
        for name, (kernel, plain, args, (v_rtol, v_atol, d_rtol)) \
                in cases.items():
            got = kernel(*args)
            again = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} n={n}: reruns differ")
            err = 0.0
            for a, w in zip(got, want):
                err = max(err, float((a - w).abs().max()))
                if a.ndim == 1:
                    ok = torch.allclose(a, w, rtol=v_rtol, atol=v_atol)
                else:
                    ok = abs(float(a) - float(w)) <= d_rtol * abs(float(w))
                check(ok, f"{name} n={n}: kernel and plain version differ "
                          f"(max abs err {err})")
            ms = time_ms(torch, lambda: kernel(*args))
            plain_ms = time_ms(torch, lambda: plain(*args))
            nbytes = KERNEL_RECORD[name]["streams"] * 4 * n
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(name, n)] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms}
            print(f"[kernel] {name} n={n} max_abs_err={err:.3e} "
                  f"bitwise_rerun=True ms={ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={bound_ms:.6f} bytes={nbytes} "
                  f"library_ms=null (no single PyTorch call computes it)")
    return rows


def _systems(torch, n: int):
    """SPD ``a aᵀ/n + 4I`` and diagonally dominant ``a + nI`` on the card,
    from one seeded Gaussian ``a``; ``b`` Gaussian."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    eye = torch.eye(n, device=dev)
    spd = a @ a.T / n + 4.0 * eye
    a += n * eye
    return {"spd": spd, "nonsym": a}, b


def phase_main_path(torch) -> dict:
    from repro_torch.core import api
    from repro_torch.kernels import krylov_fused
    from repro_torch.launch.solve import relative_residual
    systems, b = _systems(torch, N_MAIN)
    mv_ms = time_ms(torch, lambda: systems["spd"] @ b, 50)
    sync_probe = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bool(sync_probe > 0)
    sync_ms = (time.perf_counter() - t0) * 1e3 / 100
    print(f"[main] n={N_MAIN} float32 matvec_ms={mv_ms:.6f} "
          f"host_sync_roundtrip_ms={sync_ms:.6f}")

    krylov_fused.reset_launches()
    for method, system, precond, kernel in MAIN_PATH:
        a = systems[system]
        kw = dict(method=method, precond=precond, return_info=True)
        ref_res = api.solve(a, b, backend="ref", **kw)
        before = dict(krylov_fused.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(a, b, backend="cuda", **kw)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3
        rose = {k: krylov_fused.LAUNCHES[k] - before[k] for k in before}
        rel = relative_residual(a, b, res.x)
        it, ref_it = res.iterations, ref_res.iterations
        label = f"{method}" + (f"+{precond}" if precond else "")
        print(f"[main] {label} system={system} iterations={it} "
              f"ref_iterations={ref_it} converged={bool(res.converged)} "
              f"fail_reason={res.info['fail_reason']} rel_residual={rel:.3e} "
              f"solve_ms={solve_ms:.3f} ms_per_iter={solve_ms / max(it, 1):.6f} "
              f"launches={rose}")
        check(bool(res.converged), f"{label}: not converged ({res.info})")
        check(rel <= RESIDUAL_LIMIT, f"{label}: residual {rel} > "
                                     f"{RESIDUAL_LIMIT}")
        check(it <= max(1.2 * ref_it, ref_it + 2),
              f"{label}: {it} iterations vs {ref_it} on backend='ref'")
        if kernel is not None:
            check(rose[kernel] > 0, f"{label}: {kernel} never launched")
    # steady state: cg with tol 1e-30 runs until ⟨r,r⟩ underflows or
    # STEADY_ITERS, far past the set-up; plain and kernel backends in
    # STEADY_PAIRS pairs, alternating which runs first
    steady = {"ref": [], "cuda": []}
    for i in range(STEADY_PAIRS):
        for backend in (("ref", "cuda") if i % 2 == 0 else ("cuda", "ref")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api.solve(systems["spd"], b, method="cg", backend=backend,
                            tol=1e-30, maxiter=STEADY_ITERS,
                            return_info=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            steady[backend].append(ms / res.iterations)
            check(res.iterations >= 20 and res.info["fail_reason"] == "ok",
                  f"steady cg backend={backend}: {res.iterations} "
                  f"iterations, {res.info['fail_reason']}")
    launches = dict(krylov_fused.LAUNCHES)
    print(f"[main] launches over the main path: {launches}")
    for backend, runs in steady.items():
        print(f"[main] steady cg backend={backend} ms_per_iter "
              f"median={statistics.median(runs):.6f} runs={runs}")
    print(f"[main] steady cg: matvec {mv_ms:.6f} ms, host sync roundtrip "
          f"{sync_ms:.6f} ms")
    return launches


def phase_cli(torch) -> None:
    from repro_torch.kernels import krylov_fused
    from repro_torch.launch import solve as cli
    before = krylov_fused.LAUNCHES["fused_cg_update"]
    rc = cli.main(["--n", str(N_MAIN), "--method", "cg", "--backend",
                   "cuda"])
    check(rc == 0, f"CLI returned {rc}")
    check(krylov_fused.LAUNCHES["fused_cg_update"] > before,
          "CLI run launched no fused_cg_update")
    print("[cli] returned 0")


def main() -> int:
    import torch
    import repro_torch  # noqa: F401  (without the package: fail before output)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    phase_card(torch)
    phase_build()
    rows = phase_kernels(torch)
    launches = phase_main_path(torch)
    phase_cli(torch)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": launches[name],
         "max_abs_err": rows[(name, N_MAIN)]["max_abs_err"],
         "ms": rows[(name, N_MAIN)]["ms"],
         "plain_ms": rows[(name, N_MAIN)]["plain_ms"],
         "bound_ms": rows[(name, N_MAIN)]["bound_ms"], "bound_by": "bytes",
         "library_ms": None}
        for name, meta in KERNEL_RECORD.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
