#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the hand-written kernels, from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together), with ptxas's report
   of each kernel (registers, shared memory, spills);
3. kernels: each fused Krylov kernel against its plain PyTorch version on
   the card, at n ∈ {16384, 16384 + 130, 2²⁴} (vectors rtol = atol =
   1e-5, dots rtol 1e-4), bitwise-repeatable, timed with CUDA events
   beside the plain version and the memory bound (bytes ÷ 3.35 TB/s, H100
   SXM), with each call's CUDA kernels and their device µs
   (``torch.profiler``; ``main`` fails unless ``fused_cg_update`` is one
   kernel, at most once a call), the host µs a call of the wrapper (the
   least of 5 rounds of 400 calls), and the bits of the results (``rr``
   as an int32, the first 16 hex digits of the SHA-256 of the x' and r'
   bytes), by which two trees' turns show whether they agree bitwise;
3b. direct kernels, at the direct path's n = 16384 float32, nb = 128: the
   LU and Cholesky panel updates at k ∈ {0, n/2, n − 2nb} (on the change
   they make: atol 1e-5 · its largest entry, rtol 2.5e-7), the Cholesky
   update also on an exactly symmetric A ((a + aᵀ)/2: its trailing block
   must come out bitwise symmetric) and on an A with a Gaussian upper
   triangle added (held as above); each panel update's CUDA kernels a call
   and their device µs (``torch.profiler``), and the achieved rate of its
   K = nb update kernel; the SASS of ``factor_fused`` must hold no
   tensor-core instruction; and the triangular solve for m ∈ {1, 128}
   right-hand sides on the lower, upper and transposed triangles of real
   factors, and for m ∈ {1, 3} on random well-conditioned triangles at
   n = 20480 (160 block rows, more than the card's SMs) (rtol 1e-3, atol
   1e-3 · max|x|), each bitwise-repeatable and timed beside its plain
   version, its bound — max(flops ÷ 67 TFLOP/s float32, bytes ÷ 3.35
   TB/s), with the Cholesky update's least work counted on the tiles on
   and below the diagonal (its product is symmetric), so its bytes bound
   it — and, for the solve, ``torch.linalg.solve_triangular``; for the
   panel updates ``library_ms`` is null (no single PyTorch call) and
   ``composed_ms`` the two cuBLAS calls of the same step
   (``solve_triangular``, then ``addmm_`` with alpha = −1 into A22); each
   solve's diagonal inversion and substitution kernel timed apart, and the
   CUDA kernels of one solve counted by ``torch.profiler`` (the
   substitution must be one launch);
4. main path: ``api.solve(..., backend="cuda")`` at n = 16384 float32 for
   cg, pipelined_cg (SPD ``a aᵀ/n + 4I``), bicg, bicgstab, gmres (``a + nI``)
   and cg with jacobi / block_jacobi: converged, true relative residual
   ≤ 1e-4 (float64), iterations within max(1.2×, +2) of ``backend="ref"``
   on the card, and the kernel launch counters risen; then cg run far
   past its tolerance (≤ 100 iterations) on each backend, six pairs in
   alternating order, for the steady time per iteration;
4b. direct main path: ``api.solve(..., backend="cuda")`` at n = 16384
   float32 with ``lu`` on ``a + nI`` and on a plain Gaussian matrix (which
   pivots) and ``cholesky`` on the symmetrized SPD system: the launch
   counters of the panel-update and triangular-solve kernels risen, and a
   normwise backward error ‖b − Ax‖∞ / (‖A‖∞‖x‖∞ + ‖b‖∞) (float64) at most
   10× that of ``backend="ref"`` on the card; factor and apply times, the
   kernels' share of the factorization, and ``torch.linalg.solve``'s time;
   then ``factorize`` once and apply twice;
3c. sparse kernel, at the sparse main path's 3-D Poisson system on a 128³
   grid (n = 2,097,152, nb = 32, nnzb = 423,936): the BSR SpMV against its
   plain version with random, nonsymmetric brick values on the Poisson
   structure, float32 and float64, k ∈ {1, 4} columns, for A and for its
   transposed BSR (held against A's plain ``matvec_t``), at rtol 1e-5
   (float32) / 1e-12 (float64) and atol the same times max|y|,
   bitwise-repeatable; each timed beside its plain version, its byte bound
   and ``torch.sparse_bsr_tensor(...) @ x`` (cuSPARSE) on the same bricks;
   then the Poisson matrix itself (k = 1, float32, the main path's call),
   beside cuSPARSE CSR on its true nonzeros;
4c. sparse main path: ``api.solve(bsr, b, backend="cuda")`` on the Poisson
   system with a Gaussian b, in float32 for cg, pipelined_cg, bicg,
   bicgstab and gmres, cg with jacobi and with block_jacobi, cg in float64
   (the SpMV kernel in float64), and cg with ssor at 32³ (a
   host-sequential sweep): converged, true relative residual ≤ 1e-4
   (float64), iterations within max(1.2×, +2) of ``backend="ref"`` on the
   card, the SpMV and Krylov launch counters risen; time per iteration
   beside the SpMV's time.  ``backend="ref"`` runs at most 3000 matvecs
   (``maxiter`` 3000, GMRES 93 cycles of 32); a method it does not
   converge at 128³ runs at 64³, and the line says so;
4d. BiCGSTAB witness: float32 BiCGSTAB on the 128³ system with each
   pairing of SpMV (plain, the kernel, a float64 product rounded to
   float32) and vector update (plain, the fused kernel), to show which one
   moves the iteration count; float64 BiCGSTAB on ``backend="cuda"`` (the
   SpMV kernel in float64) against ``backend="ref"``: both converged and
   within max(1.2×, +2) of each other; cuda against ref at 64³ for four
   more right-hand sides;
3d. least-squares kernels, at the least-squares path's m = 32768,
   n = 8192 float32, nb = 128: the QR trailing update at k ∈ {0, n/2,
   n − 2nb} on real Householder panels of the path's Gaussian A/√m
   (held on the change it makes: atol 1e-4 · its largest entry, rtol
   1e-5), and the tiled GEMM at the three products of the unfused QR at
   k = 0 (Vᵀ·A, Tᵀ·W, V·Y) and at the unfused LU's trailing update at
   n = 16384, k = 0 (rtol 1e-4, atol 1e-4 · max|C|); each
   bitwise-repeatable, timed beside its plain version, its bound and the
   library call: ``torch.matmul`` (cuBLAS) for the GEMM, and for the QR
   update three cuBLAS calls (mm, mm, addmm); the QR update also with
   nothing written above or left of its window, its CUDA kernels a call
   and each one's device µs (``torch.profiler``); the SASS of the GEMM
   and QR-update libraries (``cuobjdump``) must hold no tensor-core
   instruction (``HMMA``, ``HGMMA``), and each kernel's ``FFMA`` and
   ``LDL`` / ``STL`` counts are printed;
4e. least-squares main path at m = 32768, n = 8192 float32 (A Gaussian /
   √m, b = A x* + 1e-3 · a Gaussian): ``api.solve(..., method="qr",
   backend="cuda")`` with the QR update and triangular-solve counters
   risen and a normal-equations residual ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ (float64) at
   most 10× that of ``backend="ref"`` on the card; factor and apply times,
   the panel loop's share of the factorization, factorize once + apply
   twice; ``qr_factor(..., fuse_panel=False)`` with the GEMM counter risen
   and the same gate; lsqr and cgls converged with iterations within
   max(1.2×, +2) of ``backend="ref"``; ``torch.linalg.lstsq`` (driver
   gels) as the yardstick; then the unfused LU (on ``a + nI``) and
   Cholesky at n = 16384, ``fuse_panel=False``: the GEMM and
   triangular-solve counters risen, the backward error at most 10× that
   of ``backend="ref"`` from phase 4b;
3e. Gram kernel, at the s-step path's shapes: G = V Vᵀ of Gaussian rows
   at each (k, n) that phase 4f gives it — k = 2s + 1 (ca_cg) or s + 1
   (ca_gmres), so k ∈ {5, 9}, at n = 16384 (the dense systems), 128³ and
   64³ (the Poisson systems) — and at k = 17 (n = 16384 and 128³), which
   the CLI accepts but the main path does not run, against its plain
   version at rtol 1e-5 and atol 1e-5 · max|G|, bitwise-repeatable, timed
   beside the plain version, ``torch.mm(v, v.T)`` (cuBLAS) and its bound
   max(4kn bytes ÷ 3.35 TB/s, 2k²n flops ÷ 67 TFLOP/s), with its achieved
   GB/s and bound share, its device µs and CUDA kernels a call
   (``torch.profiler``; one kernel, at most once a call, for k ≤ 16), and
   the host µs a call of the wrapper and of ``torch.mm``;
4f. s-step main path: ``api.solve(..., backend="cuda")`` against
   ``backend="ref"`` on the card, dense n = 16384 float32 (ca_cg s = 2 on
   the SPD system, ca_gmres s = 4 and s = 8 on ``a + nI``) and the 128³
   Poisson BSR with a Gaussian b (ca_cg s = 2 and s = 4 and ca_gmres s = 4
   in float32, ca_cg s = 4 in float64: the plain Gram and the SpMV kernel
   in float64): a finite x, the same ``fail_reason`` as ``backend="ref"``;
   where the reference converged, converged, true relative residual ≤ 1e-4
   (float64) and iterations within max(1.2×, +2); the Gram kernel's
   counter risen for every float32 solve and the SpMV's on the BSR; every
   (k, n) the Gram kernel got is one that phase 3e held; time per
   iteration and the Gram's share of the solve, beside cg's from phases 4
   and 4c.  ``backend="ref"`` runs at most ~3000 matvecs; a method it
   does not converge at 128³ runs at 64³, and the line says so.  float32
   ca_cg at s = 4 on the dense SPD system runs too, as a witness: its
   stop there is decided by the Gram's rounding in both packages, so it
   is not held to the reference, but its best iterate's true relative
   residual is held to 1e-2;
3f. attention kernel (kernel 10: bf16 on the tensor cores,
   ``csrc/attention_wgmma.cu``, float32 on the float32 pipes,
   ``csrc/attention.cu``), with the tensor-core kernel's ptxas registers,
   shared memory and spills and the count of ``HGMMA`` instructions in its
   SASS (``cuobjdump``; a count of 0 fails), the float32 kernel's ptxas
   report and its SASS's ``FFMA`` and ``LDL`` / ``STL`` counts (an
   ``HMMA`` or ``HGMMA`` there fails), then at the serving path's
   shapes (qwen3-1.7b:
   B = 4, 16 / 8 heads, D = 128, causal, T = 1920 and 2048, bf16 and the
   float32 copy's float32, and T = 32768 at B = 1) and the other configs'
   (tinyllama's group of 8 at D = 64, hymba's window of 1024 at T = 4096,
   the decode offset Tq = 128 against Tk = 2048, kimi's D = 112 float32
   non-causal), against its plain version: float32 rtol = atol = 1e-4;
   bf16 element by element |Δ| ≤ 2⁻⁸ · |o| + 1e-5 (one bf16 rounding of
   each output plus float32 slack) against the plain version computed in
   float32 from the same bf16 inputs; where
   the plain version's float32 scores would pass 16 GB (T = 32768) on the
   first 256 rows against the first 256 keys and the last 256 rows against
   all keys, both exact sub-problems; bitwise-repeatable; timed beside the
   plain version, ``scaled_dot_product_attention`` (``is_causal`` where
   Tq = Tk, else an explicit end-aligned mask) and its bound max(bytes ÷
   3.35 TB/s, 4·D flops a visible pair and head ÷ 989 TFLOP/s bf16 or 67
   TFLOP/s float32), with the float32-pipe (67 TFLOP/s) share beside it,
   and which kernel each case ran;
4h. serving path: qwen3-1.7b at full width and depth (28 layers, 1.72 B
   parameters, bf16), random weights from a seeded generator on the card;
   4 requests of 1920 prompt tokens prefilled into a 2048-slot cache, 128
   greedy ``decode_step``s, ``forward`` over the 2048 tokens, whose logits
   at positions 1920–2047 must match the decode steps' within 5e-2 ·
   max|logit| (the JAX package's bar); the prefill's last-token logits
   with the kernel against ``force_kernel(False)`` (dense attention) within
   5e-2 · max|logit|; a 32768-token ``forward(last_only=True)``; then the
   same serve on a float32 copy of the model in full float32, where decode
   must match forward within 1e-3 · max|logit|.  The kernels' counters
   are set to 0 before each drive: the tensor-core kernel's must read 28
   after each bf16 prefill and forward, the float32 kernel's 28 after each
   float32 one (the other kernel's 0), both 0 after the decode steps and
   the plain prefill; every shape
   the kernel gets must be one phase 3f held.  Prefill tokens/s, decode
   ms a token beside the weights' floor (bytes ÷ 3.35 TB/s), the kernel's
   share of each prefill (CUDA events), peak memory, and one more decode
   step and prefill under ``torch.profiler``: the host's operator count
   and the device's busy time in each;
5. CLI: ``repro_torch.launch.solve.main`` at n = 16384 with cg, with lu and
   with ``--method ca_cg --s 4`` on the kernels, and at ``--m 32768 --n
   8192`` with qr.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device-memory rate
FP32_FLOPS_PER_S = 67e12             # H100 SXM float32, outside tensor cores
N_MAIN = 16384
KERNEL_SIZES = (N_MAIN, N_MAIN + 130, 1 << 24)
TIMED_LAUNCHES = 200
HOST_TIMED_CALLS = 400               # under the launch queue's depth
HOST_ROUNDS = 5
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
NB_DIRECT = 128
TRSM_WIDE_N = 20480                  # 160 block rows of 128: more than SMs
DIRECT_TIMED_LAUNCHES = 20
BACKWARD_ERROR_FACTOR = 10.0
DIRECT_KERNEL_RECORD = {
    "lu_panel_update": {
        "source": "src/repro_torch/kernels/csrc/factor_fused.cu",
        "replaces": "src/repro/kernels/factor_fused.py:95"},
    "cholesky_panel_update": {
        "source": "src/repro_torch/kernels/csrc/factor_fused.cu",
        "replaces": "src/repro/kernels/factor_fused.py:162"},
    "trsm": {
        "source": "src/repro_torch/kernels/csrc/trsm.cu",
        "replaces": "src/repro/kernels/trsm.py:79"},
}
# (method, system, kernels whose counters must rise)
DIRECT_MAIN_PATH = (
    ("lu", "dominant", ("lu_panel_update", "trsm")),
    ("lu", "gaussian", ("lu_panel_update", "trsm")),
    ("cholesky", "spd", ("cholesky_panel_update", "trsm")),
)
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


SPARSE_GRID = 128                    # 3-D Poisson on a 128³ grid
SPARSE_NB = 32                       # BSR.from_dense's default brick size
SPMV_TIMED_LAUNCHES = 50
FP64_FLOPS_PER_S = 34e12             # H100 SXM float64, outside tensor cores
SPARSE_MAXITER = 3000                # matvecs of the backend="ref" run
GMRES_RESTART = 32
WITNESS_SEEDS = (1, 2, 3, 4)          # right-hand sides of the 64³ witness
SPMV_RECORD = {"source": "src/repro_torch/kernels/csrc/spmv.cu",
               "replaces": "src/repro/kernels/spmv.py:102"}
# (method, precond, grid, dtype, Krylov kernel whose counter must rise)
SPARSE_MAIN_PATH = (
    ("cg", None, SPARSE_GRID, "float32", "fused_cg_update"),
    ("pipelined_cg", None, SPARSE_GRID, "float32", "fused_pipelined_dots"),
    ("bicg", None, SPARSE_GRID, "float32", "fused_cg_update"),
    ("bicgstab", None, SPARSE_GRID, "float32", "fused_cg_update"),
    ("gmres", None, SPARSE_GRID, "float32", None),
    ("cg", "jacobi", SPARSE_GRID, "float32", "fused_cg_update"),
    ("cg", "block_jacobi", SPARSE_GRID, "float32", "fused_cg_update"),
    ("cg", None, SPARSE_GRID, "float64", None),
    ("cg", "ssor", 32, "float32", "fused_cg_update"),
)


LS_M, LS_N = 32768, 8192           # the least-squares path's system
NB_LS = 128
LS_NOISE = 1e-3                      # b = A x* + LS_NOISE · Gaussian
LS_KERNEL_RECORD = {
    "matmul": {"source": "src/repro_torch/kernels/csrc/gemm.cu",
               "replaces": "src/repro/kernels/gemm.py:55"},
    "qr_panel_update": {"source": "src/repro_torch/kernels/csrc/qr_fused.cu",
                        "replaces": "src/repro/kernels/qr_fused.py:83"},
}


# (method, s, system, dtype, gated): system "spd" / "nonsym" dense at
# N_MAIN, or "poisson" on the SPARSE_GRID³ BSR (SPARSE_GRID // 2 where
# backend="ref" does not converge there).  float32 ca_cg at s = 4 on the
# dense SPD system is decided by rounding in both packages (its iteration
# count and stop move with the Gram matrix's summation order: ROADMAP §3),
# so it runs as a witness: not held to backend="ref", but its returned best
# iterate is held to WITNESS_RESIDUAL_LIMIT; s = 2 is held.
S_STEP_MAIN_PATH = (
    ("ca_cg", 2, "spd", "float32", True),
    ("ca_cg", 4, "spd", "float32", False),
    ("ca_gmres", 4, "nonsym", "float32", True),
    ("ca_gmres", 8, "nonsym", "float32", True),
    ("ca_cg", 2, "poisson", "float32", True),
    ("ca_cg", 4, "poisson", "float32", True),
    ("ca_gmres", 4, "poisson", "float32", True),
    ("ca_cg", 4, "poisson", "float64", True),
)
# the witness's true relative residual: kernel 3's readings at s = 4 on the
# dense SPD system reach 2.1e-3 (PERF.md, PR 17), cuBLAS's 4.8e-3
WITNESS_RESIDUAL_LIMIT = 1e-2


def _gram_rows(method: str, s: int) -> int:
    """k of the (k, n) basis a method's block_dots takes: ca_cg's
    [p, …, Aˢp, r, …, Aˢ⁻¹r], ca_gmres's [v, …, Aˢv]."""
    return 2 * s + 1 if method == "ca_cg" else s + 1


# kernel 3's shapes on the main path: each float32 entry's k at its grid's
# n (the Poisson entries at both grids they may run on), and k = 17
# (s = 8 of ca_cg), which the CLI accepts but the main path does not run;
# phase 4f fails if the kernel gets a shape outside this list
GRAM_SHAPES = tuple(sorted({
    (_gram_rows(method, s), n)
    for method, s, name, dtype, _ in S_STEP_MAIN_PATH if dtype == "float32"
    for n in ((SPARSE_GRID ** 3, (SPARSE_GRID // 2) ** 3)
              if name == "poisson" else (N_MAIN,))})) + (
    (17, N_MAIN), (17, SPARSE_GRID ** 3))
GRAM_OFF_PATH_K = 17
PROFILED_CALLS = 20                  # calls a torch.profiler trace counts
GRAM_RECORD_SHAPE = (9, SPARSE_GRID ** 3)   # ca_cg s = 4 on the 128³ BSR
GRAM_RECORD = {"source": "src/repro_torch/kernels/csrc/krylov_fused.cu",
               "replaces": "src/repro/kernels/krylov_fused.py:240"}
BF16_FLOPS_PER_S = 989e12            # H100 SXM bf16, dense tensor cores
SERVE_ARCH = "qwen3-1.7b"            # full width and depth
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE = 4, 1920, 2048   # 15 × 128 prompt
SERVE_DECODE = SERVE_CACHE - SERVE_PROMPT                # greedy tokens
LONG_PREFILL = 32768                 # prefill_32k's length, batch 32 → 1
SERVE_SEED = 18
LAYER_LAUNCHES = 28                  # one kernel launch a layer a prefill
BF16_LOGIT_TOL = 5e-2                # of max|logit|: tests/test_models.py
F32_LOGIT_TOL = 1e-3                 # of max|logit|, the float32 copy
# kernel 10's shapes: (label, B, Hq, Hkv, Tq, Tk, D, causal, window,
# dtype); the serving phase 4h fails on a call whose shape is not here
ATTENTION_CASES = (
    ("qwen3 prefill", 4, 16, 8, 2048, 2048, 128, True, None, "bfloat16"),
    ("qwen3 serve prefill", 4, 16, 8, 1920, 1920, 128, True, None,
     "bfloat16"),
    ("qwen3 float32 copy", 4, 16, 8, 2048, 2048, 128, True, None,
     "float32"),
    ("qwen3 float32 copy prefill", 4, 16, 8, 1920, 1920, 128, True, None,
     "float32"),
    ("tinyllama (group 8)", 4, 32, 4, 2048, 2048, 64, True, None,
     "bfloat16"),
    ("hymba window", 1, 25, 5, 4096, 4096, 64, True, 1024, "bfloat16"),
    ("decode offset", 1, 16, 8, 128, 2048, 128, True, None, "bfloat16"),
    ("float32 case", 2, 8, 2, 512, 512, 112, False, None, "float32"),
    ("long prefill", 1, 16, 8, LONG_PREFILL, LONG_PREFILL, 128, True, None,
     "bfloat16"),
)
ATTENTION_RECORD_CASE = "qwen3 prefill"
ATTENTION_ROWS = 256                 # the plain version's rows at T = 32768
ATTENTION_PLAIN_BYTES = 16e9         # largest float32 score tensor held
# one rounding of a float32 result to the output type, and float32 slack
ATTENTION_ROUNDING = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
ATTENTION_F32_SLACK = 1e-5
# kernel 10's two CUDA kernels: (record name, launch counter, source, the
# 3f case of its record)
ATTENTION_KERNELS = (
    ("flash_attention", "flash_attention_wgmma",
     "src/repro_torch/kernels/csrc/attention_wgmma.cu", ATTENTION_RECORD_CASE),
    ("flash_attention_f32", "flash_attention_f32",
     "src/repro_torch/kernels/csrc/attention.cu", "qwen3 float32 copy"))
ATTENTION_REPLACES = "src/repro/kernels/attention.py:110"


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


def host_us(torch, fn, calls: int = HOST_TIMED_CALLS,
            rounds: int = HOST_ROUNDS) -> float:
    """Host-clock µs a call of ``fn`` over ``calls`` calls that only
    enqueue work (few enough that the launch queue never fills), after a
    warm-up, the least of ``rounds`` rounds (the host's cores are shared,
    so other work only adds to a round): the wrapper's host cost, which
    sets a back-to-back time wherever it exceeds the device's."""
    for _ in range(10):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - start)
    torch.cuda.synchronize()
    return 1e6 * best / calls


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
    names = ("krylov_fused", "factor_fused", "trsm", "spmv", "gemm",
             "qr_fused", "attention", "attention_wgmma")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        paths = list(pool.map(_build.build, names))
    for name, path in zip(names, paths):
        _build.library(name)
        where = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
        print(f"[build] {name}: {where}")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line \
                    or "entry function" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] seconds {time.perf_counter() - t0:.3f}")


def _bits(torch, t) -> str:
    """A tensor's bits: a 0-d float32 as its int32, else the first 16 hex
    digits of the SHA-256 of its bytes."""
    if t.ndim == 0:
        return f"0x{int(t.view(torch.int32)) & 0xffffffff:08x}"
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


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
            wrapper_us = host_us(torch, lambda: kernel(*args))
            # after the timings: a trace can leave launches slower.
            # torch.profiler drops a kernel's record now and then, never
            # adds one
            events = _cuda_kernel_events(torch, lambda: kernel(*args),
                                         PROFILED_CALLS)
            per_call = len(events) / PROFILED_CALLS
            kinds = len({kname for kname, _ in events})
            nbytes = KERNEL_RECORD[name]["streams"] * 4 * n
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(name, n)] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "kernels_a_call": per_call,
                               "kernel_kinds": kinds}
            print(f"[kernel] {name} n={n} max_abs_err={err:.3e} "
                  f"bitwise_rerun=True ms={ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={bound_ms:.6f} bytes={nbytes} "
                  f"library_ms=null (no single PyTorch call computes it) "
                  f"cuda_kernels_a_call={per_call:g} "
                  f"kernel_device_us={_kernel_us(events)} "
                  f"host_us_a_call={wrapper_us:.3f} "
                  f"bits={','.join(_bits(torch, t) for t in got)}")
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


def phase_main_path(torch) -> tuple[dict, float]:
    """The Krylov main path; returns the launches and steady cg's median
    time per iteration on the kernels."""
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
    return launches, statistics.median(steady["cuda"])


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work on the card, in ms, and what sets it:
    max(flops over the float32 peak, bytes over the memory rate)."""
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _panel_base(torch, kind: str, n: int):
    """A Gaussian working matrix (LU) or the SPD ``g gᵀ/n + 4I`` (Cholesky)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(len(kind))
    a = torch.randn(n, n, generator=g, device=dev)
    if kind == "cholesky_panel_update":
        a = a @ a.T / n
        a.diagonal().add_(4.0)
    return a, g


def _panel_step(torch, kind, base, g, k, nb):
    """``base`` with a factored diagonal block at (k, k), and its inverse,
    as the factorizations hand them to the kernel."""
    dev = base.device
    a = base.clone()
    eye = torch.eye(nb, device=dev)
    if kind == "cholesky_panel_update":
        lkk = torch.linalg.cholesky(a[k:k + nb, k:k + nb])
        a[k:k + nb, k:k + nb] = lkk
        return a, torch.linalg.solve_triangular(lkk, eye, upper=False)
    l11 = torch.tril(torch.randn(nb, nb, generator=g, device=dev), -1) / nb \
        + eye
    a[k:k + nb, k:k + nb] = l11 + torch.triu(a[k:k + nb, k:k + nb])
    return a, torch.linalg.solve_triangular(l11, eye, upper=False,
                                            unitriangular=True)


def panel_update_close(torch, got, want, a_in) -> tuple[bool, float]:
    """The tolerance of a panel update against its plain version.  The
    update changes A by far less than A's entries in the SPD case (about
    1e-3 against a diagonal of 4), so a fixed atol would pass a kernel that
    skips part of it.  The change itself is held instead: |got − want| ≤
    1e-5·max|want − a_in| + 2.5e-7·|want| (two float32 ulps of the
    result).  Returns (ok, atol)."""
    atol = 1e-5 * float((want - a_in).abs().max())
    return torch.allclose(got, want, rtol=2.5e-7, atol=atol), atol


def _panel_cost(kind: str, n: int, nb: int, k: int) -> tuple[float, float]:
    """Flops and bytes of one panel update (each input read once, each
    output written once): the nb-wide solve of the m = n − k − nb
    off-diagonal columns (rows) plus the rank-nb update of the m × m
    trailing block, both triangles read and written.  LU's update is the
    whole product; Cholesky's is symmetric, so its least work is the
    entries on and below the diagonal, m (m + 1) / 2 of 2 nb flops."""
    m = n - k - nb
    if kind == "lu_panel_update":
        flops = 2.0 * m * nb * nb + 2.0 * m * m * nb
        panel = 3                                   # R, U12, L21
    else:
        flops = 2.0 * m * nb * nb + float(m) * (m + 1) * nb
        panel = 2                                   # C, L21
    return flops, 4.0 * (nb * nb + panel * m * nb + 2 * m * m)


def _composed_step(torch, kind: str, w, k: int, nb: int):
    """The panel update as two cuBLAS calls on ``w`` in place (the
    yardstick ``composed_ms``; the port never calls them): LU's U12 =
    ``solve_triangular(L11, A12)`` then ``A22.addmm_(L21, U12, alpha=-1)``;
    Cholesky's L21 = ``solve_triangular(Lkkᵀ, C, left=False)`` then
    ``A22.addmm_(L21, L21ᵀ, alpha=-1)``."""
    diag, a22 = w[k:k + nb, k:k + nb], w[k + nb:, k + nb:]
    if kind == "lu_panel_update":
        a12, l21 = w[k:k + nb, k + nb:], w[k + nb:, k:k + nb]

        def step():
            u12 = torch.linalg.solve_triangular(diag, a12, upper=False,
                                                unitriangular=True)
            a22.addmm_(l21, u12, alpha=-1.0)
    else:
        c = w[k + nb:, k:k + nb]

        def step():
            l21 = torch.linalg.solve_triangular(diag.T, c, upper=True,
                                                left=False)
            a22.addmm_(l21, l21.T, alpha=-1.0)
    return step


def _update_us(events) -> float:
    """Mean device µs of the subtracting mainloop launch (the K = nb
    update; its kSub template argument is true) among ``events``."""
    times = [us for name, us in events if "sgemm_kernel<" in name and
             name.replace(" ", "").split("sgemm_kernel<")[1].split(",")[2]
             == "true"]
    check(bool(times), "no subtracting mainloop launch among the panel "
                       f"update's kernels: {sorted({n for n, _ in events})}")
    return statistics.fmean(times)


def _trsm_cases(torch, n: int):
    """Triangles of real factors at the main path's size: the unit-lower L
    and the U of ``a + nI``'s LU, and Cholesky's Lᵀ read as a transposed
    view (the three solves of the direct path)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(n, n, generator=g, device=dev)
    spd = a @ a.T / n
    spd.diagonal().add_(4.0)
    a.diagonal().add_(float(n))
    lu = torch.linalg.lu_factor(a).LU
    chol = torch.linalg.cholesky(spd)
    del a, spd
    return {"lower": (lu, False, True), "upper": (lu, True, False),
            "transposed": (chol.T, True, False)}, g


def _cuda_kernel_events(torch, fn, calls: int = 1) -> list:
    """(name, device µs) of the CUDA kernels that ``calls`` calls of ``fn``
    launched (``torch.profiler``).  A trace that came back with no device
    activity at all is a failed trace, not a count: it is taken again, up
    to three times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
        if events:
            return events
        time.sleep(1.0)
    raise SmokeFailure("torch.profiler recorded no CUDA activity in three "
                       "traces")


def _cuda_kernels(torch, fn, calls: int = 1) -> list:
    """Names of the CUDA kernels that ``calls`` calls of ``fn`` launched."""
    return [name for name, _ in _cuda_kernel_events(torch, fn, calls)]


def _kernel_us(events) -> str:
    """Mean device µs of each kind of kernel in ``events``, as
    ``name=µs`` pairs joined by ``;`` (a name without its namespaces and
    arguments, with its template arguments)."""
    times: dict[str, list] = {}
    for name, us in events:
        base = name.replace("(anonymous namespace)::", "")
        base = base.removeprefix("void ").split("(")[0].replace(" ", "")
        head, _, args = base.partition("<")
        short = head.split("::")[-1] + (f"<{args}" if args else "")
        times.setdefault(short, []).append(us)
    return ";".join(f"{k}={statistics.fmean(v):.3f}"
                    for k, v in times.items())


def _trsm_row(torch, label: str, t, upper: bool, unit: bool, b) -> dict:
    """One triangular solve against its plain version (rtol 1e-3, atol
    1e-3 · max|x|), bitwise-repeatable; the whole solve, the wrapper's
    diagonal inversion and the substitution kernel timed apart, beside
    the plain version, the bound and ``torch.linalg.solve_triangular``;
    the CUDA kernels of one solve counted (the substitution must be one).
    Returns the record's fields."""
    from repro_torch.kernels import ref, trsm
    kernel = trsm.trsm_upper if upper else trsm.trsm_lower
    plain = ref.trsm_upper if upper else ref.trsm_lower
    n, m = t.shape[0], (1 if b.ndim == 1 else b.shape[1])
    got = kernel(t, b, unit_diagonal=unit)
    again = kernel(t, b, unit_diagonal=unit)
    want = plain(t, b, unit_diagonal=unit)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"trsm {label}: reruns differ")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=1e-3, atol=1e-3 * scale),
        f"trsm {label}: kernel and plain version differ (max abs err {err}, "
        f"max |x| {scale})")
    del got, again, want
    names = _cuda_kernels(torch, lambda: kernel(t, b, unit_diagonal=unit))
    subst = sum(1 for name in names if "blocked_substitution" in name)
    check(subst == 1, f"trsm {label}: {subst} launches of the substitution "
                      f"kernel in one solve (kernels: {names})")
    ms = time_ms(torch, lambda: kernel(t, b, unit_diagonal=unit),
                 DIRECT_TIMED_LAUNCHES)
    linv = trsm.diag_inverses(t, rev=upper, unit_diagonal=unit)
    inversion_ms = time_ms(torch, lambda: trsm.diag_inverses(
        t, rev=upper, unit_diagonal=unit), DIRECT_TIMED_LAUNCHES)
    substitution_ms = time_ms(torch, lambda: trsm.substitute(
        t, b, linv, rev=upper), DIRECT_TIMED_LAUNCHES)
    plain_ms = time_ms(torch, lambda: plain(t, b, unit_diagonal=unit),
                       DIRECT_TIMED_LAUNCHES)
    b2 = b[:, None] if m == 1 else b
    library_ms = time_ms(torch, lambda: torch.linalg.solve_triangular(
        t, b2, upper=upper, unitriangular=unit), DIRECT_TIMED_LAUNCHES)
    flops = float(n) * n * m
    nbytes = 4.0 * (n * (n + 1) / 2 + 2 * n * m)
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"[direct-kernel] trsm {label} max_abs_err={err:.3e} "
          f"max_abs_x={scale:.3e} bitwise_rerun=True ms={ms:.6f} "
          f"inversion_ms={inversion_ms:.6f} "
          f"substitution_ms={substitution_ms:.6f} "
          f"inversion_share={inversion_ms / ms:.4f} "
          f"cuda_kernels_a_solve={len(names)} substitution_launches={subst} "
          f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
          f"bound_by={bound_by} library_ms={library_ms:.6f} "
          "(torch.linalg.solve_triangular)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _cholesky_shapes(torch, kernel, plain, base, g, k: int, nb: int):
    """The Cholesky update on an exactly symmetric A ((a + aᵀ)/2), whose
    trailing block must come out bitwise symmetric, and on A with a
    Gaussian upper triangle added, held against its plain version: each
    mirrored tile reads its own A."""
    a, linv = _panel_step(torch, "cholesky_panel_update",
                          (base + base.T) / 2, g, k, nb)
    tail = kernel(a, linv, k, nb=nb)[k + nb:, k + nb:]
    check(torch.equal(tail, tail.T), f"cholesky_panel_update k={k}: the "
          "trailing block of a symmetric A is not bitwise symmetric")
    del a, tail
    a, linv = _panel_step(torch, "cholesky_panel_update", base + torch.triu(
        torch.randn(base.shape, generator=g, device=base.device), 1), g, k,
        nb)
    got = kernel(a.clone(), linv, k, nb=nb)
    want = plain(a.clone(), linv, k, nb=nb)
    ok, atol = panel_update_close(torch, got, want, a)
    err = float((got - want).abs().max())
    check(ok, f"cholesky_panel_update k={k}, unsymmetric A: kernel and plain "
              f"version differ (max abs err {err}, atol {atol})")
    print(f"[direct-kernel] cholesky_panel_update k={k} symmetric A: "
          f"trailing block bitwise symmetric; unsymmetric A: "
          f"max_abs_err={err:.3e} atol={atol:.3e}")


def phase_direct_kernels(torch) -> dict:
    from repro_torch.kernels import factor_fused, ref
    n, nb = N_MAIN, NB_DIRECT
    record = {}
    _gemm_sass(("factor_fused",), "direct-kernel")
    for kind in ("lu_panel_update", "cholesky_panel_update"):
        kernel, plain = getattr(factor_fused, kind), getattr(ref, kind)
        base, g = _panel_base(torch, kind, n)
        for k in (0, n // 2, n - 2 * nb):
            a, linv = _panel_step(torch, kind, base, g, k, nb)
            got = kernel(a.clone(), linv, k, nb=nb)
            again = kernel(a.clone(), linv, k, nb=nb)
            want = plain(a.clone(), linv, k, nb=nb)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{kind} k={k}: reruns differ")
            err = float((got - want).abs().max())
            ok, atol = panel_update_close(torch, got, want, a)
            check(ok, f"{kind} k={k}: kernel and plain version differ (max "
                      f"abs err {err}, atol {atol})")
            del got, again, want
            if kind == "cholesky_panel_update":
                _cholesky_shapes(torch, kernel, plain, base, g, k, nb)
            w = a                  # timed calls update w in place
            events = _cuda_kernel_events(
                torch, lambda: kernel(w, linv, k, nb=nb), PROFILED_CALLS)
            ms = time_ms(torch, lambda: kernel(w, linv, k, nb=nb),
                         DIRECT_TIMED_LAUNCHES)
            plain_ms = time_ms(torch, lambda: plain(w, linv, k, nb=nb),
                               DIRECT_TIMED_LAUNCHES)
            composed_ms = time_ms(torch, _composed_step(torch, kind, w, k,
                                                        nb),
                                  DIRECT_TIMED_LAUNCHES)
            flops, nbytes = _panel_cost(kind, n, nb, k)
            bound_ms, bound_by = _bound(flops, nbytes)
            m = n - k - nb
            update_flops = (2.0 * m * m * nb if kind == "lu_panel_update"
                            else float(m) * (m + 1) * nb)
            update_us = _update_us(events)
            print(f"[direct-kernel] {kind} n={n} nb={nb} k={k} "
                  f"max_abs_err={err:.3e} bitwise_rerun=True ms={ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
                  f"bound_by={bound_by} flops={flops:.6e} bytes={nbytes:.6e} "
                  f"achieved_tflops={flops / ms / 1e9:.3f} "
                  "library_ms=null (no single PyTorch call computes it) "
                  f"composed_ms={composed_ms:.6f} (solve_triangular + "
                  f"addmm_, cuBLAS) "
                  f"cuda_kernels_a_call={len(events) / PROFILED_CALLS:g} "
                  f"kernel_device_us={_kernel_us(events)} "
                  f"update_device_us={update_us:.3f} "
                  f"update_tflops={update_flops / update_us / 1e6:.3f}")
            if k == 0:             # the record: the largest step
                record[kind] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": None}
            del a, w
        del base
    cases, g = _trsm_cases(torch, n)
    for mode, (t, upper, unit) in cases.items():
        for m in (1, 128):
            b = torch.randn(*((n,) if m == 1 else (n, m)), generator=g,
                            device="cuda")
            row = _trsm_row(torch, f"{mode} unit={unit} n={n} m={m}", t,
                            upper, unit, b)
            if mode == "lower" and m == 1:   # the record: LU's first solve
                record["trsm"] = row
    del cases
    # more block rows (160) than SMs: units wait on units that CTAs taken
    # later hold; well-conditioned random triangles
    n_wide = TRSM_WIDE_N
    g = torch.Generator(device="cuda").manual_seed(n_wide)
    tri = torch.randn(n_wide, n_wide, generator=g, device="cuda") \
        * (0.5 / n_wide ** 0.5)
    tri.diagonal().add_(2.0)
    low = torch.tril(tri)
    del tri
    for mode, t, upper in (("lower", low, False),
                           ("upper", torch.triu(low.T.contiguous()), True),
                           ("transposed", low.T, True)):
        for m in (1, 3):
            b = torch.randn(*((n_wide,) if m == 1 else (n_wide, m)),
                            generator=g, device="cuda")
            _trsm_row(torch, f"{mode} unit=False n={n_wide} m={m}", t, upper,
                      False, b)
        del t
    del low
    torch.cuda.empty_cache()
    return record


def _direct_systems(torch, n: int):
    """A plain Gaussian ``a`` (LU pivots on it), the diagonally dominant
    ``a + nI`` (LU never pivots) and the SPD ``a aᵀ/n + 4I``, symmetrized
    so that it is exactly symmetric (Cholesky's input check); two Gaussian
    right-hand sides."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    b2 = torch.randn(n, generator=g, device=dev)
    spd = a @ a.T / n
    spd.diagonal().add_(4.0)
    spd = (spd + spd.T) / 2
    dominant = a.clone()
    dominant.diagonal().add_(float(n))
    return {"gaussian": a, "dominant": dominant, "spd": spd}, b, b2


def _backward_error(a, b, x) -> float:
    """Normwise backward error ‖b − Ax‖∞ / (‖A‖∞‖x‖∞ + ‖b‖∞), in float64."""
    a64, b64, x64 = a.double(), b.double(), x.double()
    r = b64 - a64 @ x64
    return float(r.abs().max() / (a64.abs().sum(1).max() * x64.abs().max()
                                  + b64.abs().max()))


@contextlib.contextmanager
def _recorded_shapes(ops, name, key=None):
    """Collect the shapes of the first argument (or ``key`` of the
    arguments) of every call of the ``kernels.ops`` wrapper ``name``;
    yields the set."""
    shapes, real = set(), getattr(ops, name)

    def call(v, *args, **kw):
        shapes.add(tuple(v.shape) if key is None else key(v, *args, **kw))
        return real(v, *args, **kw)

    setattr(ops, name, call)
    try:
        yield shapes
    finally:
        setattr(ops, name, real)


@contextlib.contextmanager
def _kernel_events(torch, ops, names):
    """Record a CUDA event pair around every call of the named
    ``kernels.ops`` wrappers (the factorizations call them through the
    module); yields the list of pairs."""
    events, saved = [], {name: getattr(ops, name) for name in names}

    def timed(fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events.append((start, end))
            return out
        return call

    for name, fn in saved.items():
        setattr(ops, name, timed(fn))
    try:
        yield events
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_direct_main(torch) -> dict:
    from repro_torch.core import api
    from repro_torch.kernels import factor_fused, ops, trsm
    systems, b, b2 = _direct_systems(torch, N_MAIN)

    def counts():
        return {**factor_fused.LAUNCHES, **trsm.LAUNCHES}

    factor_fused.reset_launches()
    trsm.reset_launches()
    ref_errors = {}
    for method, system, kernels in DIRECT_MAIN_PATH:
        a = systems[system]
        ref_x, ref_ms = _host_ms(torch, lambda: api.solve(
            a, b, method=method, backend="ref"))
        before = counts()
        res, solve_ms = _host_ms(torch, lambda: api.solve(
            a, b, method=method, backend="cuda", return_info=True))
        rose = {name: counts()[name] - before[name] for name in before}
        label = f"{method} system={system}"
        check(res.x.shape == b.shape and bool(torch.isfinite(res.x).all()),
              f"{label}: x is not a finite vector of shape {tuple(b.shape)}")
        err, ref_err = (_backward_error(a, b, x) for x in (res.x, ref_x))
        ref_errors[(method, system)] = ref_err
        check(err <= BACKWARD_ERROR_FACTOR * ref_err,
              f"{label}: backward error {err} > {BACKWARD_ERROR_FACTOR} x "
              f"{ref_err} (backend='ref')")
        for name in kernels:
            check(rose[name] > 0, f"{label}: {name} never launched")
        # factor once (the panel-update kernels' device time by CUDA
        # events), then apply twice (the triangular solves' device time)
        with _kernel_events(torch, ops, ("lu_panel_update",
                                         "cholesky_panel_update")) as ev:
            solve_with, factor_ms = _host_ms(torch, lambda: api.factorize(
                a, method=method, backend="cuda"))
        factor_kernel_ms = sum(s.elapsed_time(e) for s, e in ev)
        with _kernel_events(torch, ops, ("trsm_lower", "trsm_upper")) as ev:
            x1, apply_ms = _host_ms(torch, lambda: solve_with(b))
        apply_kernel_ms = sum(s.elapsed_time(e) for s, e in ev)
        x2, apply2_ms = _host_ms(torch, lambda: solve_with(b2))
        check(torch.equal(x1, res.x),
              f"{label}: factorize + apply differs from solve")
        err2 = _backward_error(a, b2, x2)
        check(err2 <= BACKWARD_ERROR_FACTOR * ref_err,
              f"{label}: second apply's backward error {err2}")
        torch.linalg.solve(a, b)                     # warm the library
        _, lib_ms = _host_ms(torch, lambda: torch.linalg.solve(a, b))
        print(f"[direct] {label} n={N_MAIN} float32 "
              f"backward_error={err:.3e} ref_backward_error={ref_err:.3e} "
              f"solve_ms={solve_ms:.3f} ref_solve_ms={ref_ms:.3f} "
              f"factor_ms={factor_ms:.3f} "
              f"factor_kernel_ms={factor_kernel_ms:.3f} "
              f"panel_loop_share={1 - factor_kernel_ms / factor_ms:.4f} "
              f"apply_ms={apply_ms:.3f} apply_kernel_ms={apply_kernel_ms:.3f} "
              f"apply2_ms={apply2_ms:.3f} apply2_backward_error={err2:.3e} "
              f"torch_linalg_solve_ms={lib_ms:.3f} launches={rose}")
    launches = counts()
    print(f"[direct] launches over the direct main path: {launches}")
    return launches, ref_errors


def _spmv_cost(bsr, k: int) -> tuple[float, float]:
    """Flops and bytes of one y = A x: the bricks, the structure and x read
    once, y written once."""
    nnzb, nb = bsr.data.shape[0], bsr.nb
    item = bsr.data.element_size()
    nbytes = item * (nnzb * nb * nb + (bsr.n_pad_cols + bsr.n_pad) * k) \
        + 4 * (nnzb + bsr.nbr + 1)
    return 2.0 * nnzb * nb * nb * k, float(nbytes)


def _spmv_bound(bsr, k: int) -> tuple[float, str]:
    flops, nbytes = _spmv_cost(bsr, k)
    peak = FP64_FLOPS_PER_S if bsr.data.element_size() == 8 \
        else FP32_FLOPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _library_spmv(torch, bsr):
    """``torch.sparse_bsr_tensor(...) @ x`` (cuSPARSE) on the same bricks, as
    a callable of x: the library's time beside the kernel's."""
    mat = torch.sparse_bsr_tensor(bsr.indptr_dev, bsr.indices_dev, bsr.data,
                                  size=(bsr.n_pad, bsr.n_pad_cols))
    return lambda x: mat @ x


def _true_csr(torch, bsr):
    """cuSPARSE CSR of the BSR's true nonzeros (not its stored zeros)."""
    e, i, j = bsr.data.nonzero(as_tuple=True)
    rows = torch.from_numpy(bsr.row_ids).to(bsr.device).long()[e] * bsr.nb \
        + i
    cols = bsr.indices_dev.long()[e] * bsr.nb + j
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), bsr.data[e, i, j],
                                  size=(bsr.n_pad, bsr.n_pad_cols))
    return coo.coalesce().to_sparse_csr()


def phase_sparse_kernels(torch) -> dict:
    import numpy as np
    from repro_torch.kernels import spmv
    from repro_torch.sparse import BSR, problems
    dev = torch.device("cuda")
    grid, nb = SPARSE_GRID, SPARSE_NB
    poisson = problems.poisson_3d_bsr(grid, nb, np.float32, device=dev)
    n = poisson.shape[0]
    fill = float((poisson.data != 0).sum()) / poisson.data.numel()
    print(f"[sparse-kernel] poisson_3d grid={grid}³ n={n} nb={nb} "
          f"nnzb={poisson.data.shape[0]} stored={poisson.nnz} "
          f"brick_fill={fill:.6f} float32_brick_bytes="
          f"{poisson.data.numel() * 4}")
    g = torch.Generator(device=dev).manual_seed(14)
    record = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        data = torch.randn(poisson.data.shape, generator=g, device=dev,
                           dtype=dtype)
        a = BSR(data, poisson.indices, poisson.indptr, poisson.shape, nb,
                device=dev)
        at = a.transpose()
        lib_a, lib_at = _library_spmv(torch, a), _library_spmv(torch, at)
        for k in (1, 4):
            x = torch.randn(*((n,) if k == 1 else (n, k)), generator=g,
                            device=dev, dtype=dtype)
            for label, mat, plain, lib in (("A", a, a.matvec, lib_a),
                                           ("A^T", at, a.matvec_t, lib_at)):
                got = spmv.bsr_matvec(mat, x)
                again = spmv.bsr_matvec(mat, x)
                want = plain(x)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"bsr_matvec {label} {dtype} k={k}: reruns differ")
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                check(bool(torch.isfinite(got).all()) and torch.allclose(
                    got, want, rtol=rtol, atol=rtol * scale),
                    f"bsr_matvec {label} {dtype} k={k}: kernel and plain "
                    f"version differ (max abs err {err}, max |y| {scale})")
                ms = time_ms(torch, lambda: spmv.bsr_matvec(mat, x),
                             SPMV_TIMED_LAUNCHES)
                plain_ms = time_ms(torch, lambda: plain(x),
                                   SPMV_TIMED_LAUNCHES)
                library_ms = time_ms(torch, lambda: lib(x),
                                     SPMV_TIMED_LAUNCHES)
                bound_ms, bound_by = _spmv_bound(mat, k)
                print(f"[sparse-kernel] bsr_matvec {label} "
                      f"{str(dtype).removeprefix('torch.')} k={k} "
                      f"max_abs_err={err:.3e} max_abs_y={scale:.3e} "
                      f"bitwise_rerun=True ms={ms:.6f} "
                      f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
                      f"bound_by={bound_by} library_ms={library_ms:.6f} "
                      "(torch.sparse_bsr_tensor @ x) "
                      f"achieved_GBps={_spmv_cost(mat, k)[1] / ms / 1e6:.1f}")
                if dtype == torch.float32 and k == 1 and label == "A":
                    record["max_abs_err"] = err
        del a, at, data, lib_a, lib_at
        torch.cuda.empty_cache()
    # the main path's call: the Poisson matrix itself, float32, one vector
    b = torch.randn(n, generator=g, device=dev)
    lib = _library_spmv(torch, poisson)
    csr = _true_csr(torch, poisson)
    check(torch.allclose(lib(b), poisson.matvec(b), rtol=1e-5, atol=1e-6)
          and torch.allclose(csr @ b, poisson.matvec(b), rtol=1e-5,
                             atol=1e-6),
          "the library products disagree with the plain product")
    ms = time_ms(torch, lambda: spmv.bsr_matvec(poisson, b),
                 SPMV_TIMED_LAUNCHES)
    plain_ms = time_ms(torch, lambda: poisson.matvec(b), SPMV_TIMED_LAUNCHES)
    library_ms = time_ms(torch, lambda: lib(b), SPMV_TIMED_LAUNCHES)
    csr_ms = time_ms(torch, lambda: csr @ b, SPMV_TIMED_LAUNCHES)
    bound_ms, bound_by = _spmv_bound(poisson, 1)
    # values, x and y in float32; column and row indices in int64, as
    # this CSR holds them
    csr_bytes = 4.0 * (csr._nnz() + 2 * n) + 8.0 * (csr._nnz() + n + 1)
    print(f"[sparse-kernel] bsr_matvec poisson float32 k=1 ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
          f"bound_by={bound_by} library_ms={library_ms:.6f} "
          "(torch.sparse_bsr_tensor @ x) "
          f"csr_true_nnz={csr._nnz()} csr_true_nnz_ms={csr_ms:.6f} "
          f"csr_true_nnz_bound_ms={csr_bytes / HBM_BYTES_PER_S * 1e3:.6f}")
    record.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms})
    return record


def _relative_residual64(torch, a64, b, x) -> float:
    """‖b − Ax‖ / ‖b‖ in float64 (``a64`` a float64 copy of the BSR)."""
    b64 = b.double()
    return float(torch.linalg.norm(b64 - a64.matvec(x.double()))
                 / torch.linalg.norm(b64))


def _poisson_system(torch, grid: int, dtype: str, seed: int):
    """The Poisson BSR on a grid³ grid on the card, its float64 copy (the
    residual check) and a Gaussian b from ``seed``, the same for both
    dtypes."""
    import numpy as np
    from repro_torch.sparse import BSR, problems
    dev = torch.device("cuda")
    a = problems.poisson_3d_bsr(grid, SPARSE_NB, np.dtype(dtype), device=dev)
    a64 = a if dtype == "float64" else BSR(
        a.data.double(), a.indices, a.indptr, a.shape, a.nb, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randn(a.shape[0], generator=g, device=dev,
                    dtype=torch.float64).to(a.dtype)
    return a, a64, b


def phase_sparse_main(torch, spmv_ms: float) -> tuple[dict, dict]:
    """The sparse main path; returns the launches and float32 cg's time per
    iteration by grid."""
    from repro_torch.core import api
    from repro_torch.kernels import krylov_fused, spmv
    systems = {}

    def system(grid, dtype):
        if (grid, dtype) not in systems:
            systems[(grid, dtype)] = _poisson_system(torch, grid, dtype, grid)
        return systems[(grid, dtype)]

    def counts():
        return {**spmv.LAUNCHES, **krylov_fused.LAUNCHES}

    cg_ms_per_iter = {}
    spmv.reset_launches()
    krylov_fused.reset_launches()
    for method, precond, grid, dtype, kernel in SPARSE_MAIN_PATH:
        maxiter = SPARSE_MAXITER // GMRES_RESTART if method == "gmres" \
            else SPARSE_MAXITER
        kw = dict(method=method, precond=precond, maxiter=maxiter,
                  return_info=True)
        a, a64, b = system(grid, dtype)
        ref_res, ref_ms = _host_ms(torch, lambda: api.solve(
            a, b, backend="ref", **kw))
        if not bool(ref_res.converged) and grid == SPARSE_GRID:
            print(f"[sparse] {method} precond={precond} {dtype}: "
                  f"backend='ref' did not converge at {grid}³ within "
                  f"maxiter={maxiter} ({ref_res.iterations} iterations, "
                  f"{ref_res.info['fail_reason']}); running at "
                  f"{grid // 2}³")
            grid //= 2
            a, a64, b = system(grid, dtype)
            ref_res, ref_ms = _host_ms(torch, lambda: api.solve(
                a, b, backend="ref", **kw))
        before = counts()
        res, solve_ms = _host_ms(torch, lambda: api.solve(
            a, b, backend="cuda", **kw))
        rose = {name: counts()[name] - before[name] for name in before}
        rel = _relative_residual64(torch, a64, b, res.x)
        it, ref_it = res.iterations, ref_res.iterations
        label = f"{method}" + (f"+{precond}" if precond else "") \
            + f" grid={grid}³ {dtype}"
        unit = "cycle" if method == "gmres" else "iter"
        print(f"[sparse] {label} n={a.shape[0]} iterations={it} "
              f"ref_iterations={ref_it} "
              f"ref_converged={bool(ref_res.converged)} "
              f"converged={bool(res.converged)} "
              f"fail_reason={res.info['fail_reason']} rel_residual={rel:.3e} "
              f"solve_ms={solve_ms:.3f} ref_solve_ms={ref_ms:.3f} "
              f"ms_per_{unit}={solve_ms / max(it, 1):.6f} "
              f"ref_ms_per_{unit}={ref_ms / max(ref_it, 1):.6f} "
              f"spmv_ms={spmv_ms:.6f} launches={rose}")
        check(bool(res.converged), f"{label}: not converged ({res.info})")
        check(rel <= RESIDUAL_LIMIT, f"{label}: residual {rel} > "
                                     f"{RESIDUAL_LIMIT}")
        check(it <= max(1.2 * ref_it, ref_it + 2),
              f"{label}: {it} iterations vs {ref_it} on backend='ref'")
        check(rose["bsr_matvec"] > 0, f"{label}: bsr_matvec never launched")
        if kernel is not None:
            check(rose[kernel] > 0, f"{label}: {kernel} never launched")
        if (method, precond, dtype) == ("cg", None, "float32"):
            cg_ms_per_iter[f"poisson {grid}³"] = solve_ms / max(it, 1)
    launches = counts()
    print(f"[sparse] launches over the sparse main path: {launches}")
    systems.clear()
    torch.cuda.empty_cache()
    return launches, cg_ms_per_iter


def phase_bicgstab_witness(torch) -> None:
    """Which kernel moves float32 BiCGSTAB's iteration count on the Poisson
    system: the solver run with each pairing of SpMV (plain, kernel 8, or a
    float64 product rounded to float32) and vector update (plain or kernel
    1); then kernel 8 in float64 against the plain float64 path, which must
    agree within max(1.2×, +2) both ways; then cuda against ref at 64³ for
    several right-hand sides.  Launches here are comparisons and count
    nowhere."""
    from repro_torch import device as _device
    from repro_torch.core import api, krylov
    from repro_torch.core.operator import DenseOperator
    from repro_torch.kernels import ops
    a, a64, b = _poisson_system(torch, SPARSE_GRID, "float32", SPARSE_GRID)
    spmvs = {"plain": a.matvec,
             "kernel8": lambda v: ops.bsr_matvec(a, v),
             "float64_rounded": lambda v: a64.matvec(v.double()).float()}
    for spmv_name, mv in spmvs.items():
        for update, backend in (("plain", "ref"), ("kernel1", "cuda")):
            op = DenseOperator(matvec=mv, backend=backend)
            with _device.full_fp32():
                res = krylov.bicgstab(op, b, maxiter=SPARSE_MAXITER)
            rel = _relative_residual64(torch, a64, b, res.x)
            print(f"[witness] bicgstab grid={SPARSE_GRID}³ float32 "
                  f"spmv={spmv_name} update={update} "
                  f"iterations={res.iterations} "
                  f"converged={bool(res.converged)} rel_residual={rel:.3e}")
    del a, spmvs
    b64 = b.double()
    its = {}
    for backend in ("ref", "cuda"):
        res = api.solve(a64, b64, method="bicgstab", backend=backend,
                        maxiter=SPARSE_MAXITER, return_info=True)
        rel = _relative_residual64(torch, a64, b64, res.x)
        its[backend] = res.iterations
        print(f"[witness] bicgstab grid={SPARSE_GRID}³ float64 "
              f"backend={backend} iterations={res.iterations} "
              f"converged={bool(res.converged)} rel_residual={rel:.3e}")
        check(bool(res.converged) and rel <= RESIDUAL_LIMIT,
              f"float64 bicgstab backend={backend}: converged="
              f"{bool(res.converged)} residual {rel}")
    lo, hi = sorted(its.values())
    check(hi <= max(1.2 * lo, lo + 2), f"float64 bicgstab: kernel 8 took "
                                       f"{its['cuda']} iterations, the plain "
                                       f"path {its['ref']}")
    del a64, b64
    for seed in WITNESS_SEEDS:
        a, a64, b = _poisson_system(torch, SPARSE_GRID // 2, "float32", seed)
        its = {backend: api.solve(a, b, method="bicgstab", backend=backend,
                                  maxiter=SPARSE_MAXITER,
                                  return_info=True).iterations
               for backend in ("ref", "cuda")}
        print(f"[witness] bicgstab grid={SPARSE_GRID // 2}³ float32 "
              f"seed={seed} iterations={its['cuda']} "
              f"ref_iterations={its['ref']}")
    torch.cuda.empty_cache()


def _ls_matrix(torch, m: int, n: int, seed: int):
    """The least-squares path's Gaussian A/√m (singular values in about
    [0.5, 1.5] at m = 4n) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(m, n, generator=g, device="cuda") / m ** 0.5, g


def _qr_update_inputs(torch, base, k: int, nb: int):
    """``base`` with its panel at column k factored by the port's panel
    QR, and that panel's active (m − k, nb) V and its T, as the
    factorization hands them to the kernel."""
    from repro_torch.core import qr
    a = base.clone()
    pan = a[k:, k:k + nb]
    taus = qr._panel_qr(pan)
    v = qr._panel_v(pan)
    t = qr._form_t(v, taus)
    return a, v, t


def _qr_update_cost(m: int, n: int, nb: int, k: int) -> tuple[float, float]:
    """Flops and bytes of one QR trailing update over the window of
    R = m − k rows and N = n − k − nb columns: W = VᵀA, Y = TᵀW, A −= VY;
    the window read and written once, V and T read once."""
    r, c = m - k, n - k - nb
    return (4.0 * r * nb * c + 2.0 * nb * nb * c,
            4.0 * (2 * r * c + r * nb + nb * nb))


def _gemm_sass(libs, tag: str) -> None:
    """Kernels 4, 5, 7, 9 and 10 in float32 stay on the float32 pipes: the
    count of tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS
    (``cuobjdump``) of each library of ``libs`` (``factor_fused``,
    ``gemm``, ``qr_fused``, ``attention``) must be 0; each kernel's
    ``FFMA`` and local-memory (``LDL`` / ``STL``, spill) counts are printed
    beside, on lines tagged ``[tag]``."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"no cuobjdump at {cuobjdump}: the float32 "
                              "mainloop's SASS cannot be checked")
    for lib in libs:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.build(lib))],
                              capture_output=True, text=True)
        check(sass.returncode == 0,
              f"cuobjdump failed on {lib}: {sass.stderr.strip()}")
        lines = sass.stdout.splitlines()
        tensor = sum(1 for line in lines
                     if "HMMA" in line or "HGMMA" in line)
        print(f"[{tag}] {lib}.cu SASS: HMMA/HGMMA instructions {tensor}")
        counts, name = {}, None    # FFMA and local loads / stores a kernel
        for line in lines:
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = [0, 0]
            elif name is not None:
                counts[name][0] += "FFMA" in line
                counts[name][1] += "LDL" in line or "STL" in line
        for name, (ffma, local) in counts.items():
            print(f"[{tag}]   {name[:70]}: FFMA {ffma}, LDL/STL {local}")
        check(tensor == 0, f"{lib}.cu's SASS holds {tensor} tensor-core "
                           "instructions")


def phase_ls_kernels(torch) -> dict:
    from repro_torch.kernels import gemm, qr_fused, ref
    m, n, nb = LS_M, LS_N, NB_LS
    record = {}
    base, g = _ls_matrix(torch, m, n, 9)
    for k in (0, n // 2, n - 2 * nb):
        a, v, t = _qr_update_inputs(torch, base, k, nb)
        got = qr_fused.qr_panel_update(a.clone(), v, t, k, nb=nb)
        again = qr_fused.qr_panel_update(a.clone(), v, t, k, nb=nb)
        want = ref.qr_panel_update(a.clone(), v, t, k, nb=nb)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"qr_panel_update k={k}: reruns "
                                       "differ")
        check(torch.equal(got[:, :k + nb], a[:, :k + nb]),
              f"qr_panel_update k={k}: wrote left of the window")
        check(torch.equal(got[:k], a[:k]),
              f"qr_panel_update k={k}: wrote above the window")
        err = float((got - want).abs().max())
        change = float((want - a).abs().max())
        atol = 1e-4 * change
        check(change > 0 and torch.allclose(got, want, rtol=1e-5, atol=atol),
              f"qr_panel_update k={k}: kernel and plain version differ (max "
              f"abs err {err}, atol {atol})")
        del got, again, want
        w = a                          # timed calls update w in place
        events = _cuda_kernel_events(torch, lambda: qr_fused.qr_panel_update(
            w, v, t, k, nb=nb), PROFILED_CALLS)
        names = [name for name, _ in events]
        win = w[k:, k + nb:]
        ms = time_ms(torch, lambda: qr_fused.qr_panel_update(w, v, t, k,
                                                             nb=nb),
                     DIRECT_TIMED_LAUNCHES)
        plain_ms = time_ms(torch, lambda: ref.qr_panel_update(w, v, t, k,
                                                              nb=nb),
                           DIRECT_TIMED_LAUNCHES)
        library_ms = time_ms(torch, lambda: torch.addmm(
            win, v, torch.mm(t.T, torch.mm(v.T, win)), alpha=-1.0),
            DIRECT_TIMED_LAUNCHES)
        flops, nbytes = _qr_update_cost(m, n, nb, k)
        bound_ms, bound_by = _bound(flops, nbytes)
        print(f"[ls-kernel] qr_panel_update m={m} n={n} nb={nb} k={k} "
              f"max_abs_err={err:.3e} max_abs_change={change:.3e} "
              f"bitwise_rerun=True ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} bound_by={bound_by} "
              f"flops={flops:.6e} bytes={nbytes:.6e} "
              f"achieved_tflops={flops / ms / 1e9:.3f} "
              f"library_ms={library_ms:.6f} (three cuBLAS calls: mm, mm, "
              f"addmm) cuda_kernels_a_call={len(names) / PROFILED_CALLS:g} "
              f"kernel_kinds={len(set(names))} "
              f"kernel_device_us={_kernel_us(events)}")
        if k == 0:                     # the record: the largest step
            record["qr_panel_update"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
        del a, w, win
    _gemm_sass(("gemm", "qr_fused"), "ls-kernel")
    # the GEMM at the unfused QR's three products at k = 0 (V is the
    # window's V, the first panel of the matrix) and at the unfused LU's
    # trailing update at n = 16384, k = 0 (views of one matrix)
    a, v, t = _qr_update_inputs(torch, base, 0, nb)
    del base
    wq = torch.randn(nb, n - nb, generator=g, device="cuda")
    lu_a = torch.randn(N_MAIN, N_MAIN, generator=g, device="cuda")
    cases = (("qr V^T A", v.T, a[:, nb:]), ("qr T^T W", t.T, wq),
             ("qr V Y", v, wq),
             ("lu L21 U12", lu_a[nb:, :nb], lu_a[:nb, nb:]))
    for label, x, y in cases:
        got = gemm.matmul(x, y)
        again = gemm.matmul(x, y)
        want = ref.matmul(x, y)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"matmul {label}: reruns differ")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=1e-4, atol=1e-4 * scale),
            f"matmul {label}: kernel and plain version differ (max abs err "
            f"{err}, max |C| {scale})")
        del got, again, want
        ms = time_ms(torch, lambda: gemm.matmul(x, y), DIRECT_TIMED_LAUNCHES)
        plain_ms = time_ms(torch, lambda: ref.matmul(x, y),
                           DIRECT_TIMED_LAUNCHES)
        library_ms = time_ms(torch, lambda: torch.matmul(x, y),
                             DIRECT_TIMED_LAUNCHES)
        (mm, kk), nn = x.shape, y.shape[1]
        flops = 2.0 * mm * nn * kk
        bound_ms, bound_by = _bound(flops, 4.0 * (mm * kk + kk * nn
                                                  + mm * nn))
        print(f"[ls-kernel] matmul {label} M={mm} N={nn} K={kk} "
              f"max_abs_err={err:.3e} max_abs_c={scale:.3e} "
              f"bitwise_rerun=True ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} bound_by={bound_by} "
              f"achieved_tflops={flops / ms / 1e9:.3f} "
              f"library_ms={library_ms:.6f} (torch.matmul, cuBLAS; the "
              "plain version is the same call)")
        if label == "qr V^T A":        # the record: the few-tile product
            record["matmul"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
    del a, v, t, wq, lu_a, cases
    torch.cuda.empty_cache()
    return record


def phase_ls_main(torch, direct_ref_errors: dict) -> dict:
    """The least-squares path, then the unfused LU / Cholesky route; the
    QR update, GEMM and triangular-solve counters are set to 0 before and
    read after."""
    from repro_torch.core import api, cholesky, lu, qr
    from repro_torch.kernels import gemm, ops, qr_fused, trsm
    from repro_torch.launch.solve import normal_residual
    m, n = LS_M, LS_N
    a, g = _ls_matrix(torch, m, n, 16)
    x_star = torch.randn(n, generator=g, device="cuda")
    b = a @ x_star + LS_NOISE * torch.randn(m, generator=g, device="cuda")
    b2 = torch.randn(m, generator=g, device="cuda")

    def counts():
        return {**qr_fused.LAUNCHES, **gemm.LAUNCHES, **trsm.LAUNCHES}

    def gate(label, x, ref_res, bb=b):
        check(x.shape == (n,) and bool(torch.isfinite(x).all()),
              f"{label}: x is not a finite vector of shape ({n},)")
        res = normal_residual(a, bb, x)
        check(res <= BACKWARD_ERROR_FACTOR * ref_res,
              f"{label}: normal-equations residual {res} > "
              f"{BACKWARD_ERROR_FACTOR} x {ref_res} (backend='ref')")
        return res

    for mod in (qr_fused, gemm, trsm):
        mod.reset_launches()
    label = f"qr m={m} n={n} float32"
    ref_solve, ref_factor_ms = _host_ms(torch, lambda: api.factorize(
        a, method="qr", backend="ref"))
    ref_x, ref_apply_ms = _host_ms(torch, lambda: ref_solve(b))
    ref_ms = ref_factor_ms + ref_apply_ms
    ref_res = normal_residual(a, b, ref_x)
    ref_res2 = normal_residual(a, b2, ref_solve(b2))
    del ref_solve
    before = counts()
    res, solve_ms = _host_ms(torch, lambda: api.solve(
        a, b, method="qr", backend="cuda", return_info=True))
    rose = {k: counts()[k] - before[k] for k in before}
    nres = gate(label, res.x, ref_res)
    for name in ("qr_panel_update", "trsm"):
        check(rose[name] > 0, f"{label}: {name} never launched")
    with _kernel_events(torch, ops, ("qr_panel_update",)) as ev:
        solve_with, factor_ms = _host_ms(torch, lambda: api.factorize(
            a, method="qr", backend="cuda"))
    factor_kernel_ms = sum(s.elapsed_time(e) for s, e in ev)
    with _kernel_events(torch, ops, ("trsm_upper",)) as ev:
        x1, apply_ms = _host_ms(torch, lambda: solve_with(b))
    apply_kernel_ms = sum(s.elapsed_time(e) for s, e in ev)
    x2, apply2_ms = _host_ms(torch, lambda: solve_with(b2))
    check(torch.equal(x1, res.x), f"{label}: factorize + apply differs "
                                  "from solve")
    gate(f"{label} second apply", x2, ref_res2, b2)
    torch.linalg.lstsq(a, b[:, None], driver="gels")      # warm the library
    lib, lib_ms = _host_ms(torch, lambda: torch.linalg.lstsq(
        a, b[:, None], driver="gels"))
    lib_res = normal_residual(a, b, lib.solution[:, 0])
    err_x = float(torch.linalg.norm(res.x - x_star)
                  / torch.linalg.norm(x_star))
    print(f"[ls] {label} normal_residual={nres:.3e} "
          f"ref_normal_residual={ref_res:.3e} rel_err_vs_x_star={err_x:.3e} "
          f"solve_ms={solve_ms:.3f} ref_solve_ms={ref_ms:.3f} "
          f"ref_factor_ms={ref_factor_ms:.3f} "
          f"factor_ms={factor_ms:.3f} factor_kernel_ms={factor_kernel_ms:.3f} "
          f"panel_loop_share={1 - factor_kernel_ms / factor_ms:.4f} "
          f"apply_ms={apply_ms:.3f} apply_kernel_ms={apply_kernel_ms:.3f} "
          f"apply2_ms={apply2_ms:.3f} "
          f"torch_linalg_lstsq_gels_ms={lib_ms:.3f} "
          f"lstsq_normal_residual={lib_res:.3e} launches={rose}")
    del solve_with, lib, x1, x2
    # the unfused route: the three GEMM products a step
    before = counts()
    st, unfused_ms = _host_ms(torch, lambda: qr.qr_factor(
        a, backend="cuda", fuse_panel=False))
    rose = {k: counts()[k] - before[k] for k in before}
    x = qr.qr_apply(dataclasses.replace(st, m0=m, n0=n), b, backend="cuda")
    nres = gate(f"{label} fuse_panel=False", x, ref_res)
    check(rose["matmul"] > 0 and rose["qr_panel_update"] == 0,
          f"{label} fuse_panel=False: launches {rose}")
    print(f"[ls] {label} fuse_panel=False normal_residual={nres:.3e} "
          f"factor_ms={unfused_ms:.3f} launches={rose}")
    del st, x
    # the iterative least-squares methods
    for method in ("lsqr", "cgls"):
        runs = {}
        for backend in ("ref", "cuda"):
            r, ms = _host_ms(torch, lambda: api.solve(
                a, b, method=method, backend=backend, return_info=True))
            runs[backend] = (r, ms)
        (r, ms), (rr, rms) = runs["cuda"], runs["ref"]
        it, ref_it = r.iterations, rr.iterations
        nres = normal_residual(a, b, r.x)
        print(f"[ls] {method} m={m} n={n} float32 iterations={it} "
              f"ref_iterations={ref_it} converged={bool(r.converged)} "
              f"fail_reason={r.info['fail_reason']} "
              f"normal_residual={nres:.3e} solve_ms={ms:.3f} "
              f"ref_solve_ms={rms:.3f} "
              f"ms_per_iter={ms / max(it, 1):.6f}")
        check(bool(r.converged) and bool(rr.converged),
              f"{method}: not converged ({r.info}, ref {rr.info})")
        check(it <= max(1.2 * ref_it, ref_it + 2),
              f"{method}: {it} iterations vs {ref_it} on backend='ref'")
    del a, b, b2
    torch.cuda.empty_cache()
    # the unfused LU / Cholesky route at the direct path's n = 16384
    systems, bd, _ = _direct_systems(torch, N_MAIN)
    for method, system in (("lu", "dominant"), ("cholesky", "spd")):
        ad = systems[system]
        before = counts()
        if method == "lu":
            (fac, perm), ms = _host_ms(torch, lambda: lu.lu_factor(
                ad, backend="cuda", fuse_panel=False))
            x = lu.lu_solve(fac, perm, bd, backend="cuda")
        else:
            fac, ms = _host_ms(torch, lambda: cholesky.cholesky_factor(
                ad, backend="cuda", fuse_panel=False))
            x = cholesky.cholesky_solve(fac, bd, backend="cuda")
        rose = {k: counts()[k] - before[k] for k in before}
        ref_err = direct_ref_errors[(method, system)]
        err = _backward_error(ad, bd, x)
        lbl = f"{method} system={system} n={N_MAIN} fuse_panel=False"
        print(f"[ls] {lbl} backward_error={err:.3e} "
              f"ref_backward_error={ref_err:.3e} factor_ms={ms:.3f} "
              f"launches={rose}")
        check(bool(torch.isfinite(x).all())
              and err <= BACKWARD_ERROR_FACTOR * ref_err,
              f"{lbl}: backward error {err} > {BACKWARD_ERROR_FACTOR} x "
              f"{ref_err} (backend='ref')")
        check(rose["matmul"] > 0 and rose["trsm"] > 0,
              f"{lbl}: launches {rose}")
        del fac, x
    del systems
    torch.cuda.empty_cache()
    launches = counts()
    print(f"[ls] launches over the least-squares path and the unfused "
          f"route: {launches}")
    return launches


def phase_gram_kernel(torch) -> dict:
    """Kernel 3 against its plain version at the s-step path's shapes."""
    from repro_torch.kernels import krylov_fused, ref
    dev = torch.device("cuda")
    record = {}
    stream_max_k = krylov_fused._lib().gram_stream_max_k   # one launch
    for k, n in GRAM_SHAPES:
        g = torch.Generator(device=dev).manual_seed(k * 31 + n)
        v = torch.randn(k, n, generator=g, device=dev)
        got = krylov_fused.fused_gram(v)
        again = krylov_fused.fused_gram(v)
        want = ref.fused_gram(v)
        torch.cuda.synchronize()
        label = f"fused_gram k={k} n={n}"
        where = " (outside the main path)" if k == GRAM_OFF_PATH_K else ""
        check(torch.equal(got, again), f"{label}: reruns differ")
        check(torch.equal(got, got.T), f"{label}: G is not symmetric")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=1e-5, atol=1e-5 * scale),
            f"{label}: kernel and plain version differ (max abs err {err}, "
            f"max |G| {scale})")
        # torch.profiler drops a kernel's record now and then, never adds
        # one: one launch a call is one kind of kernel, at most once a call
        events = _cuda_kernel_events(
            torch, lambda: krylov_fused.fused_gram(v), PROFILED_CALLS)
        names = [name for name, _ in events]
        per_call = len(names) / PROFILED_CALLS
        kinds = sorted(set(names))
        check(k > stream_max_k or (len(kinds) == 1 and per_call <= 1),
              f"{label}: {per_call} CUDA kernels a call of {len(kinds)} "
              f"kinds, not one ({kinds})")
        ms = time_ms(torch, lambda: krylov_fused.fused_gram(v))
        plain_ms = time_ms(torch, lambda: ref.fused_gram(v))
        library_ms = time_ms(torch, lambda: torch.mm(v, v.T))
        wrapper_us = host_us(torch, lambda: krylov_fused.fused_gram(v))
        library_us = host_us(torch, lambda: torch.mm(v, v.T))
        flops, nbytes = 2.0 * k * k * n, 4.0 * (k * n + k * k)
        bound_ms, bound_by = _bound(flops, nbytes)
        print(f"[gram-kernel] {label}{where} max_abs_err={err:.3e} "
              f"max_abs_g={scale:.3e} bitwise_rerun=True ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
              f"bound_by={bound_by} library_ms={library_ms:.6f} "
              f"(torch.mm(v, v.T), cuBLAS) "
              f"achieved_GBps={nbytes / ms / 1e6:.1f} "
              f"bound_share={bound_ms / ms:.4f} "
              f"cuda_kernels_a_call={per_call:g} kernel_kinds={len(kinds)} "
              f"kernel_device_us={_kernel_us(events)} "
              f"host_us_a_call={wrapper_us:.3f} "
              f"library_host_us_a_call={library_us:.3f}")
        if (k, n) == GRAM_RECORD_SHAPE:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
        del v, got, again, want
    torch.cuda.empty_cache()
    return record


def _s_step_maxiter(method: str, s: int) -> int:
    """The reference run's cap of about SPARSE_MAXITER matvecs: ca_cg
    counts inner iterations at 2s − 1 matvecs an outer step of s, ca_gmres
    cycles of s + 1 matvecs."""
    if method == "ca_cg":
        return SPARSE_MAXITER * s // (2 * s - 1)
    return SPARSE_MAXITER // (s + 1)


def phase_s_step_main(torch, cg_ms_per_iter: dict) -> dict:
    """The s-step methods through ``api.solve``; the Gram, SpMV and Krylov
    counters are set to 0 before and read after.  ``cg_ms_per_iter`` is
    cg's time per iteration from phases 4 and 4c, printed beside."""
    from repro_torch.core import api
    from repro_torch.core.operator import DenseOperator
    from repro_torch.kernels import krylov_fused, ops, spmv
    from repro_torch.launch.solve import relative_residual
    dense, b_dense = _systems(torch, N_MAIN)
    sparse = {}

    def system(name, grid, dtype):
        if name != "poisson":
            return dense[name], None, b_dense
        if (grid, dtype) not in sparse:
            sparse[(grid, dtype)] = _poisson_system(torch, grid, dtype, grid)
        return sparse[(grid, dtype)]

    def counts():
        return {**krylov_fused.LAUNCHES, **spmv.LAUNCHES}

    # first calls of the small dense factorizations (cuSOLVER set-up) out
    # of the timed solves
    for method in ("ca_cg", "ca_gmres"):
        api.solve(dense["spd"][:64, :64], b_dense[:64], method=method, s=2)
    krylov_fused.reset_launches()
    spmv.reset_launches()
    with _recorded_shapes(ops, "fused_gram") as gram_shapes:
        for method, s, name, dtype, gated in S_STEP_MAIN_PATH:
            grid = SPARSE_GRID if name == "poisson" else None
            kw = dict(method=method, s=s, return_info=True)
            if name == "poisson":
                kw["maxiter"] = _s_step_maxiter(method, s)
            a, a64, b = system(name, grid, dtype)
            ref_res, ref_ms = _host_ms(torch, lambda: api.solve(
                a, b, backend="ref", **kw))
            moved = ""
            if name == "poisson" and not bool(ref_res.converged):
                moved = (f" (backend='ref' did not converge at {grid}³ "
                         f"within maxiter={kw['maxiter']}: "
                         f"{ref_res.iterations} iterations, "
                         f"{ref_res.info['fail_reason']}; run at "
                         f"{grid // 2}³)")
                grid //= 2
                a, a64, b = system(name, grid, dtype)
                ref_res, ref_ms = _host_ms(torch, lambda: api.solve(
                    a, b, backend="ref", **kw))
            before = counts()
            with _kernel_events(torch, DenseOperator, ("block_dots",)) as ev:
                res, solve_ms = _host_ms(torch, lambda: api.solve(
                    a, b, backend="cuda", **kw))
            gram_ms = sum(st.elapsed_time(en) for st, en in ev)
            rose = {k: counts()[k] - before[k] for k in before}
            rel = relative_residual(a, b, res.x) if a64 is None \
                else _relative_residual64(torch, a64, b, res.x)
            it, ref_it = res.iterations, ref_res.iterations
            unit = "cycle" if method == "ca_gmres" else "iter"
            where = f"grid={grid}³ n={a.shape[0]}" if name == "poisson" \
                else f"system={name} n={N_MAIN}"
            label = f"{method} s={s} {where} {dtype}"
            print(f"[s-step] {label}{moved}{'' if gated else ' (witness)'} "
                  f"iterations={it} "
                  f"ref_iterations={ref_it} "
                  f"ref_converged={bool(ref_res.converged)} "
                  f"converged={bool(res.converged)} "
                  f"fail_reason={res.info['fail_reason']} "
                  f"ref_fail_reason={ref_res.info['fail_reason']} "
                  f"rel_residual={rel:.3e} solve_ms={solve_ms:.3f} "
                  f"ref_solve_ms={ref_ms:.3f} "
                  f"ms_per_{unit}={solve_ms / max(it, 1):.6f} "
                  f"ref_ms_per_{unit}={ref_ms / max(ref_it, 1):.6f} "
                  f"gram_calls={len(ev)} gram_ms={gram_ms:.3f} "
                  f"gram_share={gram_ms / solve_ms:.4f} "
                  f"cg_ms_per_iter={cg_ms_per_iter} launches={rose}")
            check(res.x.shape == b.shape
                  and bool(torch.isfinite(res.x).all()),
                  f"{label}: x is not a finite vector of shape "
                  f"{tuple(b.shape)}")
            check(not gated or res.info["fail_reason"]
                  == ref_res.info["fail_reason"],
                  f"{label}: fail_reason {res.info['fail_reason']} vs "
                  f"{ref_res.info['fail_reason']} on backend='ref'")
            check(gated or rel <= WITNESS_RESIDUAL_LIMIT,
                  f"{label}: the witness's residual {rel} > "
                  f"{WITNESS_RESIDUAL_LIMIT}")
            if gated and bool(ref_res.converged):
                check(bool(res.converged),
                      f"{label}: not converged ({res.info})")
                check(rel <= RESIDUAL_LIMIT, f"{label}: residual {rel} > "
                                             f"{RESIDUAL_LIMIT}")
                check(it <= max(1.2 * ref_it, ref_it + 2),
                      f"{label}: {it} iterations vs {ref_it} on "
                      "backend='ref'")
            if dtype == "float32":
                check(rose["fused_gram"] > 0, f"{label}: fused_gram never "
                                              "launched")
            if name == "poisson":
                check(rose["bsr_matvec"] > 0, f"{label}: bsr_matvec never "
                                              "launched")
    launches = counts()
    print(f"[s-step] launches over the s-step main path: {launches}")
    print(f"[s-step] the Gram kernel's (k, n) on the main path: "
          f"{sorted(gram_shapes)}; held in phase 3e: {list(GRAM_SHAPES)}")
    unchecked = gram_shapes - set(GRAM_SHAPES)
    check(not unchecked, f"the main path gave the Gram kernel shapes that "
                         f"phase 3e does not hold: {sorted(unchecked)}")
    del dense, b_dense
    sparse.clear()
    torch.cuda.empty_cache()
    return launches


def _attention_key(q, k, v=None, *, causal=True, window=None):
    """A flash-attention call's shape, dtype and mask."""
    b, hq, tq, d = q.shape
    return (b, hq, k.shape[1], tq, k.shape[2], d, causal, window,
            str(q.dtype).removeprefix("torch."))


def _attention_cost(b, hq, hkv, tq, tk, d, causal, window, itemsize):
    """Flops and bytes of one attention call: 4·D flops a visible (query,
    key) pair and query head; q, k and v read once, o written once."""
    import numpy as np
    qpos = np.arange(tq, dtype=np.int64) + (tk - tq)
    hi = np.minimum(qpos, tk - 1) if causal else np.full(tq, tk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(tq, np.int64)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    return (4.0 * b * hq * d * pairs,
            float(itemsize) * d * (2 * b * hq * tq + 2 * b * hkv * tk))


def _attention_bound(flops, nbytes, itemsize) -> tuple[float, str]:
    """The least time in ms: bytes over the memory rate, flops over the
    bf16 tensor-core rate (2-byte inputs) or the float32 rate."""
    peak = BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _time_call(torch, fn, budget_ms: float = 300.0) -> float:
    """``time_ms`` over as many calls as fit in about ``budget_ms`` (2 to
    50), judged by one call on the host clock."""
    _, first_ms = _host_ms(torch, fn)
    return time_ms(torch, fn,
                   max(2, min(50, int(budget_ms / max(first_ms, 1e-3)))))


def _sdpa_call(torch, q, k, v, causal, window):
    """``scaled_dot_product_attention`` on the same tensors, the
    yardstick: ``is_causal`` where it means the same mask (its causal mask
    is top-left aligned), else an explicit end-aligned boolean mask."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tq, tk = q.shape[2], k.shape[2]
    if window is None and (not causal or tq == tk):
        return (lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                f"is_causal={causal}")
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return (lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True),
            "end-aligned boolean attn_mask")


def _attention_sass() -> None:
    """The tensor-core kernel's ptxas report and the count of ``HGMMA``
    (wgmma) instructions in its SASS (a count of 0 fails); the float32
    kernel's ptxas report, and its SASS's ``FFMA`` and ``LDL`` / ``STL``
    counts (an ``HMMA`` or ``HGMMA`` there fails: it stays on the float32
    pipes)."""
    from repro_torch.kernels import _build
    for lib in ("attention_wgmma", "attention"):
        for line in _build.BUILD_LOGS.get(lib, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line \
                    or "entry function" in line:
                print(f"[attention-kernel] {lib} ptxas: {line.strip()}")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print("[attention-kernel] HGMMA count: not measured (no cuobjdump "
              "in the toolkit)")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.build("attention_wgmma"))],
                          capture_output=True, text=True)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    count = sum(1 for line in sass.stdout.splitlines() if "HGMMA" in line)
    print(f"[attention-kernel] HGMMA instructions in the SASS of "
          f"attention_wgmma.cu: {count}")
    check(count > 0, "the tensor-core attention kernel's SASS holds no "
                     "HGMMA instruction")
    _gemm_sass(("attention",), "attention-kernel")


def phase_attention_kernel(torch) -> tuple[dict, set]:
    """Kernel 10 against its plain version at the serving path's shapes
    and the other configs' (``ATTENTION_CASES``), timed beside the plain
    version, SDPA and the bound.  Returns the record row of each of its
    two CUDA kernels and the shapes held."""
    from repro_torch.kernels import attention, ref
    dev = torch.device("cuda")
    record, held = {}, set()
    _attention_sass()
    for i, (label, b, hq, hkv, tq, tk, d, causal, window, dt) in \
            enumerate(ATTENTION_CASES):
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn(b, hq, tq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, hkv, tk, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, hkv, tk, d, generator=g, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        before = dict(attention.LAUNCHES)
        got = attention.flash_attention(q, k, v, **kw)
        ran = [name for name, n in attention.LAUNCHES.items()
               if name != "flash_attention" and n > before[name]]
        again = attention.flash_attention(q, k, v, **kw)
        if b * hq * tq * tk * 4 > ATTENTION_PLAIN_BYTES:
            # no room for the plain version's (Tq, Tk) scores: the first
            # rows against the first keys and the last rows against all
            # keys, each an exact sub-problem (the ends stay aligned)
            r = ATTENTION_ROWS
            pieces = [(slice(0, r), q[:, :, :r], k[:, :, :r], v[:, :, :r]),
                      (slice(tq - r, tq), q[:, :, -r:], k, v)]
            plain_what = (f"plain on rows [0, {r}) x keys [0, {r}) and "
                          f"rows [{tq - r}, {tq}) x all keys")
        else:
            pieces = [(slice(None), q, k, v)]
            plain_what = "plain"

        def plain(cast=lambda x: x):
            return [ref.attention(cast(qq), cast(kk), cast(vv), **kw)
                    for _, qq, kk, vv in pieces]
        # held against the plain version in float32 from the same inputs,
        # before its output is rounded to their type
        wants = plain(lambda x: x.float())
        pairs = [(got[:, :, rows].float(), w)
                 for (rows, *_), w in zip(pieces, wants)]
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"attention {label}: reruns differ")
        err = max(float((x - w).abs().max()) for x, w in pairs)
        scale = max(float(w.abs().max()) for _, w in pairs)
        finite = bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            ok = all(torch.allclose(x, w, rtol=1e-4, atol=1e-4)
                     for x, w in pairs)
            tol = "rtol=atol=1e-4"
        else:
            u = ATTENTION_ROUNDING[dt]
            worst = max(float(((x - w).abs() / (u * w.abs()
                                                + ATTENTION_F32_SLACK)).max())
                        for x, w in pairs)
            ok = worst <= 1.0
            tol = (f"|d| <= {u:.3e} |o_f32| + {ATTENTION_F32_SLACK:g} "
                   f"element by element; worst share of the limit "
                   f"{worst:.4f}")
        check(finite and ok, f"attention {label}: kernel and plain version "
                             f"differ (max abs err {err}, {tol})")
        ms = _time_call(torch, lambda: attention.flash_attention(q, k, v,
                                                                  **kw))
        plain_ms = _time_call(torch, plain)
        sdpa, sdpa_what = _sdpa_call(torch, q, k, v, causal, window)
        sdpa_err = float((sdpa().float() - got.float()).abs().max())
        library_ms = _time_call(torch, sdpa)
        itemsize = q.element_size()
        flops, nbytes = _attention_cost(b, hq, hkv, tq, tk, d, causal,
                                        window, itemsize)
        bound_ms, bound_by = _attention_bound(flops, nbytes, itemsize)
        simt_ms = flops / FP32_FLOPS_PER_S * 1e3
        # the tensor-core kernel feeds P as three bf16 / two fp16 terms:
        # P·V is 2·D flops a pair a term on the tensor cores, QKᵀ 2·D
        terms = {"bfloat16": 3, "float16": 2}.get(dt)
        tc_note = "" if terms is None else (
            f" tensor_core_TFLOPps={flops * (1 + terms) / 2 / ms / 1e9:.3f}"
            f" ({1 + terms}·2·D flops a pair)")
        print(f"[attention-kernel] {label}: B={b} Hq={hq} Hkv={hkv} Tq={tq} "
              f"Tk={tk} D={d} causal={causal} window={window} {dt} "
              f"max_abs_err={err:.3e} max_abs_o={scale:.3e} ({tol}; "
              f"{plain_what}) bitwise_rerun=True ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"(scaled_dot_product_attention, {sdpa_what}; max|d| vs "
              f"kernel {sdpa_err:.3e}) bound_ms={bound_ms:.6f} "
              f"bound_by={bound_by} flops={flops:.4e} bytes={nbytes:.4e} "
              f"TFLOPps={flops / ms / 1e9:.3f} "
              f"bound_share={bound_ms / ms:.4f} "
              f"fp32_simt_bound_ms={simt_ms:.6f} "
              f"fp32_simt_share={simt_ms / ms:.4f} "
              f"library_over_kernel={library_ms / ms:.4f} "
              f"kernel={'+'.join(ran)}{tc_note}")
        held.add(_attention_key(q, k, causal=causal, window=window))
        want_kernel = ("flash_attention_f32" if dt == "float32"
                       else "flash_attention_wgmma")
        check(ran == [want_kernel], f"attention {label}: {dt} ran {ran}, "
                                    f"expected {want_kernel}")
        for name, _, _, case in ATTENTION_KERNELS:
            if label == case:
                record[name] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by,
                                "library_ms": library_ms}
        del q, k, v, got, again, pairs
    torch.cuda.empty_cache()
    return record, held


def _profile_ms(torch, fn) -> tuple[int, float, list]:
    """Top-level PyTorch operators that ``fn`` runs, the device time of
    its kernels in ms (None when the trace holds no CUDA kernel) and the
    five kernels of most device time, (name, ms, calls), by
    ``torch.profiler`` (CPU and CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    kernels = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return ops, (device_ms or None), [(name[:60], round(ms, 3), n)
                                      for name, ms, n in kernels[:5]]


def phase_serve(torch, held: set) -> dict:
    """The serving path of qwen3-1.7b at full width and depth, random
    weights from a seeded generator on the card: prefill of 4 requests of
    1920 tokens into a 2048-slot cache, 128 greedy decode steps, forward
    over the 2048 tokens (decode must match it), the prefill on the plain
    attention path, a 32768-token prefill, then the same serve on a
    float32 copy.  The kernel's counter is set to 0 before each drive and
    read after it."""
    from repro_torch import device as tdev
    from repro_torch import runtime
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import attention, ops
    from repro_torch.models import registry, transformer
    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = _host_ms(torch, lambda: registry.init_params(cfg, gen))
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"[serve] {SERVE_ARCH}: layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.padded_vocab} params={n_params} "
          f"(analytic {cfg.param_count()}) weight_bytes={weight_bytes} "
          f"init_ms={init_ms:.3f}")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    launches, seen = dict.fromkeys(attention.LAUNCHES, 0), set()

    def drive(label, fn, want, kernel="flash_attention_wgmma"):
        """``want`` launches of ``kernel`` (a counter of
        ``attention.LAUNCHES``) and none of kernel 10's other kernel."""
        attention.reset_launches()
        with _recorded_shapes(ops, "flash_attention", _attention_key) as \
                keys, _kernel_events(torch, ops, ("flash_attention",)) as ev:
            out, ms = _host_ms(torch, fn)
        got = dict(attention.LAUNCHES)
        expected = {name: (want if name in (kernel, "flash_attention")
                           else 0) for name in got}
        check(got == expected, f"[serve] {label}: launches {got}, expected "
                               f"{expected}")
        for name, n in got.items():
            launches[name] += n
        seen.update(keys)
        return out, ms, sum(s.elapsed_time(e) for s, e in ev)

    def logits_close(label, got, want, tol):
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        print(f"[serve] {label}: max|d|={err:.4e} max|logit|={top:.4e} "
              f"ratio={err / top:.4e} (limit {tol})")
        check(bool(torch.isfinite(got).all()) and err <= tol * top,
              f"[serve] {label}: max|d| {err} > {tol} * {top}")

    def serve(c, tag, tol, kernel):
        b, p = SERVE_BATCH, SERVE_PROMPT
        batch = {"tokens": prompts}
        drive(f"{tag} warm-up prefill", lambda: transformer.prefill(
            model, batch, c, cache_len=SERVE_CACHE), LAYER_LAUNCHES, kernel)
        (logits, state), ms, kern_ms = drive(
            f"{tag} prefill", lambda: transformer.prefill(
                model, batch, c, cache_len=SERVE_CACHE), LAYER_LAUNCHES,
            kernel)
        check(tuple(logits.shape) == (b, p, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"[serve] {tag} prefill: logits not finite of shape "
              f"{(b, p, cfg.padded_vocab)}")
        prefill_ms = ms
        print(f"[serve] {tag} prefill B={b} T={p}: ms={ms:.3f} "
              f"tokens_per_s={b * p / ms * 1e3:.1f} kernel_ms={kern_ms:.3f} "
              f"kernel_share={kern_ms / ms:.4f} launches={LAYER_LAUNCHES} "
              f"({kernel})")

        def decode():
            tok, toks, steps = logits[:, -1].argmax(-1), [], []
            for i in range(SERVE_DECODE):
                toks.append(tok)
                lg, _ = registry.decode_step(model, state, tok, p + i, c)
                steps.append(lg)
                tok = lg.argmax(-1)
            return torch.stack(toks, 1), torch.stack(steps, 1)

        (gen_toks, step_logits), ms, _ = drive(f"{tag} decode", decode, 0)
        decode_ms = ms / SERVE_DECODE
        check(bool(torch.isfinite(step_logits).all()),
              f"[serve] {tag} decode: logits not finite")
        print(f"[serve] {tag} decode {SERVE_DECODE} steps B={b}: "
              f"ms_per_token={ms / SERVE_DECODE:.4f} "
              f"tokens_per_s={b * SERVE_DECODE / ms * 1e3:.1f} "
              f"weights_floor_ms={weight_bytes / HBM_BYTES_PER_S * 1e3:.4f}"
              f" launches=0")
        tokens = torch.cat([prompts, gen_toks], 1)
        full, ms, kern_ms = drive(
            f"{tag} forward", lambda: registry.forward(
                model, {"tokens": tokens}, c), LAYER_LAUNCHES, kernel)
        print(f"[serve] {tag} forward B={b} T={SERVE_CACHE}: ms={ms:.3f} "
              f"kernel_share={kern_ms / ms:.4f}")
        logits_close(f"{tag} decode vs forward at positions "
                     f"[{p}, {SERVE_CACHE})", step_logits, full[:, p:], tol)
        del full
        # one more step (ring slot 0) and one more prefill, traced: the
        # host's operator count and the device's busy time in each
        (step_ops, step_dev, step_top), _, _ = drive(
            f"{tag} traced decode step", lambda: _profile_ms(
                torch, lambda: registry.decode_step(
                    model, state, gen_toks[:, -1], SERVE_CACHE, c)), 0)
        (pre_ops, pre_dev, pre_top), _, _ = drive(
            f"{tag} traced prefill", lambda: _profile_ms(
                torch, lambda: transformer.prefill(
                    model, batch, c, cache_len=SERVE_CACHE)),
            LAYER_LAUNCHES, kernel)

        def busy(dev_ms, ms):
            return "not measured" if dev_ms is None else f"{dev_ms / ms:.4f}"

        print(f"[serve] {tag} traced: decode step operators={step_ops} "
              f"device_ms={step_dev} (busy share of the untraced "
              f"{decode_ms:.4f} ms a token: {busy(step_dev, decode_ms)}); "
              f"prefill operators={pre_ops} device_ms={pre_dev} (busy "
              f"share of the untraced {prefill_ms:.3f} ms: "
              f"{busy(pre_dev, prefill_ms)})")
        print(f"[serve] {tag} traced decode step, top kernels (name, "
              f"device ms, calls): {step_top}")
        print(f"[serve] {tag} traced prefill, top kernels (name, device "
              f"ms, calls): {pre_top}")
        return logits[:, -1]

    last = serve(cfg, "bfloat16", BF16_LOGIT_TOL, "flash_attention_wgmma")
    with runtime.force_kernel(False):
        (plain, _), ms, _ = drive("bfloat16 plain-attention prefill",
                                  lambda: transformer.prefill(
                                      model, {"tokens": prompts}, cfg), 0)
    print(f"[serve] bfloat16 prefill with force_kernel(False) (dense "
          f"attention): ms={ms:.3f}")
    logits_close("bfloat16 prefill last token: kernel vs plain attention",
                 last, plain[:, -1], BF16_LOGIT_TOL)
    del plain
    print(f"[serve] bfloat16 serve peak_memory_bytes="
          f"{torch.cuda.max_memory_allocated()}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    long_toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL),
                              generator=gen, device=dev)
    out, ms, kern_ms = drive("long prefill", lambda: registry.forward(
        model, {"tokens": long_toks}, cfg, last_only=True), LAYER_LAUNCHES)
    check(tuple(out.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(out).all()),
          "[serve] long prefill: last-token logits not finite")
    print(f"[serve] long prefill B=1 T={LONG_PREFILL} (last_only): "
          f"ms={ms:.3f} tokens_per_s={LONG_PREFILL / ms * 1e3:.1f} "
          f"kernel_ms={kern_ms:.3f} kernel_share={kern_ms / ms:.4f} "
          f"peak_memory_bytes={torch.cuda.max_memory_allocated()}")
    del out, long_toks

    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    model.float()
    with tdev.full_fp32():
        serve(cfg32, "float32", F32_LOGIT_TOL, "flash_attention_f32")
    print(f"[serve] launches over the serving path: {launches}")
    print(f"[serve] kernel shapes on the serving path: {sorted(seen)}")
    unheld = seen - held
    check(not unheld, f"the serving path gave flash_attention shapes that "
                      f"phase 3f does not hold: {sorted(unheld)}")
    del model
    torch.cuda.empty_cache()
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


def phase_cli_direct(torch) -> None:
    from repro_torch.kernels import factor_fused, trsm
    from repro_torch.launch import solve as cli
    before = (factor_fused.LAUNCHES["lu_panel_update"],
              trsm.LAUNCHES["trsm"])
    rc = cli.main(["--n", str(N_MAIN), "--method", "lu", "--backend",
                   "cuda"])
    check(rc == 0, f"CLI --method lu returned {rc}")
    check(factor_fused.LAUNCHES["lu_panel_update"] > before[0]
          and trsm.LAUNCHES["trsm"] > before[1],
          "CLI --method lu launched no panel update or triangular solve")
    print("[cli] --method lu returned 0")


def phase_cli_ls(torch) -> None:
    from repro_torch.kernels import qr_fused
    from repro_torch.launch import solve as cli
    before = qr_fused.LAUNCHES["qr_panel_update"]
    rc = cli.main(["--m", str(LS_M), "--n", str(LS_N), "--method", "qr",
                   "--backend", "cuda"])
    check(rc == 0, f"CLI --m {LS_M} --method qr returned {rc}")
    check(qr_fused.LAUNCHES["qr_panel_update"] > before,
          "CLI --method qr launched no QR update")
    print(f"[cli] --m {LS_M} --n {LS_N} --method qr returned 0")


def phase_cli_s_step(torch) -> None:
    from repro_torch.kernels import krylov_fused
    from repro_torch.launch import solve as cli
    before = krylov_fused.LAUNCHES["fused_gram"]
    rc = cli.main(["--n", str(N_MAIN), "--method", "ca_cg", "--s", "4",
                   "--backend", "cuda"])
    check(rc == 0, f"CLI --method ca_cg --s 4 returned {rc}")
    check(krylov_fused.LAUNCHES["fused_gram"] > before,
          "CLI --method ca_cg launched no Gram kernel")
    print("[cli] --method ca_cg --s 4 returned 0")


def main() -> int:
    import torch
    import repro_torch  # noqa: F401  (without the package: fail before output)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    phase_card(torch)
    phase_build()
    rows = phase_kernels(torch)
    for n in KERNEL_SIZES:     # kernel 1 is one launch a call
        row = rows[("fused_cg_update", n)]
        check(row["kernel_kinds"] == 1 and row["kernels_a_call"] <= 1,
              f"fused_cg_update n={n}: {row['kernels_a_call']} CUDA kernels "
              f"a call of {row['kernel_kinds']} kinds, not one")
    direct_rows = phase_direct_kernels(torch)
    sparse_row = phase_sparse_kernels(torch)
    ls_rows = phase_ls_kernels(torch)
    gram_row = phase_gram_kernel(torch)
    attention_rows, attention_held = phase_attention_kernel(torch)
    launches, cg_dense_ms = phase_main_path(torch)
    direct_launches, direct_ref_errors = phase_direct_main(torch)
    sparse_launches, cg_sparse_ms = phase_sparse_main(torch,
                                                      sparse_row["ms"])
    phase_bicgstab_witness(torch)
    ls_launches = phase_ls_main(torch, direct_ref_errors)
    s_step_launches = phase_s_step_main(
        torch, {"dense": cg_dense_ms, **cg_sparse_ms})
    serve_launches = phase_serve(torch, attention_held)
    phase_cli(torch)
    phase_cli_direct(torch)
    phase_cli_ls(torch)
    phase_cli_s_step(torch)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": launches[name],
         "max_abs_err": rows[(name, N_MAIN)]["max_abs_err"],
         "ms": rows[(name, N_MAIN)]["ms"],
         "plain_ms": rows[(name, N_MAIN)]["plain_ms"],
         "bound_ms": rows[(name, N_MAIN)]["bound_ms"], "bound_by": "bytes",
         "library_ms": None}
        for name, meta in KERNEL_RECORD.items()] + [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": direct_launches[name],
         **direct_rows[name]}
        for name, meta in DIRECT_KERNEL_RECORD.items()] + [
        {"name": "bsr_matvec", "route": "cuda", **SPMV_RECORD,
         "launches": sparse_launches["bsr_matvec"], **sparse_row}] + [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": ls_launches[name],
         **ls_rows[name]}
        for name, meta in LS_KERNEL_RECORD.items()] + [
        {"name": "fused_gram", "route": "cuda", **GRAM_RECORD,
         "launches": s_step_launches["fused_gram"], **gram_row}] + [
        {"name": name, "route": "cuda", "source": source,
         "replaces": ATTENTION_REPLACES, "launches": serve_launches[counter],
         **attention_rows[name]}
        for name, counter, source, _ in ATTENTION_KERNELS]}
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
