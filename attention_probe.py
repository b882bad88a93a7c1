#!/usr/bin/env python3
"""Where the time of an attention kernel goes, on one NVIDIA GPU.

    python3 attention_probe.py [--float32]

Builds ``src/repro_torch/kernels/csrc/attention_wgmma.cu`` (the tensor-core
kernel, bf16) and variants of it with one part taken out, whose results
are wrong on purpose:

* ``no-softmax``: every tile's scores dropped (no softmax, no split, P = 0);
* ``no-loads``: no K / V copies after the first tiles (stale tiles reused);
* ``tensor-only``: both of the above, so the tensor cores' work is left;
* ``no-pv``: no P·V products; ``no-s``: no S products;
* ``one-term``: P·V on P's first bf16 term only (what a kernel that rounds
  P once would do);

and times each in turns (in order, then in reverse; the smaller of the two)
with CUDA events at qwen3-1.7b's prefill (B = 4, 16 / 8 heads, T = 2048,
D = 128, causal, bf16) and tinyllama-1.1b's (32 / 4 heads, D = 64).

``--float32`` does the same for ``csrc/attention.cu`` (float32, D <= 128)
at qwen3-1.7b's float32-copy prefill (T = 2048 and 1920) and the float32
case of ``chip_smoke.py`` phase 3f (B = 2, 8 / 2 heads, T = 512, D = 112,
not causal), with the variants:

* ``no-softmax``: no online softmax (the raw scores are written as P);
* ``no-loads``: no K / V slice copied after the first ring's worth;
* ``products-only``: both of the above, so the FFMA products are left;
* ``no-pv``: no P·V products; ``no-s``: no S products;
* ``stages-3``, ``stages-5``: the ring at 3 or 5 slices in place of 4.

The builds go under ``src/repro_torch/kernels/build/`` (git-ignored), one
``nvcc`` each, all started together.  Needs a CUDA device; exits 1 without
one.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (label, B, Hq, Hkv, T, D, causal)
SHAPES = {"attention_wgmma": (("qwen3 prefill", 4, 16, 8, 2048, 128, True),
                              ("tinyllama prefill", 4, 32, 4, 2048, 64,
                               True)),
          "attention": (("qwen3 float32 copy", 4, 16, 8, 2048, 128, True),
                        ("qwen3 float32 copy prefill", 4, 16, 8, 1920, 128,
                         True),
                        ("float32 case", 2, 8, 2, 512, 112, False))}
DTYPES = {"attention_wgmma": "bfloat16", "attention": "float32"}
LAUNCHES = 30

_LOAD_K = "    if (t + 2 < t_end) load_k(t + 2);\n"
_LOAD_V = "    if (t + 1 < t_end) load_v(t + 1);\n"
_ACTIVE = "const bool active = w_begin <= t && t < w_end;"
_PV = "    issue_pv<T, DP, kTerms>(acc, pa, pa_v);\n"
_WAIT_S = "wgmma_wait<1>();   // S is done"
_S = "      wgmma_ss<T>(s, da, db, kk > 0);\n"
_TERMS = ("    for (int term = 0; term < kTerms; ++term)\n"
          "      wgmma_rs<T, DP>(acc, pa[term][kk], dv);")


def _cut(text: str, *edits: tuple[str, str]) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"attention_probe: the kernel source no longer "
                             f"holds {old.strip()!r}; update the variants")
        text = text.replace(old, new)
    return text


_F32_SOFTMAX = ("    online_softmax<RM>(s_acc, o_acc, m_s, l_s, tx, ty, "
                "row0,\n"
                "                       (t_lo + i / per_tile) * kTile, "
                "q_offset, tk, scale,\n"
                "                       causal, has_window, window);\n")
_F32_LOAD = "    if (i + kStages - 1 < total) stage(i + kStages - 1);\n"
_F32_PV = "      pv_product<RM>(p_s + (j - ns) * kSlice, s, o_acc, tx, ty);\n"
_F32_S = "    s_product<RM>(q_s + j * kSlice, s, s_acc, tx, ty);\n"
_F32_STAGES = "constexpr int kStages = 4; "


def variants_f32(src: str) -> dict[str, str]:
    no_softmax = ((_F32_SOFTMAX, ""),)
    no_loads = ((_F32_LOAD, ""),)
    return {
        "full": src,
        "no-softmax": _cut(src, *no_softmax),
        "no-loads": _cut(src, *no_loads),
        "products-only": _cut(src, *no_softmax, *no_loads),
        "no-pv": _cut(src, (_F32_PV, "")),
        "no-s": _cut(src, (_F32_S, "")),
        "stages-3": _cut(src, (_F32_STAGES, "constexpr int kStages = 3; ")),
        "stages-5": _cut(src, (_F32_STAGES, "constexpr int kStages = 5; ")),
    }


def variants(src: str) -> dict[str, str]:
    no_loads = ((_LOAD_K, ""), (_LOAD_V, ""))
    no_softmax = ((_ACTIVE, "const bool active = false;"),)
    return {
        "full": src,
        "no-softmax": _cut(src, *no_softmax),
        "no-loads": _cut(src, *no_loads),
        "tensor-only": _cut(src, *no_softmax, *no_loads),
        "no-pv": _cut(src, (_PV, ""), (_WAIT_S, "wgmma_wait<0>();   // S")),
        "no-s": _cut(src, (_S, "")),
        "one-term": _cut(src, (_TERMS, "    wgmma_rs<T, DP>(acc, pa[0][kk], "
                                       "dv);")),
    }


def build_all(source: str,
              sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One library per source text, each in a directory of its own under
    the git-ignored build directory, built in parallel."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dirs = {}
    for name, text in sources.items():
        d = Path(tempfile.mkdtemp(prefix="probe-", dir=_build.BUILD_DIR))
        (d / f"{source}.cu").write_text(text)
        dirs[name] = d
    with ThreadPoolExecutor(len(dirs)) as pool:
        paths = list(pool.map(_build_one, [source] * len(dirs), dirs,
                              dirs.values()))
    return {name: ctypes.CDLL(str(path)) for name, path in zip(dirs, paths)}


def _build_one(source: str, name: str, csrc: Path) -> Path:
    """``nvcc`` on a variant of ``csrc/<source>.cu`` with the package's
    flags (the package's headers on the include path)."""
    from repro_torch.kernels import _build
    out = csrc / f"lib{source}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(csrc / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"attention_probe: nvcc failed on {name}:\n"
                         f"{proc.stdout}{proc.stderr}")
    regs = [line.split(":", 1)[-1].strip()
            for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line]
    print(f"[probe] built {name}: {regs}", flush=True)
    return out


def forward(source: str, lib: ctypes.CDLL, causal: bool):
    """The library's C entry as a call on (q, k, v), as the wrapper makes it
    (no window, the default scale)."""
    import torch
    from repro_torch.kernels import attention
    fn = getattr(lib, f"{source}_forward")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, attention._STRIDES,
                   ctypes.c_void_p, attention._STRIDES, ctypes.c_void_p,
                   attention._STRIDES, ctypes.c_void_p] \
        + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v):
        b, hq, tq, d = q.shape
        hkv, tk = k.shape[1], k.shape[2]
        o = torch.empty_like(q)
        err = fn(attention._DTYPES[q.dtype], q.data_ptr(),
                 attention._STRIDES(*q.stride()), k.data_ptr(),
                 attention._STRIDES(*k.stride()), v.data_ptr(),
                 attention._STRIDES(*v.stride()), o.data_ptr(), b, hq, hkv,
                 tq, tk, d, min(128, tq), min(128, tk), d ** -0.5,
                 int(causal), 0, 0,
                 q.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"attention_probe: launch failed, CUDA error "
                             f"{err}")
        return o
    return call


def time_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    from repro_torch.kernels import _build
    source = "attention" if "--float32" in sys.argv[1:] else "attention_wgmma"
    src = (_build.CSRC / f"{source}.cu").read_text()
    libs = build_all(source, (variants_f32 if source == "attention"
                              else variants)(src))
    dev = torch.device("cuda")
    dt = DTYPES[source]
    for label, b, hq, hkv, t, d, causal in SHAPES[source]:
        calls = {name: forward(source, lib, causal)
                 for name, lib in libs.items()}
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(getattr(torch, dt)) for h in (hq, hkv, hkv))
        order = list(calls)
        times = {name: [] for name in order}
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(time_ms(torch,
                                           lambda: calls[name](q, k, v)))
        print(f"[probe] {label} B={b} Hq={hq} Hkv={hkv} T={t} D={d} "
              f"causal={causal} {dt}, ms (the smaller of two turns): "
              + " ".join(f"{n}={min(x):.6f}" for n, x in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
