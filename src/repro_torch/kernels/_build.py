"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`.  The
build runs on first use, never at import, into ``build/`` beside this file
(listed in ``.gitignore``).  The library's name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}   # nvcc's output (ptxas -v: registers, smem)


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit that torch finds (``CUDA_HOME``,
    ``CUDA_PATH``, ``nvcc`` on ``PATH``, or the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "hand-written kernels are built with nvcc")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; return the library's path."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} (exit "
                           f"{proc.returncode}):\n{BUILD_LOGS[name]}")
    os.replace(tmp, out)      # atomic: no process loads a half-written file
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def on_cuda(v: torch.Tensor) -> bool:
    """The dispatch rule of every wrapper: True for a CUDA tensor (launch
    the kernel or raise), False for a CPU tensor (the plain version)."""
    if v.device.type == "cpu":
        return False
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    return True


# torch's private getter of the current stream's raw handle; where a torch
# release lacks it, current_stream takes the public (slower) route.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: torch.device) -> int:
    """The handle of torch's current stream on the CUDA ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a ``torch.cuda.Stream``, which costs a small kernel's launch
    several times over."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _RAW_STREAM(device.index)


def raise_on(err: int, error_string, what: str) -> None:
    """Raise when a library call returned a CUDA error; ``error_string`` is
    the library's own ``cudaGetErrorString`` export."""
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")
