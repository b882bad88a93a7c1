#!/usr/bin/env python3
"""Time the kernels of two checkouts of this repository in turns, on one
NVIDIA GPU.

    python3 kernel_compare.py OTHER_TREE [--phases 3b,3d,3e] [--sass LIBS]

OTHER_TREE is a second checkout (an earlier commit unpacked with
``git archive``).  The script runs the named ``chip_smoke.py`` phases of
each tree in the order OTHER, THIS, THIS, OTHER, one process a turn, so
that a drift of the card over the run shows as a difference between the
two turns of one tree.  Each process builds its tree's kernels (the
``[build]`` phase) and runs:

    3b  phase_direct_kernels   LU / Cholesky panel updates, triangular solve
    3d  phase_ls_kernels       QR trailing update, GEMM
    3e  phase_gram_kernel      Gram matrix

Every line a phase prints comes back prefixed by ``[other 1]``, ``[this
1]``, ``[this 2]`` or ``[other 2]``; the card's name and power limit are
printed first.  ``--sass gemm,qr_fused`` first builds those sources of
both trees with this tree's ``nvcc`` flags and says, for each kernel of
OTHER, which kernel of this tree has the same SASS instruction for
instruction (``cuobjdump``), if any: whether a change left a kernel's
compiled code as it was, whatever its name.  Exits non-zero if any turn
fails.
"""
import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

PHASES = {"3b": "phase_direct_kernels", "3d": "phase_ls_kernels",
          "3e": "phase_gram_kernel"}
TURN = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
import chip_smoke as c
c.phase_card(torch)
c.phase_build()
for name in {phases!r}:
    getattr(c, name)(torch)
"""


def run_turn(label: str, root: Path, phases: list[str]) -> int:
    code = TURN.format(root=str(root), src=str(root / "src"), phases=phases)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ,
                                            "PYTHONPATH": str(root / "src")})
    for line in proc.stdout:
        print(f"[{label}] {line}", end="", flush=True)
    return proc.wait()


def parse_sass(text: str) -> dict[str, tuple[str, ...]]:
    """``cuobjdump -sass`` output as {kernel name: its instructions}, each
    without its address and encoding."""
    kernels, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            kernels[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
                                 .split(";")[0].strip())
    return {k: tuple(v) for k, v in kernels.items()}


def sass_of(nvcc: list[str], cu: Path, so: Path) -> dict:
    """The SASS of the CUDA source ``cu``, built into ``so``."""
    subprocess.run([*nvcc, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    cuobjdump = Path(nvcc[0]).parent / "cuobjdump"
    return parse_sass(subprocess.run([str(cuobjdump), "-sass", str(so)],
                                     check=True, capture_output=True,
                                     text=True).stdout)


def compare_sass(other: Path, this: Path, libs: list[str]) -> None:
    sys.path.insert(0, str(this / "src"))
    from repro_torch.kernels import _build
    nvcc = [_build.nvcc_path(), *_build.NVCC_FLAGS]
    csrc = Path("src/repro_torch/kernels/csrc")
    with tempfile.TemporaryDirectory() as tmp:
        for lib in libs:
            theirs, ours = (sass_of(nvcc, tree / csrc / f"{lib}.cu",
                                    Path(tmp) / f"lib{lib}-{i}.so")
                            for i, tree in enumerate((other, this)))
            by_code = {code: name for name, code in ours.items()}
            same = sum(code in by_code for code in theirs.values())
            print(f"[sass] {lib}: other {len(theirs)} kernels, this "
                  f"{len(ours)}; {same} of other's have an identical kernel "
                  "here")
            for name, code in theirs.items():
                match = by_code.get(code)
                print(f"[sass]   other {name} ({len(code)} instructions): "
                      + (f"identical to this {match}" if match else
                         "no identical kernel in this tree"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--phases", default="3b,3d,3e")
    parser.add_argument("--sass", default="",
                        help="CUDA sources (e.g. gemm,qr_fused) whose "
                             "kernels' SASS is compared between the trees")
    args = parser.parse_args()
    phases = [PHASES[p] for p in args.phases.split(",")]
    this = Path(__file__).resolve().parent
    other = args.other.resolve()
    if not (other / "chip_smoke.py").exists():
        print(f"no chip_smoke.py in {other}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print(f"nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0])
    if args.sass:
        compare_sass(other, this, args.sass.split(","))
    failed = 0
    for label, root in (("other 1", other), ("this 1", this),
                        ("this 2", this), ("other 2", other)):
        rc = run_turn(label, root, phases)
        print(f"[{label}] rc={rc}")
        failed |= rc != 0
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
