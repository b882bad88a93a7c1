#!/usr/bin/env python3
"""Time the kernels of two checkouts of this repository in turns, on one
NVIDIA GPU.

    python3 kernel_compare.py OTHER_TREE [--phases 3b,3d,3e]

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
printed first.  Exits non-zero if any turn fails.
"""
import argparse
import os
import subprocess
import sys
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--phases", default="3b,3d,3e")
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
    failed = 0
    for label, root in (("other 1", other), ("this 1", this),
                        ("this 2", this), ("other 2", other)):
        rc = run_turn(label, root, phases)
        print(f"[{label}] rc={rc}")
        failed |= rc != 0
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
