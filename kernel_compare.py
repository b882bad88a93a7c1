#!/usr/bin/env python3
"""Time the kernels of two checkouts of this repository in turns, on one
NVIDIA GPU.

    python3 kernel_compare.py OTHER_TREE [--phases 3b,3d,3e] [--sass LIBS]
                              [--pairs N] [--summary KEYS]

OTHER_TREE is a second checkout (an earlier commit unpacked with
``git archive``).  The script runs the named ``chip_smoke.py`` phases on
each tree's package (``src/repro_torch``: its kernels, wrappers and build)
in the order OTHER, THIS, THIS, OTHER, one process a turn, so that a drift
of the card over the run shows as a difference between the two turns of
one tree; ``--pairs N`` runs N pairs, each in the order opposite to the
one before (OTHER, THIS, THIS, OTHER, OTHER, THIS, ...).  Every turn runs
this tree's ``chip_smoke.py`` phase functions, so both trees are measured
by the same code (the phases call the package's public wrappers, which a
rule-2 change keeps); each turn prints the package it imported.  Each
process builds its tree's kernels (the ``[build]`` phase) and runs:

    3   phase_kernels          fused Krylov vector kernels (kernels 1, 2)
    3b  phase_direct_kernels   LU / Cholesky panel updates, triangular solve
    3d  phase_ls_kernels       QR trailing update, GEMM
    3e  phase_gram_kernel      Gram matrix
    3f  phase_attention_kernel flash attention (bf16 / fp16 and float32)

Every line a phase prints comes back prefixed by ``[other 1]``, ``[this
1]``, ``[this 2]``, ``[other 2]``, ...; the card's name and power limit are
printed first.  ``--summary host_us_a_call,ms`` ends with a ``[summary]``
line for each printed line that holds such a ``key=value`` (a line is
named by its words up to the first ``=``, e.g. ``[kernel] fused_cg_update
n=16384``): each tree's median, and every turn's value in turn order.
``--sass gemm,qr_fused`` first builds those sources of both trees with
this tree's ``nvcc`` flags and says, for each kernel of OTHER, which
kernel of this tree has the same SASS instruction for instruction
(``cuobjdump``), if any: whether a change left a kernel's compiled code as
it was, whatever its name.  Exits non-zero if any turn fails.
"""
import argparse
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

PHASES = {"3": "phase_kernels", "3b": "phase_direct_kernels",
          "3d": "phase_ls_kernels", "3e": "phase_gram_kernel",
          "3f": "phase_attention_kernel"}
# the package is imported before chip_smoke, which puts this tree's src/
# first on the path: its submodules then come from the turn's tree
TURN = """
import sys
sys.path[:0] = [{src!r}, {harness!r}]
import torch
import repro_torch
print(f"[package] {{repro_torch.__file__}}")
import chip_smoke as c
c.phase_card(torch)
c.phase_build()
for name in {phases!r}:
    getattr(c, name)(torch)
"""


def run_turn(label: str, root: Path, phases: list[str],
             keys: list[str], readings: dict) -> int:
    """Runs one turn, recording ``keys`` from the lines it prints."""
    code = TURN.format(src=str(root / "src"),
                       harness=str(Path(__file__).resolve().parent),
                       phases=phases)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ,
                                            "PYTHONPATH": str(root / "src")})
    for line in proc.stdout:
        print(f"[{label}] {line}", end="", flush=True)
        record(label, line, keys, readings)
    return proc.wait()


def record(label: str, line: str, keys: list[str], readings: dict) -> None:
    """Adds (label, value) to ``readings[(line name, key)]`` for each of
    ``keys`` that ``line`` holds as ``key=value``; a line is named by its
    words up to the first ``=`` and that word's value."""
    for key in keys:
        found = re.search(rf"(?:^| ){re.escape(key)}=([-+.0-9e]+)", line)
        if found:
            head, tail = line.split("=", 1)
            name = f"{head}={tail.split(' ', 1)[0]}".strip()
            readings.setdefault((name, key), []).append(
                (label, float(found.group(1))))


def turn_order(pairs: int) -> list[tuple[str, int]]:
    """(tree, turn) in the order run: OTHER, THIS, THIS, OTHER, OTHER, ..."""
    order = []
    for i in range(pairs):
        pair = [("other", i + 1), ("this", i + 1)]
        order += pair[::-1] if i % 2 else pair
    return order


def print_summary(readings: dict) -> None:
    for (name, key), values in readings.items():
        medians = []
        for tree in ("other", "this"):
            mine = [v for label, v in values if label.startswith(tree)]
            if mine:
                medians.append(f"median_{tree}={statistics.median(mine):g}")
        turns = " ".join(f"{label}={v:g}" for label, v in values)
        print(f"[summary] {name} {key}: {' '.join(medians)} turns: {turns}")


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
    parser.add_argument("--pairs", type=int, default=2,
                        help="pairs of turns (other and this), each in the "
                             "order opposite to the one before")
    parser.add_argument("--summary", default="",
                        help="keys (e.g. host_us_a_call,ms) whose values "
                             "are listed turn by turn at the end")
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
    failed, readings = 0, {}
    keys = [k for k in args.summary.split(",") if k]
    for tree, turn in turn_order(args.pairs):
        label = f"{tree} {turn}"
        rc = run_turn(label, other if tree == "other" else this, phases,
                      keys, readings)
        print(f"[{label}] rc={rc}")
        failed |= rc != 0
    print_summary(readings)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
