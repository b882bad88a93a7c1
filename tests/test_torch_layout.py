"""Layout and device rules of the PyTorch port.

* ``src/repro_torch/`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``repro`` (AST scan), and the package imports and solves
  with ``jax`` unimportable.
* Importing the package and solving on the CPU builds no kernel.
* Entry points default to the GPU and raise without one.
* The CLI runs on the CPU with ``--device cpu``.
"""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import api
from repro_torch.configs.base import get_config
from repro_torch.launch import solve as cli
from repro_torch.models import registry, transformer
from repro_torch.sparse import BSR, ELL, problems

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "attention_probe.py",
       ROOT / "kernel_compare.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_port_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import api\n"
        "from repro_torch.kernels import _build, krylov_fused\n"
        "rng = np.random.default_rng(0)\n"
        "a = rng.standard_normal((32, 32)).astype(np.float32) "
        "+ 32 * np.eye(32, dtype=np.float32)\n"
        "b = rng.standard_normal(32).astype(np.float32)\n"
        "r = api.solve(a, b, method='bicgstab', backend='cuda', "
        "device='cpu', return_info=True)\n"
        "assert bool(r.converged), r\n"
        "from repro_torch.sparse import problems\n"
        "bsr = problems.poisson_3d_bsr(4, 4, device='cpu')\n"
        "r = api.solve(bsr, np.ones(64, np.float32), method='bicg', "
        "backend='cuda', device='cpu', return_info=True)\n"
        "assert bool(r.converged), r\n"
        "import torch\n"
        "from repro_torch.configs.base import get_config\n"
        "from repro_torch.models import registry\n"
        "cfg = get_config('qwen3-1.7b', reduced=True)\n"
        "m = registry.init_params(cfg, torch.Generator().manual_seed(0), "
        "device='cpu')\n"
        "lg = registry.forward(m, {'tokens': torch.zeros(1, 128, "
        "dtype=torch.long)}, cfg)\n"
        "assert bool(torch.isfinite(lg).all())\n"
        "assert not _build._LIBS, 'a CPU run loaded a kernel library'\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print('OK')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_entry_points_default_to_the_gpu_and_raise_without_one(no_gpu):
    a = np.eye(8, dtype=np.float32) * 2
    b = np.ones(8, np.float32)
    for kw in ({}, {"method": "cg"}, {"method": "cg", "backend": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.solve(a, b, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.factorize(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.system_from_numpy(a, b)
    # the sparse entry points: constructors, converters, builders, solves
    bsr = BSR.from_dense(a, block_size=4, device="cpu")
    ell = ELL.from_dense(a, device="cpu")
    for make in (lambda: BSR.from_dense(a, block_size=4),
                 lambda: BSR(bsr.data, bsr.indices, bsr.indptr, bsr.shape,
                             bsr.nb),
                 lambda: ELL.from_dense(a),
                 lambda: interop.bsr_from_numpy(bsr.data.numpy(), bsr.indices,
                                                bsr.indptr, bsr.shape, bsr.nb),
                 lambda: interop.ell_from_numpy(ell.data.numpy(), ell.cols,
                                                ell.valid, ell.shape),
                 lambda: problems.poisson_3d_bsr(4, 4),
                 lambda: api.solve(bsr, b, method="cg", backend="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--n", "16", "--method", "cg"])
    # the model entry points: weights drawn, weights carried across
    cfg = get_config("qwen3-1.7b", reduced=True)
    model = registry.init_params(cfg, torch.Generator(), device="cpu")
    tree = {"embed": {"embedding": model["embed"]["embedding"].float()
                      .numpy()},
            "layers": {group: {name: np.stack([
                layer[group][name].float().numpy()
                for layer in model["layers"]])
                for name, _ in model["layers"][0][group].named_parameters()}
                for group in ("ln1", "attn", "ln2", "mlp")},
            "final_norm": {"scale": model["final_norm"]["scale"].float()
                           .numpy()}}
    assert interop.transformer_params_from_numpy(tree, cfg, device="cpu") \
        ["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
    for make in (lambda: registry.init_params(cfg, torch.Generator()),
                 lambda: transformer.init_params(cfg, torch.Generator()),
                 lambda: interop.transformer_params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("method", ["cg", "gmres", "lu", "cholesky"])
def test_cli_runs_on_the_cpu(method, capsys):
    assert cli.main(["--n", "96", "--method", method, "--backend", "cuda",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "relative residual" in out and "device=cpu" in out


def test_cli_draws_the_reference_system():
    """Same numpy draws as repro.launch.solve.make_system."""
    from repro.launch.solve import make_system as ref_make_system
    for spd in (False, True):
        a, b = cli.make_system(48, spd=spd, device="cpu")
        ra, rb = ref_make_system(48, spd=spd)
        np.testing.assert_array_equal(b.numpy(), rb)
        np.testing.assert_allclose(a.numpy(), ra, rtol=1e-6, atol=1e-6)


def test_cli_exits_nonzero_when_the_residual_is_too_large(capsys):
    assert cli.main(["--n", "64", "--method", "cg", "--maxiter", "1",
                     "--device", "cpu"]) == 1
    assert "residual too large" in capsys.readouterr().out


def test_attention_probe_variants_cut_the_kernel_source():
    """Each of ``attention_probe.py``'s variants of the tensor-core kernel
    finds the lines it takes out, so an edit of the kernel cannot leave the
    probe timing the kernel unchanged under another name."""
    sys.path.insert(0, str(ROOT))
    try:
        import attention_probe
    finally:
        sys.path.remove(str(ROOT))
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "attention_wgmma.cu").read_text()
    texts = attention_probe.variants(src)
    assert texts["full"] == src
    assert len(set(texts.values())) == len(texts) == 7


def test_attention_probe_float32_variants_cut_the_kernel_source():
    """The same for ``attention_probe.py --float32``'s variants of the
    float32 kernel (``csrc/attention.cu``)."""
    attention_probe = _root_module("attention_probe")
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "attention.cu").read_text()
    texts = attention_probe.variants_f32(src)
    assert texts["full"] == src
    assert len(set(texts.values())) == len(texts) == 8


def test_kernel_compare_phases_are_chip_smoke_phases():
    """Every phase ``kernel_compare.py --phases`` names is a function of
    ``chip_smoke.py`` (whose phases every turn runs)."""
    kernel_compare = _root_module("kernel_compare")
    chip_smoke = _root_module("chip_smoke")
    assert {"3", "3b", "3d", "3e", "3f"} <= set(kernel_compare.PHASES)
    for name in kernel_compare.PHASES.values():
        assert callable(getattr(chip_smoke, name))


def test_kernel_compare_refuses_a_tree_without_chip_smoke(tmp_path):
    """``kernel_compare.py`` runs another checkout's phases: a directory
    without ``chip_smoke.py`` is refused before anything is built."""
    proc = subprocess.run([sys.executable, str(ROOT / "kernel_compare.py"),
                           str(tmp_path)], capture_output=True, text=True)
    assert proc.returncode == 2
    assert "no chip_smoke.py" in proc.stderr


def _root_module(name):
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT))


def test_kernel_compare_alternates_its_pairs():
    """``--pairs N``: each pair of turns in the order opposite to the one
    before, so that a drift over the run falls on both trees alike; the
    default two pairs are other, this, this, other."""
    kernel_compare = _root_module("kernel_compare")
    assert kernel_compare.turn_order(2) == [
        ("other", 1), ("this", 1), ("this", 2), ("other", 2)]
    order = kernel_compare.turn_order(10)
    assert len(order) == 20
    assert sorted(order) == sorted((tree, i) for i in range(1, 11)
                                   for tree in ("other", "this"))
    assert [tree for tree, _ in order[4:6]] == ["other", "this"]


def test_kernel_compare_summary_takes_each_tree_median(capsys):
    """``--summary``: a line is named by its words up to its first value,
    and each tree's median is taken over its turns' readings."""
    kernel_compare = _root_module("kernel_compare")
    readings = {}
    line = ("[kernel] fused_cg_update n=16384 max_abs_err=0.000e+00 "
            "ms={ms} host_us_a_call={us} bits=0x1\n")
    for label, ms, us in (("other 1", 0.05, 44.0), ("this 1", 0.03, 27.0),
                          ("this 2", 0.02, 29.0), ("other 2", 0.06, 40.0),
                          ("other 3", 0.04, 48.0), ("this 3", 0.03, 20.0)):
        kernel_compare.record(label, line.format(ms=ms, us=us),
                              ["host_us_a_call", "ms"], readings)
    kernel_compare.record("this 3", "[kernel] other line\n", ["ms"],
                          readings)
    name = "[kernel] fused_cg_update n=16384"
    assert set(readings) == {(name, "host_us_a_call"), (name, "ms")}
    kernel_compare.print_summary(readings)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"[summary] {name} host_us_a_call: median_other=44 "
                      "median_this=27 turns: other 1=44 this 1=27 "
                      "this 2=29 other 2=40 other 3=48 this 3=20")
    assert "median_other=0.05 median_this=0.03" in out[1]


def test_kernel_compare_matches_kernels_by_their_sass():
    """``kernel_compare.py --sass`` reads ``cuobjdump -sass`` output as
    each kernel's instructions, without addresses or encodings, so two
    builds of the same code compare equal whatever their names."""
    kernel_compare = _root_module("kernel_compare")
    text = """
\t\tFunction : _Z1fv
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                   /* 0x000000000000794d */
\t\tFunction : _Z1gv
        /*10000*/                  FFMA R2, R3, R4, R2 ;    /* 0x0000000403027223 */
"""
    assert kernel_compare.parse_sass(text) == {
        "_Z1fv": ("LDC R1, c[0x0][0x28]", "EXIT"),
        "_Z1gv": ("FFMA R2, R3, R4, R2",)}
