"""The hand-written CUDA kernels on the GPU (marked ``cuda``; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs, at the
tolerances of the reference's Pallas kernel tests (fused vectors
rtol = atol = 1e-5 and dots rtol 1e-4; triangular solves rtol = atol =
1e-3; panel updates held tighter, on the change they make: atol 1e-5 of
its largest entry, rtol two float32 ulps; the BSR SpMV rtol 1e-5 in
float32 and 1e-12 in float64, atol the same times max|y|), at the tests'
shapes and at the main paths' sizes, and must give bitwise-identical
results when rerun.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api, cholesky, lu
from repro_torch.kernels import factor_fused, krylov_fused, ref, spmv, trsm
from repro_torch.sparse import BSR, problems
from repro_torch.sparse.operator import SparseOperator

SIZES = [64, 130, 4096 + 7, 1 << 20]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_kernels_match_plain_versions(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x, r, p, ap = (torch.randn(n, generator=g, device=cuda_device)
                   for _ in range(4))
    alpha = torch.tensor(0.41, device=cuda_device)
    before = dict(krylov_fused.LAUNCHES)
    got = krylov_fused.fused_cg_update(x, r, p, ap, alpha)
    again = krylov_fused.fused_cg_update(x, r, p, ap, alpha)
    want = ref.fused_cg_update(x, r, p, ap, alpha)
    for a, b in zip(got, again):
        assert torch.equal(a, b)                # no atomics: bitwise reruns
    for a, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    dots = krylov_fused.fused_pipelined_dots(x, r, p)
    for a, b in zip(dots, krylov_fused.fused_pipelined_dots(x, r, p)):
        assert torch.equal(a, b)
    for a, w in zip(dots, ref.fused_pipelined_dots(x, r, p)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=0)
    assert krylov_fused.LAUNCHES["fused_cg_update"] \
        == before["fused_cg_update"] + 2
    assert krylov_fused.LAUNCHES["fused_pipelined_dots"] \
        == before["fused_pipelined_dots"] + 2


@pytest.mark.cuda
def test_wrapper_needs_alpha_on_the_device(cuda_device):
    x = torch.ones(256, device=cuda_device)
    with pytest.raises(TypeError, match="alpha"):
        krylov_fused.fused_cg_update(x, x, x, x, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernel", [
    ("cg", "fused_cg_update"), ("bicg", "fused_cg_update"),
    ("bicgstab", "fused_cg_update"),
    ("pipelined_cg", "fused_pipelined_dots")])
def test_solve_goes_through_the_kernels(cuda_device, method, kernel):
    rng = np.random.default_rng(0)
    n = 512
    a = rng.standard_normal((n, n)).astype(np.float32)
    a = a @ a.T / n + 4 * np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ref_res = api.solve(a, b, method=method, return_info=True)
    before = krylov_fused.LAUNCHES[kernel]
    res = api.solve(a, b, method=method, backend="cuda", return_info=True)
    assert krylov_fused.LAUNCHES[kernel] > before
    assert bool(res.converged) and res.x.device.type == "cuda"
    assert res.iterations <= max(1.2 * ref_res.iterations,
                                 ref_res.iterations + 2)


# (n, nb, k): tests/test_kernels.py's panel-update cases, then the direct
# path's n = 16384, nb = 128 at its first, middle and next-to-last steps
PANEL_CASES = [(128, 32, 0), (128, 32, 64), (128, 32, 96), (256, 64, 64),
               (16384, 128, 0), (16384, 128, 8192), (16384, 128, 16128)]
# (n, m): the reference's trsm test shapes, m = 1 and a 1-D b, n = 16384
TRSM_CASES = [(128, 128), (256, 128), (256, 64), (100, 1), (130, 7),
              (100, 0), (16384, 0), (16384, 128)]


def _panel_inputs(n, nb, k, spd, dev):
    """A Gaussian (or SPD) working matrix with a well-conditioned diagonal
    block at (k, k) and its inverse, as the factorizations hand them over."""
    g = torch.Generator(device=dev).manual_seed(n + nb + k)
    a = torch.randn(n, n, generator=g, device=dev)
    if spd:
        a = a @ a.T / n + 4 * torch.eye(n, device=dev)
        l11 = torch.linalg.cholesky(a[k:k + nb, k:k + nb])
        a[k:k + nb, k:k + nb] = l11
        linv = torch.linalg.solve_triangular(
            l11, torch.eye(nb, device=dev), upper=False)
    else:
        l11 = torch.tril(torch.randn(nb, nb, generator=g, device=dev), -1) \
            / nb + torch.eye(nb, device=dev)
        a[k:k + nb, k:k + nb] = l11 + torch.triu(a[k:k + nb, k:k + nb])
        linv = torch.linalg.solve_triangular(
            l11, torch.eye(nb, device=dev), upper=False, unitriangular=True)
    return a, linv


@pytest.mark.cuda
@pytest.mark.parametrize("spd", [False, True], ids=["lu", "cholesky"])
@pytest.mark.parametrize("n,nb,k", PANEL_CASES)
def test_panel_update_kernels_match_plain_versions(cuda_device, n, nb, k,
                                                   spd):
    torch.backends.cuda.matmul.allow_tf32 = False
    a, linv = _panel_inputs(n, nb, k, spd, cuda_device)
    name = "cholesky_panel_update" if spd else "lu_panel_update"
    kernel, plain = getattr(factor_fused, name), getattr(ref, name)
    before = factor_fused.LAUNCHES[name]
    got = kernel(a.clone(), linv, k, nb=nb)
    again = kernel(a.clone(), linv, k, nb=nb)
    want = plain(a.clone(), linv, k, nb=nb)
    assert torch.equal(got, again)
    # the update can be far smaller than A's entries (SPD: ~1e-3 against a
    # diagonal of ~4): hold the change itself, to 1e-5 of its largest
    # entry, plus two float32 ulps of the result
    change = float((want - a).abs().max())
    assert (change > 0) == (k + nb < n)
    torch.testing.assert_close(got, want, rtol=2.5e-7, atol=1e-5 * change)
    # the last step (k + nb = n) has nothing right of the panel: no launch
    assert factor_fused.LAUNCHES[name] == before + (2 if k + nb < n else 0)


def _triangle(n, upper, dev):
    g = torch.Generator(device=dev).manual_seed(n)
    t = torch.randn(n, n, generator=g, device=dev) * (0.5 / n ** 0.5) \
        + 2 * torch.eye(n, device=dev)
    return (torch.triu(t) if upper else torch.tril(t)), g


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lower", "upper", "transposed"])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n,m", TRSM_CASES)
def test_trsm_kernel_matches_plain_version(cuda_device, n, m, unit, mode):
    torch.backends.cuda.matmul.allow_tf32 = False
    t, g = _triangle(n, mode == "upper", cuda_device)
    if mode == "transposed":      # Lᵀ as Cholesky's second solve reads it
        t = t.T
    b = torch.randn(*((n, m) if m else (n,)), generator=g,
                    device=cuda_device)
    solve = trsm.trsm_lower if mode == "lower" else trsm.trsm_upper
    plain = ref.trsm_lower if mode == "lower" else ref.trsm_upper
    before = trsm.LAUNCHES["trsm"]
    got = solve(t, b, unit_diagonal=unit)
    assert torch.equal(got, solve(t, b, unit_diagonal=unit))
    assert got.shape == b.shape
    torch.testing.assert_close(got, plain(t, b, unit_diagonal=unit),
                               rtol=1e-3, atol=1e-3)
    assert trsm.LAUNCHES["trsm"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernel", [
    ("lu", "lu_panel_update"), ("cholesky", "cholesky_panel_update")])
def test_direct_solve_goes_through_the_kernels(cuda_device, method, kernel):
    rng = np.random.default_rng(0)
    n = 1000
    a = rng.standard_normal((n, n))
    a = a @ a.T / n + 4 * np.eye(n) if method == "cholesky" \
        else a + n * np.eye(n)
    a, b = a.astype(np.float32), rng.standard_normal((n, 2)).astype(
        np.float32)
    before = (factor_fused.LAUNCHES[kernel], trsm.LAUNCHES["trsm"])
    res = api.solve(a, b, method=method, backend="cuda", return_info=True)
    assert factor_fused.LAUNCHES[kernel] > before[0]
    assert trsm.LAUNCHES["trsm"] == before[1] + 2
    assert res.x.device.type == "cuda"
    assert float(res.residual) <= 1e-5 * float(np.linalg.norm(b))
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(res.x.cpu().numpy(), x64, rtol=0,
                               atol=1e-4 * np.abs(x64).max())


@pytest.mark.cuda
def test_unfused_kernel_route_raises_until_the_gemm_kernel_is_ported(
        cuda_device):
    a = torch.eye(256, device=cuda_device) * 2
    for factor in (lu.lu_factor, cholesky.cholesky_factor):
        with pytest.raises(NotImplementedError, match="kernel 7"):
            factor(a, backend="cuda", fuse_panel=False)


def _random_bsr(m, n, nb, dtype, dev, seed=0):
    """A random sparse (m, n) BSR with empty and uneven block rows."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    a[rng.random((m, n)) > 0.3] = 0
    a[: m // 4] = 0                                  # empty block rows
    a[:, n // 3: n // 2] = 0                         # empty block columns
    return BSR.from_dense(a.astype(dtype), block_size=nb, device=dev)


def _spmv_close(got, want, dtype):
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("nb", [8, 20, 32])
@pytest.mark.parametrize("shape", ["padded", "tall", "wide"])
def test_spmv_kernel_matches_plain_version(cuda_device, shape, nb, k, dtype):
    """Kernel 8 against the plain product for A and its transposed BSR
    (against A's plain ``matvec_t``), a padded n and rectangular A."""
    m, n = {"padded": (7 * nb + 3, 7 * nb + 3), "tall": (9 * nb, 5 * nb + 1),
            "wide": (5 * nb + 1, 9 * nb)}[shape]
    a = _random_bsr(m, n, nb, dtype, cuda_device, seed=nb + k)
    g = torch.Generator(device=cuda_device).manual_seed(k)
    tdtype = a.dtype
    x = torch.randn(*((n,) if k == 1 else (n, k)), generator=g,
                    device=cuda_device, dtype=tdtype)
    u = torch.randn(*((m,) if k == 1 else (m, k)), generator=g,
                    device=cuda_device, dtype=tdtype)
    at = a.transpose()
    before = spmv.LAUNCHES["bsr_matvec"]
    got = spmv.bsr_matvec(a, x)
    assert torch.equal(got, spmv.bsr_matvec(a, x))        # bitwise reruns
    got_t = spmv.bsr_matvec(at, u)
    assert torch.equal(got_t, spmv.bsr_matvec(at, u))
    assert spmv.LAUNCHES["bsr_matvec"] == before + 4
    assert got.shape == (m,) + x.shape[1:] and got.dtype == tdtype
    _spmv_close(got, ref.bsr_matvec(a, x), dtype)
    _spmv_close(got_t, a.matvec_t(u), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_spmv_kernel_on_the_poisson_system(cuda_device, dtype):
    """The main path's brick size (nb = 32, k = 1) on a 3-D Poisson system
    of 32³ unknowns, random values on its structure."""
    a = problems.poisson_3d_bsr(32, 32, dtype, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    a = BSR(torch.randn(a.data.shape, generator=g, device=cuda_device,
                        dtype=a.dtype), a.indices, a.indptr, a.shape, a.nb,
            device=cuda_device)
    x = torch.randn(a.shape[1], generator=g, device=cuda_device,
                    dtype=a.dtype)
    got = spmv.bsr_matvec(a, x)
    assert torch.equal(got, spmv.bsr_matvec(a, x))
    _spmv_close(got, ref.bsr_matvec(a, x), dtype)


@pytest.mark.cuda
def test_spmv_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    a = _random_bsr(64, 64, 8, np.float32, cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        spmv.bsr_matvec(a, torch.ones(64, device=cuda_device,
                                      dtype=torch.float64))
    with pytest.raises(ValueError, match=r"x must be \(64,\)"):
        spmv.bsr_matvec(a, torch.ones(63, device=cuda_device))
    with pytest.raises(ValueError, match="the matrix on"):
        spmv.bsr_matvec(a, torch.ones(64))
    # the sparse engine hands every dtype to the kernel: no plain fallback
    half = BSR(a.data.half(), a.indices, a.indptr, a.shape, a.nb,
               device=cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        SparseOperator(half, backend="cuda").matvec(
            torch.ones(64, device=cuda_device, dtype=torch.float16))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pipelined_cg", "bicg", "bicgstab",
                                    "gmres"])
def test_sparse_solve_goes_through_the_spmv_kernel(cuda_device, method):
    a = problems.poisson_3d_bsr(16, 8, device=cuda_device)
    # a Gaussian b, as the smoke's sparse path: with the smooth forcing,
    # float32 rounding of x alone keeps GMRES's true residual above 1e-6
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    ref_res = api.solve(a, b, method=method, return_info=True)
    before = spmv.LAUNCHES["bsr_matvec"]
    res = api.solve(a, b, method=method, backend="cuda", return_info=True)
    assert spmv.LAUNCHES["bsr_matvec"] > before
    assert bool(res.converged) and res.x.device.type == "cuda"
    assert res.iterations <= max(1.2 * ref_res.iterations,
                                 ref_res.iterations + 2)
    x64 = res.x.double()
    a64 = BSR(a.data.double(), a.indices, a.indptr, a.shape, a.nb,
              device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device).double()
    assert float(torch.linalg.norm(bt - a64.matvec(x64))
                 / torch.linalg.norm(bt)) <= 1e-4
