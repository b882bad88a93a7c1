"""The hand-written CUDA kernels on the GPU (marked ``cuda``; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs, at the
tolerances of the reference's Pallas kernel tests (fused vectors
rtol = atol = 1e-5 and dots rtol 1e-4; triangular solves rtol = atol =
1e-3; panel updates held tighter, on the change they make: atol 1e-5 of
its largest entry, rtol two float32 ulps; the BSR SpMV rtol 1e-5 in
float32 and 1e-12 in float64, atol the same times max|y|; the tiled GEMM
rtol 1e-4 and atol 1e-4 of max|C|; the QR update atol 1e-4 of the change
it makes, rtol 1e-5; flash attention rtol = atol = 1e-4 in float32, and
in bf16 and fp16 element by element within one output rounding (2^-8 and
2^-11 of the value) plus 1e-5 of the plain version computed in float32 from
the same inputs), at the tests' shapes and at
the main paths' sizes, and must give bitwise-identical results when rerun.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api, cholesky, lu
from repro_torch.kernels import (attention, factor_fused, gemm, krylov_fused,
                                 qr_fused, ref, spmv, trsm)
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
def test_cg_update_is_one_kernel_a_call(cuda_device):
    """One CUDA kernel a call, at most once a call over 10 profiled calls
    (``torch.profiler`` drops a record now and then, never adds one; an
    empty trace is taken again), at the dense main path's n = 16384."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x, r, p, ap = (torch.randn(16384, generator=g, device=cuda_device)
                   for _ in range(4))
    alpha = torch.tensor(0.41, device=cuda_device)
    krylov_fused.fused_cg_update(x, r, p, ap, alpha)   # built and launched
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                krylov_fused.fused_cg_update(x, r, p, ap, alpha)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            break
    counts = {name: names.count(name) for name in set(names)}
    assert len(counts) == 1 and "cg_update_kernel" in names[0], counts
    assert 1 <= len(names) <= 10, counts


@pytest.mark.cuda
def test_cg_update_on_two_streams_at_once(cuda_device):
    """Calls on two streams that do not wait on each other, at sizes of
    64, 1 and 1024 blocks: each stream has a ticket and partials of its
    own, so every result is bitwise what the default stream gives."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    alpha = torch.tensor(0.37, device=cuda_device)
    args = [[torch.randn(n, generator=g, device=cuda_device)
             for _ in range(4)] + [alpha] for n in (16384, 130, 1 << 22)]
    wants = [krylov_fused.fused_cg_update(*a) for a in args]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    gots = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                gots[i] += [krylov_fused.fused_cg_update(*a)
                            for a in (args if i == 0 else args[::-1])]
    torch.cuda.synchronize()
    for i in range(2):
        order = wants if i == 0 else wants[::-1]
        for j, got in enumerate(gots[i]):
            for a, b in zip(got, order[j % len(args)]):
                assert torch.equal(a, b)


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
# path's n = 16384, nb = 128 at its first, middle and next-to-last steps;
# then a trailing block of 3 tiles, the last ragged (m = 320), nb = 256 >
# 128 (the next diagonal block spans a mirrored tile), and nb = 13 with
# n % 4 = 2 (4-byte copies and accesses, m = 364)
PANEL_CASES = [(128, 32, 0), (128, 32, 64), (128, 32, 96), (256, 64, 64),
               (16384, 128, 0), (16384, 128, 8192), (16384, 128, 16128),
               (384, 32, 32), (512, 256, 0), (390, 13, 13)]
# the LU step, and the Cholesky step on the SPD ``a aᵀ/n + 4I``, on it made
# exactly symmetric ((a + aᵀ)/2), and with a Gaussian upper triangle added
PANEL_KINDS = ["lu", "cholesky", "cholesky-symmetric", "cholesky-unsymmetric"]
# (n, m): the reference's trsm test shapes, m = 1 and a 1-D b, n = 16384
TRSM_CASES = [(128, 128), (256, 128), (256, 64), (100, 1), (130, 7),
              (100, 0), (16384, 0), (16384, 128),
              # more block rows (160) than the card has SMs; a ragged n
              # (4-byte copies); m = 33 crosses a 32-column slice
              (20480, 0), (20480, 3), (16383, 0), (16383, 33), (1000, 33)]


def _panel_inputs(n, nb, k, kind, dev):
    """A Gaussian (or, for a Cholesky ``kind`` of ``PANEL_KINDS``, SPD)
    working matrix with a well-conditioned diagonal block at (k, k) and its
    inverse, as the factorizations hand them over."""
    g = torch.Generator(device=dev).manual_seed(n + nb + k)
    a = torch.randn(n, n, generator=g, device=dev)
    if kind != "lu":
        a = a @ a.T / n + 4 * torch.eye(n, device=dev)
        if kind == "cholesky-symmetric":
            a = (a + a.T) / 2
        elif kind == "cholesky-unsymmetric":
            a += torch.triu(torch.randn(n, n, generator=g, device=dev), 1)
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
@pytest.mark.parametrize("kind", PANEL_KINDS)
@pytest.mark.parametrize("n,nb,k", PANEL_CASES)
def test_panel_update_kernels_match_plain_versions(cuda_device, n, nb, k,
                                                   kind):
    """Held against the plain version; the Cholesky kernel computes the
    tiles on and below the diagonal and mirrors them, so on an exactly
    symmetric A its trailing block is bitwise symmetric, and on an A whose
    upper triangle differs it still reads each tile's own A."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, linv = _panel_inputs(n, nb, k, kind, cuda_device)
    name = "lu_panel_update" if kind == "lu" else "cholesky_panel_update"
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
    if kind == "cholesky-symmetric":
        tail = got[k + nb:, k + nb:]
        assert torch.equal(tail, tail.T)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_panel_update_kernels_a_call(cuda_device, kind):
    """A step is two CUDA kernels, the panel solve and the update (for
    Cholesky the symmetric variant), and one device copy, each at most
    once a call over 10 profiled calls (``torch.profiler`` drops a record
    now and then, never adds one; an empty trace is taken again).  The
    inverse is the factorizations' own, column-major from
    ``solve_triangular``: the kernels read it in place, so no call copies
    it."""
    from torch.profiler import ProfilerActivity, profile
    a, linv = _panel_inputs(4096, 128, 0, kind, cuda_device)
    assert linv.mT.is_contiguous()
    kernel = getattr(factor_fused, f"{kind}_panel_update")
    kernel(a, linv, 0, nb=128)          # built and launched once
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernel(a, linv, 0, nb=128)
            torch.cuda.synchronize()
        names = [e.name.replace(" ", "") for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            break
    counts = {name: names.count(name) for name in set(names)}
    kernels = [name for name in counts if "sgemm_kernel<" in name]
    copies = [name for name in counts if "Memcpy" in name]
    assert len(kernels) == 2 and len(copies) == 1, counts
    assert set(counts) == set(kernels + copies), counts
    assert all(1 <= c <= 10 for c in counts.values()), counts
    symmetric = [name for name in kernels
                 if "sgemm_kernel<true,true,true,true>" in name]
    assert len(symmetric) == (kind == "cholesky"), counts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_panel_update_kernels_take_a_row_major_inverse(cuda_device, kind):
    """A row-major inverse gives the same result, bitwise, as the
    column-major one the factorizations pass."""
    a, linv = _panel_inputs(640, 128, 128, kind, cuda_device)
    kernel = getattr(factor_fused, f"{kind}_panel_update")
    want = kernel(a.clone(), linv, 128, nb=128)
    got = kernel(a.clone(), linv.contiguous(), 128, nb=128)
    assert not linv.is_contiguous()
    assert torch.equal(got, want)


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
def test_trsm_solves_on_two_streams_do_not_interfere(cuda_device):
    """Each solve keeps its ready flags and ticket in a workspace of its
    own, so two solves in flight on two streams give bitwise what each
    gives alone."""
    t, g = _triangle(4096, False, cuda_device)
    b1 = torch.randn(4096, generator=g, device=cuda_device)
    b2 = torch.randn(4096, 5, generator=g, device=cuda_device)
    want1, want2 = trsm.trsm_lower(t, b1), trsm.trsm_lower(t, b2)
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(streams[0]):
        got1 = trsm.trsm_lower(t, b1)
    with torch.cuda.stream(streams[1]):
        got2 = trsm.trsm_lower(t, b2)
    torch.cuda.synchronize()
    assert torch.equal(got1, want1) and torch.equal(got2, want2)


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
@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_unfused_kernel_route_matches_the_plain_route(cuda_device, method):
    """fuse_panel=False on the card: U12 / L21 by the triangular-solve
    kernel, the trailing update by the tiled GEMM kernel (one product a
    step but the last), held against the plain route at the direct tests'
    float32 tolerance (rtol 1e-4, atol 1e-3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    n, nb = 1000, 128                     # padded to 1024: 8 steps
    a = rng.standard_normal((n, n))
    a = a @ a.T / n + 4 * np.eye(n) if method == "cholesky" \
        else a + n * np.eye(n)
    a = torch.tensor(a, dtype=torch.float32, device=cuda_device)
    factor = lu.lu_factor if method == "lu" else cholesky.cholesky_factor
    before = (gemm.LAUNCHES["matmul"], trsm.LAUNCHES["trsm"])
    got = factor(a, block_size=nb, backend="cuda", fuse_panel=False)
    assert gemm.LAUNCHES["matmul"] == before[0] + 7
    assert trsm.LAUNCHES["trsm"] == before[1] + 7
    again = factor(a, block_size=nb, backend="cuda", fuse_panel=False)
    want = factor(a, block_size=nb, backend="ref")
    got, again, want = ((v,) if method == "cholesky" else v
                        for v in (got, again, want))
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        if g.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
        else:
            assert torch.equal(g, w)               # the same pivots


# (m, n, k) and the operands' layout: ragged shapes, strided and transposed
# views, a split K (few output tiles, a long K), then the main path's
# products: the unfused QR's V^T A, T^T W and V Y at m = 32768, n = 8192,
# nb = 128, k = 0, and the unfused LU's trailing update at n = 16384
GEMM_CASES = [(1, 1, 1, "plain"), (130, 70, 33, "plain"),
              (129, 257, 200, "views"), (128, 300, 20000, "transposed"),
              (128, 8064, 32768, "transposed"), (128, 8064, 128, "plain"),
              (32768, 8064, 128, "plain"), (16256, 16256, 128, "views"),
              # A with column stride 2; a transposed B; K = 1; K not a
              # multiple of the 32-deep slice; base pointers that are not
              # 16-byte aligned; M = 128 with K = 65536 (a deep split)
              (130, 300, 100, "strided"), (200, 136, 96, "transposed b"),
              (64, 96, 1, "plain"), (300, 260, 77, "plain"),
              (131, 133, 45, "unaligned"), (128, 256, 65536, "transposed")]


def _gemm_operands(m, n, k, layout, dev):
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    if layout == "transposed":            # V^T read in place
        a = torch.randn(k, m, generator=g, device=dev).T
    elif layout == "views":               # blocks of larger matrices
        a = torch.randn(m + 3, k + 5, generator=g, device=dev)[3:, 5:]
    elif layout == "strided":             # every other column
        a = torch.randn(m, 2 * k, generator=g, device=dev)[:, ::2]
    elif layout == "unaligned":           # 4 bytes past a 16-byte boundary
        a = torch.randn(m * k + 1, generator=g, device=dev)[1:].view(m, k)
    else:
        a = torch.randn(m, k, generator=g, device=dev)
    if layout == "views":
        b = torch.randn(k + 2, n + 4, generator=g, device=dev)[2:, :n]
    elif layout == "transposed b":
        b = torch.randn(n, k, generator=g, device=dev).T
    elif layout == "unaligned":
        b = torch.randn(k * n + 3, generator=g, device=dev)[3:].view(k, n)
    else:
        b = torch.randn(k, n, generator=g, device=dev)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,layout", GEMM_CASES)
def test_gemm_kernel_matches_plain_version(cuda_device, m, n, k, layout):
    """Against the plain product (cuBLAS in full float32) at rtol 1e-4 and
    atol 1e-4 of max|C|: two float32 summation orders over K = 32768 differ
    by ~1e-5 of |C|, a TF32 product by ~1e-3.  Reruns are bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _gemm_operands(m, n, k, layout, cuda_device)
    before = gemm.LAUNCHES["matmul"]
    got = gemm.matmul(a, b)
    assert torch.equal(got, gemm.matmul(a, b))
    want = ref.matmul(a, b)
    assert got.shape == (m, n) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    assert gemm.LAUNCHES["matmul"] == before + 2


@pytest.mark.cuda
def test_gemm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    a = torch.ones(4, 4, device=cuda_device)
    with pytest.raises(TypeError):
        gemm.matmul(a.double(), a.double())
    with pytest.raises(TypeError):
        gemm.matmul(a.half(), a.half())
    with pytest.raises(ValueError):
        gemm.matmul(a, torch.ones(4, 4))              # two devices
    assert torch.equal(gemm.matmul(a[:, :0], a[:0]),
                       torch.zeros(4, 4, device=cuda_device))


def _qr_step(m, n, nb, k, dev):
    """The path's Gaussian A/√m with its panel at column k factored by the
    port's own panel QR, and that panel's active (m − k, nb) V and its T."""
    from repro_torch.core import qr
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn(m, n, generator=g, device=dev) / m ** 0.5
    pan = a[k:, k:k + nb]
    taus = qr._panel_qr(pan)
    v = qr._panel_v(pan)
    t = qr._form_t(v, taus)
    return a, v, t


# (m, n, nb, k): small and ragged-in-rows shapes, then the least-squares
# path's m = 32768, n = 8192, nb = 128 at k = 0, n/2 and n − 2nb; then a
# window ragged in rows and columns (984 x 496), W = VᵀA split over
# K = 4096 (2 output tiles), and A −= V·Y split over K = nb = 1024 (128
# output tiles), its parts subtracted in order by a second launch
QR_CASES = [(96, 64, 16, 0), (96, 64, 16, 32), (96, 80, 16, 48),
            (1000, 256, 128, 0), (32768, 8192, 128, 0),
            (32768, 8192, 128, 4096), (32768, 8192, 128, 7936),
            (1000, 520, 8, 16), (4096, 256, 64, 0), (2048, 2048, 1024, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,nb,k", QR_CASES)
def test_qr_panel_update_kernel_matches_plain_version(cuda_device, m, n, nb,
                                                      k):
    """On real Householder panels, held on the change the update makes:
    atol 1e-4 of its largest entry (W sums up to m − k = 32768 products),
    rtol 1e-5; the columns left of k + nb are untouched; reruns are
    bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, v, t = _qr_step(m, n, nb, k, cuda_device)
    before = qr_fused.LAUNCHES["qr_panel_update"]
    got = qr_fused.qr_panel_update(a.clone(), v, t, k, nb=nb)
    again = qr_fused.qr_panel_update(a.clone(), v, t, k, nb=nb)
    want = ref.qr_panel_update(a.clone(), v, t, k, nb=nb)
    assert torch.equal(got, again)
    assert torch.equal(got[:, :k + nb], a[:, :k + nb])
    assert torch.equal(got[:k], a[:k])
    change = float((want - a).abs().max())
    assert change > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * change)
    assert qr_fused.LAUNCHES["qr_panel_update"] == before + 2


def _unaligned(x):
    """A contiguous copy of ``x`` whose base is 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,nb,k,layout", [
    (1000, 256, 16, 32, "unaligned base"), (1000, 250, 10, 20, "n % 4 = 2"),
    (700, 390, 13, 13, "n % 4 = 2")])
def test_qr_panel_update_kernel_on_an_unaligned_window(cuda_device, m, n, nb,
                                                       k, layout):
    """A window whose base is not 16-byte aligned (A and V 4 bytes past a
    boundary) or whose row stride is not a multiple of 4 floats takes the
    subtracting epilogue's 4-byte accesses (and V's 4-byte copies): held
    as on aligned windows, bitwise on reruns, nothing written outside the
    window."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, v, t = _qr_step(m, n, nb, k, cuda_device)
    fresh = _unaligned if layout == "unaligned base" else torch.clone
    if layout == "unaligned base":
        v = _unaligned(v)
        assert a.data_ptr() % 16 == 0 and fresh(a).data_ptr() % 16 == 4
    got = qr_fused.qr_panel_update(fresh(a), v, t, k, nb=nb)
    again = qr_fused.qr_panel_update(fresh(a), v, t, k, nb=nb)
    want = ref.qr_panel_update(a.clone(), v, t, k, nb=nb)
    assert torch.equal(got, again)
    assert torch.equal(got[:, :k + nb], a[:, :k + nb])
    assert torch.equal(got[:k], a[:k])
    change = float((want - a).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * change)


@pytest.mark.cuda
def test_qr_panel_update_launches_nothing_at_the_last_step(cuda_device):
    a, v, t = _qr_step(96, 64, 16, 48, cuda_device)
    before = qr_fused.LAUNCHES["qr_panel_update"]
    assert torch.equal(qr_fused.qr_panel_update(a.clone(), v, t, 48, nb=16),
                       a)
    assert qr_fused.LAUNCHES["qr_panel_update"] == before
    with pytest.raises(TypeError):
        qr_fused.qr_panel_update(a.double(), v, t, 0, nb=16)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_qr_solve_goes_through_the_kernels(cuda_device, fuse):
    """qr on a padded (1000, 300) system: kernel 9 (fused) or kernel 7
    (unfused) a step, the triangular-solve kernel in the apply; x and the
    factor against the plain float32 route."""
    from repro_torch.core import qr
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.standard_normal((1000, 300)), dtype=torch.float32,
                     device=cuda_device)
    b = torch.tensor(rng.standard_normal(1000), dtype=torch.float32,
                     device=cuda_device)
    before = (qr_fused.LAUNCHES["qr_panel_update"], gemm.LAUNCHES["matmul"],
              trsm.LAUNCHES["trsm"])
    st = qr.qr_factor(a, block_size=128, backend="cuda", fuse_panel=fuse)
    x = qr.qr_apply(st, b, backend="cuda")[:300]
    rose = (qr_fused.LAUNCHES["qr_panel_update"] - before[0],
            gemm.LAUNCHES["matmul"] - before[1],
            trsm.LAUNCHES["trsm"] - before[2])
    assert rose == ((2, 0, 1) if fuse else (0, 6, 1))   # 3 steps, 2 updates
    want = qr.qr_factor(a, block_size=128, backend="ref")
    torch.testing.assert_close(st.qr, want.qr, rtol=1e-3, atol=1e-4)
    xo = np.linalg.lstsq(a.double().cpu().numpy(), b.double().cpu().numpy(),
                         rcond=None)[0]
    np.testing.assert_allclose(x.cpu().numpy(), xo, rtol=0,
                               atol=1e-4 * np.abs(xo).max())
    res = api.solve(a, b, method="qr", backend="cuda", return_info=True)
    assert bool(res.converged) and res.x.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lsqr", "cgls"])
def test_least_squares_iterations_go_through_the_kernels(cuda_device,
                                                        method):
    """lsqr / cgls on a rectangular BSR (the SpMV kernel for Ax and Aᵀx)
    and cgls on a square dense system (the fused update for its paired
    axpys): converged, with the plain backend's iteration count within
    max(1.2×, +2)."""
    rng = np.random.default_rng(3)
    d = rng.standard_normal((640, 256))
    d[np.abs(d) < 1.0] = 0
    b = rng.standard_normal(640).astype(np.float32)
    bsr = BSR.from_dense(d.astype(np.float32), block_size=32,
                         device=cuda_device)
    before = spmv.LAUNCHES["bsr_matvec"]
    res = api.solve(bsr, b, method=method, backend="cuda", tol=1e-5,
                    return_info=True)
    ref_res = api.solve(bsr, b, method=method, tol=1e-5, return_info=True)
    assert spmv.LAUNCHES["bsr_matvec"] > before
    assert bool(res.converged)
    assert res.iterations <= max(1.2 * ref_res.iterations,
                                 ref_res.iterations + 2)
    if method == "cgls":
        n = 512
        a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
        before = krylov_fused.LAUNCHES["fused_cg_update"]
        res = api.solve(a, a[:, 0], method="cgls", backend="cuda",
                        return_info=True)
        assert krylov_fused.LAUNCHES["fused_cg_update"] > before
        assert bool(res.converged)


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


# --------------------------------------------------------------------------
# kernel 3: the fused Gram matrix and the s-step path
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 16514, 1 << 21])
@pytest.mark.parametrize("k", [1, 5, 9, 17, 33])
def test_gram_kernel_matches_plain_version(cuda_device, k, n):
    """G = V Vᵀ against the plain product at rtol 1e-5, atol 1e-5·max|G|
    (the reference's Gram test tolerance, scaled to G), exactly
    symmetric, bitwise-repeatable, one launch per call."""
    g = torch.Generator(device=cuda_device).manual_seed(k * 7 + n)
    v = torch.randn(k, n, generator=g, device=cuda_device)
    before = krylov_fused.LAUNCHES["fused_gram"]
    got = krylov_fused.fused_gram(v)
    assert torch.equal(got, krylov_fused.fused_gram(v))
    assert krylov_fused.LAUNCHES["fused_gram"] == before + 2
    assert got.shape == (k, k) and got.dtype == torch.float32
    assert got.device == v.device and torch.equal(got, got.T)
    want = ref.fused_gram(v)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def _gram_close(got, v):
    want = ref.fused_gram(v)
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(280001, 0), (280002, 0), (280003, 0),
                                      (280000, 1)])
@pytest.mark.parametrize("k", [5, 9])
def test_gram_kernel_on_ragged_columns(cuda_device, k, n, offset):
    """n ≡ 1, 2, 3 (mod 4), or V 4 bytes past a 16-byte boundary: the
    one-launch kernel's 4-byte loads, the last quad's missing columns
    zero; held as above, bitwise on reruns."""
    g = torch.Generator(device=cuda_device).manual_seed(n + k)
    v = torch.randn(k, n, generator=g, device=cuda_device)
    if offset:
        buf = torch.empty(k * n + offset, device=cuda_device)
        v = buf[offset:].view(k, n).copy_(v)
    got = krylov_fused.fused_gram(v)
    assert torch.equal(got, krylov_fused.fused_gram(v))
    _gram_close(got, v)


@pytest.mark.cuda
def test_gram_ticket_resets_between_calls(cuda_device):
    """Calls at different n (16, 264 and 1 blocks) and k back to back, with
    no synchronisation between them, each find their own last block: the
    ticket is back at 0 after every launch."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    vs = [torch.randn(k, n, generator=g, device=cuda_device)
          for k, n in ((9, 16384), (9, 1 << 21), (5, 7), (12, 300000))]
    vs.insert(3, vs[0])
    gots = [krylov_fused.fused_gram(v) for v in vs]
    torch.cuda.synchronize()
    for got, v in zip(gots, vs):
        _gram_close(got, v)
    assert torch.equal(gots[0], gots[3])


@pytest.mark.cuda
def test_gram_kernel_on_two_streams_in_turn(cuda_device):
    """Calls on two streams that wait on each other in turn, each stream on
    its own workspace: every result bitwise equal to the default
    stream's."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    v = torch.randn(9, 1 << 20, generator=g, device=cuda_device)
    want = krylov_fused.fused_gram(v)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    prev, gots = torch.cuda.current_stream(cuda_device), []
    for i in range(4):
        s = streams[i % 2]
        s.wait_stream(prev)
        with torch.cuda.stream(s):
            gots.append(krylov_fused.fused_gram(v))
        prev = s
    torch.cuda.synchronize()
    for got in gots:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_gram_kernel_on_two_streams_at_once(cuda_device):
    """Calls on two streams that do not wait on each other, at shapes of
    16, 264 and 132 blocks: each stream has a ticket and partials of its
    own, so every result is bitwise what the default stream gives."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    vs = [torch.randn(k, n, generator=g, device=cuda_device)
          for k, n in ((9, 16384), (9, 1 << 21), (5, 1 << 20), (12, 300000))]
    wants = [krylov_fused.fused_gram(v) for v in vs]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    gots = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                gots[i] += [krylov_fused.fused_gram(v)
                            for v in (vs if i == 0 else vs[::-1])]
    torch.cuda.synchronize()
    for i in range(2):
        order = wants if i == 0 else wants[::-1]
        for j, got in enumerate(gots[i]):
            assert torch.equal(got, order[j % len(vs)])


@pytest.mark.cuda
def test_gram_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    v = torch.ones(5, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        krylov_fused.fused_gram(v.double())
    with pytest.raises(TypeError, match="float32"):
        krylov_fused.fused_gram(v.half())
    with pytest.raises(ValueError, match="contiguous"):
        krylov_fused.fused_gram(v.T)
    with pytest.raises(ValueError, match="contiguous"):
        krylov_fused.fused_gram(v[:, ::2])
    with pytest.raises(ValueError, match="row-stack"):
        krylov_fused.fused_gram(v[0])


def _s_step_systems(dev):
    """The dense SPD ``a aᵀ/n + 4I`` and ``a + nI`` at n = 4096 and the
    Poisson BSR on a 32³ grid (nb = 32), each with a Gaussian b."""
    rng = np.random.default_rng(5)
    n = 4096
    a = rng.standard_normal((n, n))
    b = rng.standard_normal(n).astype(np.float32)
    spd = (a @ a.T / n + 4.0 * np.eye(n)).astype(np.float32)
    dominant = (a + n * np.eye(n)).astype(np.float32)
    poisson = problems.poisson_3d_bsr(32, 32, device=dev)
    bp = rng.standard_normal(poisson.shape[0]).astype(np.float32)
    return {"spd": (spd, b), "dominant": (dominant, b),
            "poisson": (poisson, bp)}


@pytest.mark.cuda
@pytest.mark.parametrize("method,s,system", [
    ("ca_cg", 2, "spd"), ("ca_gmres", 4, "dominant"),
    ("ca_gmres", 8, "dominant"), ("ca_cg", 2, "poisson"),
    ("ca_gmres", 4, "poisson")])
def test_s_step_solve_goes_through_the_gram_kernel(cuda_device, method, s,
                                                   system):
    """``backend="cuda"`` against ``"ref"`` on the card: the same
    ``fail_reason``; where the reference converged, converged with
    iterations within max(1.2×, +2) and a true relative residual ≤ 1e-4
    (float64); the Gram kernel (and on the BSR the SpMV kernel)
    launched."""
    a, b = _s_step_systems(cuda_device)[system]
    kw = dict(method=method, s=s, return_info=True)
    ref_res = api.solve(a, b, **kw)
    before = (krylov_fused.LAUNCHES["fused_gram"], spmv.LAUNCHES["bsr_matvec"])
    res = api.solve(a, b, backend="cuda", **kw)
    assert krylov_fused.LAUNCHES["fused_gram"] > before[0]
    if system == "poisson":
        assert spmv.LAUNCHES["bsr_matvec"] > before[1]
    assert res.info["fail_reason"] == ref_res.info["fail_reason"]
    if bool(ref_res.converged):
        assert bool(res.converged)
        assert res.iterations <= max(1.2 * ref_res.iterations,
                                     ref_res.iterations + 2)
        bt = torch.from_numpy(b).to(cuda_device).double()
        x64 = res.x.double()
        if system == "poisson":
            a64 = BSR(a.data.double(), a.indices, a.indptr, a.shape, a.nb,
                      device=cuda_device)
            r = bt - a64.matvec(x64)
        else:
            r = bt - torch.from_numpy(a).to(cuda_device).double() @ x64
        assert float(torch.linalg.norm(r) / torch.linalg.norm(bt)) <= 1e-4


@pytest.mark.cuda
def test_float32_ca_cg_s4_on_the_dense_spd_system_runs_through_the_kernel(
        cuda_device):
    """float32 ca_cg at s = 4 on the n = 4096 SPD system: its iteration
    count and stop are decided by the Gram matrix's rounding in both
    packages (ROADMAP §3; the test below shows it with three Gram
    computations), so the two backends are not held to each other here;
    the kernel runs and x stays finite."""
    a, b = _s_step_systems(cuda_device)["spd"]
    before = krylov_fused.LAUNCHES["fused_gram"]
    res = api.solve(a, b, method="ca_cg", s=4, backend="cuda",
                    return_info=True)
    assert krylov_fused.LAUNCHES["fused_gram"] > before
    assert torch.isfinite(res.x).all() and torch.isfinite(res.residual)


@pytest.mark.cuda
def test_float32_ca_cg_s4_stop_moves_with_the_gram_rounding(cuda_device,
                                                             capsys):
    """float32 ca_cg at s = 4 on the n = 16384 SPD system ``a aᵀ/n + 4I``
    of ``chip_smoke.py`` for four Gaussian b, each solved with three Gram
    computations: the plain float32 product (cuBLAS), kernel 3, and the
    float64 product rounded to float32.  Prints each run's iterations,
    stop and true residual (run with ``-s``): the stop moves with the
    Gram's rounding (ROADMAP §3).  Every x is finite, and kernel 3's best
    iterate has a true relative residual ≤ 1e-2."""
    from repro_torch import device as _device
    from repro_torch.core import krylov
    from repro_torch.core.operator import DenseOperator
    from repro_torch.launch.solve import relative_residual
    from repro_torch.resilience import monitor
    n = 16384
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=cuda_device)
    a = a @ a.T / n + 4.0 * torch.eye(n, device=cuda_device)
    grams = {"plain_float32": lambda v: v @ v.T,
             "kernel3": krylov_fused.fused_gram,
             "float64_rounded": lambda v: (v.double() @ v.double().T)
             .float()}
    for seed in (1, 2, 3, 4):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        b = torch.randn(n, generator=g, device=cuda_device)
        cells, kernel_rel = [], None
        for name, gram in grams.items():
            op = DenseOperator(a)
            op.block_dots = gram
            with _device.full_fp32():
                res = krylov.ca_cg(op, b, s=4)
            assert torch.isfinite(res.x).all(), (name, seed)
            rel = relative_residual(a, b, res.x)
            if name == "kernel3":
                kernel_rel = rel
            cells.append(f"{name}: iterations={res.iterations} fail_reason="
                         f"{monitor.classify(res.info['fail_code'])} "
                         f"converged={bool(res.converged)} "
                         f"rel_residual={rel:.3e}")
        with capsys.disabled():
            print(f"[s-step-witness] ca_cg s=4 spd n={n} float32 "
                  f"seed={seed} " + " | ".join(cells))
        assert kernel_rel <= 1e-2, (seed, kernel_rel)


# --------------------------------------------------------------------------
# kernel 10: flash attention, and the serving path through it
# --------------------------------------------------------------------------

# one ulp of the largest output in the working type: the kernel and the
# plain version both compute in float32 and round once
# unit roundoff of the output type: one rounding of the float32 result
ATTENTION_ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
ATTENTION_F32_SLACK = 1e-5


def _attention_inputs(dev, b, hq, hkv, tq, tk, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, h, t, d, generator=g, device=dev).to(dtype)
            for h, t in ((hq, tq), (hkv, tk), (hkv, tk))]


def _plain_attention_f32(q, k, v, **kw):
    """The plain version in float32 from the same (low-precision) inputs,
    before the output is rounded to their type."""
    return ref.attention(q.float(), k.float(), v.float(), **kw)


def _attention_close(got, want):
    """``want`` is the float32 plain version; a bf16 / fp16 ``got`` may
    differ from it by one rounding of each element, plus float32 slack."""
    assert want.dtype == torch.float32 and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got.float() - want).abs()
        limit = (ATTENTION_ROUNDING[got.dtype] * want.abs()
                 + ATTENTION_F32_SLACK)
        assert (err <= limit).all(), float((err / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("d", [16, 64, 112, 128])
@pytest.mark.parametrize("case", [
    (2, 4, 2, 256, 256, True, None), (2, 4, 2, 256, 256, False, None),
    (1, 8, 1, 256, 256, True, 128), (1, 4, 2, 128, 512, True, None),
    (1, 4, 4, 100, 100, True, None), (1, 2, 1, 32, 96, True, 40)],
    ids=["causal", "full", "window", "offset", "short", "short-window"])
def test_attention_kernel_matches_plain_version(cuda_device, case, d, dtype):
    b, hq, hkv, tq, tk, causal, window = case
    q, k, v = _attention_inputs(cuda_device, b, hq, hkv, tq, tk, d, dtype)
    before = attention.LAUNCHES["flash_attention"]
    got = attention.flash_attention(q, k, v, causal=causal, window=window)
    again = attention.flash_attention(q, k, v, causal=causal, window=window)
    assert attention.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, again)              # no atomics: bitwise reruns
    _attention_close(got, _plain_attention_f32(q, k, v, causal=causal,
                                               window=window))


@pytest.mark.cuda
def test_attention_kernel_reads_strided_views(cuda_device):
    """The attention layer hands over head-transposed views of the
    projections; the kernel reads their strides."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 256, 8, 64, generator=g, device=cuda_device)
    heads = x.transpose(1, 2)                   # (2, 8, 256, 64), strided
    q, k, v = heads[:, :4], heads[:, 4:6], heads[:, 6:]
    assert not q.is_contiguous()
    _attention_close(attention.flash_attention(q, k, v),
                     ref.attention(q.contiguous(), k.contiguous(),
                                   v.contiguous()))


@pytest.mark.cuda
def test_attention_kernel_rows_without_a_visible_key(cuda_device):
    """Causal with Tq > Tk, as the reference kernel does it: rows whose
    tiles are all skipped return 0, rows masked inside a live tile the mean
    of its values (the plain version returns NaN there); the other rows
    match the plain version."""
    for tq, tk in ((256, 128), (128, 64)):
        q, k, v = _attention_inputs(cuda_device, 1, 2, 1, tq, tk, 16,
                                    torch.float32, seed=tq)
        got = attention.flash_attention(q, k, v)
        dead = tq - tk
        _attention_close(got[:, :, dead:],
                         ref.attention(q, k, v)[:, :, dead:])
        if tq == 256:
            assert (got[:, :, :dead] == 0).all()
        else:
            want = v.mean(dim=2, keepdim=True).expand(1, 2, dead, 16)
            torch.testing.assert_close(got[:, :, :dead], want, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
def test_attention_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    q, k, v = _attention_inputs(cuda_device, 1, 4, 2, 256, 256, 64,
                                torch.float32)
    before = attention.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="not tiled"):
        attention.flash_attention(q[:, :, :192], k, v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 128, 264, device=cuda_device)
        attention.flash_attention(big, big, big)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        attention.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="q is"):
        attention.flash_attention(q, k.half(), v.half())
    three = k[:, :1].expand(1, 3, 256, 64)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        attention.flash_attention(q, three, three)
    leaf = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        attention.flash_attention(leaf * 1.0, k, v)
    assert attention.LAUNCHES["flash_attention"] == before
    with torch.inference_mode():                # the serving path's mode
        attention.flash_attention(leaf * 1.0, k, v)
    assert attention.LAUNCHES["flash_attention"] == before + 1


def _float32_attention_close(q, k, v, **kw):
    """Kernel 10 on float32 inputs goes to the float32 kernel, reruns
    bitwise and holds rtol = atol = 1e-4 against the plain version."""
    before = dict(attention.LAUNCHES)
    got = attention.flash_attention(q, k, v, **kw)
    again = attention.flash_attention(q, k, v, **kw)
    assert attention.LAUNCHES["flash_attention_f32"] \
        == before["flash_attention_f32"] + 2
    assert torch.equal(got, again)
    _attention_close(got, ref.attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("case", [
    (2, 4, 2, 256, 256, True, None), (2, 4, 2, 256, 256, False, None),
    (1, 8, 1, 256, 256, True, 128), (1, 4, 2, 128, 512, True, None),
    (1, 4, 4, 100, 100, True, None)],
    ids=["causal", "full", "window", "offset", "short"])
def test_float32_attention_kernel_above_d128(cuda_device, case, d):
    """128 < D <= 256 runs the float32 file's wide kernel (64 rows a
    CTA)."""
    b, hq, hkv, tq, tk, causal, window = case
    _float32_attention_close(*_attention_inputs(
        cuda_device, b, hq, hkv, tq, tk, d, torch.float32),
        causal=causal, window=window)


@pytest.mark.cuda
def test_float32_attention_on_qwen3_long_rows(cuda_device):
    """qwen3-1.7b's heads (16 / 8, D = 128) over 2048 keys, causal: 16 row
    tiles, the last one over 16 key tiles."""
    _float32_attention_close(*_attention_inputs(
        cuda_device, 1, 16, 8, 2048, 2048, 128, torch.float32, seed=8))


def _reaches_128_row_ctas(dev, b, hq, tq):
    """The float32 kernel runs 128 query rows a CTA where the grid's row
    tiles, batch·heads·⌈Tq/128⌉, fill the card's SMs (64 rows below)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return b * hq * -(-tq // 128) >= sms


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (2, 32, 8, 512, 512, True, 200, 128),
    (2, 32, 8, 512, 512, False, None, 128),
    (5, 32, 8, 128, 2048, True, None, 128),
    (5, 32, 8, 128, 2048, True, 300, 128),
    (5, 32, 8, 128, 2048, False, None, 128),
    (5, 32, 8, 100, 100, True, None, 128),
    (5, 32, 8, 32, 96, True, 40, 128),
    (2, 32, 8, 512, 512, True, 200, 112),
    (2, 32, 8, 512, 512, True, 200, 30)],
    ids=["window", "full", "offset", "offset-window", "offset-full", "short",
         "short-window", "window-d112", "window-d30"])
def test_float32_attention_kernel_at_128_rows_a_cta(cuda_device, case):
    """The masks of ``test_attention_kernel_matches_plain_version`` on grids
    large enough for the 128-row variant the serving path runs: the window
    skip, the decode offset (Tq < Tk), the non-causal path, a short Tq and
    D = 112 / 30."""
    b, hq, hkv, tq, tk, causal, window, d = case
    assert _reaches_128_row_ctas(cuda_device, b, hq, tq)
    _float32_attention_close(*_attention_inputs(
        cuda_device, b, hq, hkv, tq, tk, d, torch.float32, seed=tq + d),
        causal=causal, window=window)


@pytest.mark.cuda
def test_float32_attention_at_128_rows_a_cta_rows_without_a_visible_key(
        cuda_device):
    """``test_attention_kernel_rows_without_a_visible_key`` on grids large
    enough for the 128-row variant: causal with Tq > Tk, rows whose tiles
    are all skipped return 0 (Tq = 512, Tk = 128: three dead row tiles),
    rows masked inside a live tile the mean of its values (Tq = 128,
    Tk = 64); the other rows match the plain version."""
    for b, tq, tk in ((2, 512, 128), (5, 128, 64)):
        assert _reaches_128_row_ctas(cuda_device, b, 32, tq)
        q, k, v = _attention_inputs(cuda_device, b, 32, 8, tq, tk, 128,
                                    torch.float32, seed=tq + tk)
        before = attention.LAUNCHES["flash_attention_f32"]
        got = attention.flash_attention(q, k, v)
        assert attention.LAUNCHES["flash_attention_f32"] == before + 1
        dead = tq - tk
        _attention_close(got[:, :, dead:],
                         ref.attention(q, k, v)[:, :, dead:])
        if tq == 512:
            assert (got[:, :, :dead] == 0).all()
        else:
            want = v.mean(dim=2, keepdim=True).repeat_interleave(
                4, dim=1).expand(b, 32, dead, 128)
            torch.testing.assert_close(got[:, :, :dead], want, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
def test_float32_attention_at_128_rows_a_cta_reads_strided_views(
        cuda_device):
    """Head-transposed views of the projections, as the attention layer
    hands them over, on a grid of the 128-row variant."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(2, 512, 48, 128, generator=g, device=cuda_device)
    heads = x.transpose(1, 2)                   # (2, 48, 512, 128), strided
    q, k, v = heads[:, :32], heads[:, 32:40], heads[:, 40:]
    assert not q.is_contiguous()
    assert _reaches_128_row_ctas(cuda_device, 2, 32, 512)
    _float32_attention_close(q, k, v)
    _float32_attention_close(q, k, v, window=200)
    _float32_attention_close(q, k, v, causal=False)


@pytest.mark.cuda
def test_float32_attention_without_16_byte_rows(cuda_device):
    """Rows the float32 kernel cannot copy 16 bytes at a time (D = 30, and
    a view whose feature stride is not 1) take its 4-byte copies."""
    _float32_attention_close(*_attention_inputs(
        cuda_device, 1, 4, 2, 256, 256, 30, torch.float32, seed=9))
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(1, 8, 64, 256, generator=g, device=cuda_device)
    heads = x.transpose(2, 3)                   # (1, 8, 256, 64), D stride 256
    q, k, v = heads[:, :4], heads[:, 4:6], heads[:, 6:]
    assert q.stride(3) != 1
    _float32_attention_close(q, k, v, window=100)
    _float32_attention_close(q, k, v, causal=False)


def _tensor_core_attention_close(q, k, v, **kw):
    """Kernel 10 on 16-bit inputs goes to the tensor-core kernel, reruns
    bitwise and holds the one-rounding gate."""
    before = dict(attention.LAUNCHES)
    got = attention.flash_attention(q, k, v, **kw)
    again = attention.flash_attention(q, k, v, **kw)
    assert attention.LAUNCHES["flash_attention_wgmma"] \
        == before["flash_attention_wgmma"] + 2
    assert torch.equal(got, again)
    _attention_close(got, _plain_attention_f32(q, k, v, **kw))


@pytest.mark.cuda
def test_tensor_core_attention_on_qwen3_long_rows(cuda_device):
    """qwen3-1.7b's heads (16 / 8, D = 128) over 2048 keys, bf16."""
    _tensor_core_attention_close(*_attention_inputs(
        cuda_device, 1, 16, 8, 2048, 2048, 128, torch.bfloat16, seed=3))


@pytest.mark.cuda
def test_tensor_core_attention_fp16_with_spread_scores(cuda_device):
    """q scaled by 4 spreads the scores, so many p fall below fp16's
    normal range unless P is scaled by 2^15 before it is split."""
    q, k, v = _attention_inputs(cuda_device, 1, 4, 2, 1024, 1024, 128,
                                torch.float16, seed=4)
    _tensor_core_attention_close(q * 4, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_attention_zero_pads_the_last_k_step(cuda_device, dtype,
                                                         causal):
    """D = 72: the fifth 16-wide step of D is half zero padding."""
    _tensor_core_attention_close(*_attention_inputs(
        cuda_device, 2, 4, 2, 256, 256, 72, dtype, seed=5), causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tensor_core_attention_without_16_byte_rows(cuda_device, dtype):
    """Rows the kernel cannot copy 16 bytes at a time (D = 36, and a view
    whose feature stride is not 1) take its 2-byte copy path."""
    _tensor_core_attention_close(*_attention_inputs(
        cuda_device, 1, 4, 2, 256, 256, 36, dtype, seed=6))
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(1, 8, 64, 256, generator=g, device=cuda_device)
    heads = x.to(dtype).transpose(2, 3)         # (1, 8, 256, 64), D stride 256
    q, k, v = heads[:, :4], heads[:, 4:6], heads[:, 6:]
    assert q.stride(3) != 1
    _tensor_core_attention_close(q, k, v, window=100)


@pytest.mark.cuda
def test_attention_dispatch_is_by_dtype(cuda_device):
    """bf16 and fp16 launch the tensor-core kernel, float32 the float32
    kernel, each counted on its own and in the total."""
    q, k, v = _attention_inputs(cuda_device, 1, 4, 2, 256, 256, 64,
                                torch.float32)
    for dtype, kernel, other in (
            (torch.bfloat16, "flash_attention_wgmma", "flash_attention_f32"),
            (torch.float16, "flash_attention_wgmma", "flash_attention_f32"),
            (torch.float32, "flash_attention_f32", "flash_attention_wgmma")):
        before = dict(attention.LAUNCHES)
        attention.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        assert attention.LAUNCHES[kernel] == before[kernel] + 1
        assert attention.LAUNCHES[other] == before[other]
        assert attention.LAUNCHES["flash_attention"] \
            == before["flash_attention"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tensor_core_attention_rows_without_a_visible_key(cuda_device,
                                                          dtype):
    """The float32 kernel's behaviour for causal Tq > Tk (see
    test_attention_kernel_rows_without_a_visible_key) on the tensor-core
    kernel: 0 where every tile is skipped, the live tile's mean of v where
    a row meets no visible key, one rounding of either."""
    for tq, tk in ((256, 128), (128, 64)):
        q, k, v = _attention_inputs(cuda_device, 1, 2, 1, tq, tk, 16, dtype,
                                    seed=tq)
        got = attention.flash_attention(q, k, v)
        dead = tq - tk
        _attention_close(got[:, :, dead:],
                         _plain_attention_f32(q, k, v)[:, :, dead:])
        if tq == 256:
            assert (got[:, :, :dead] == 0).all()
        else:
            want = v.float().mean(dim=2, keepdim=True).expand(1, 2, dead, 16)
            _attention_close(got[:, :, :dead], want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "tinyllama-1.1b"])
def test_serving_goes_through_the_attention_kernel(cuda_device, arch):
    """The REDUCED model on the card: one kernel launch a layer a prefill
    and none a decode step, and decode matches forward at the reference's
    bar (5e-2)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry, transformer
    cfg = get_config(arch, reduced=True)
    model = registry.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(1))
    g = torch.Generator(device=cuda_device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                         device=cuda_device)
    attention.reset_launches()
    _, state = transformer.prefill(model, {"tokens": toks[:, :128]}, cfg,
                                   cache_len=256)
    assert attention.LAUNCHES["flash_attention"] == cfg.num_layers
    got = [registry.decode_step(model, state, toks[:, i], i, cfg)[0]
           for i in range(128, 136)]
    assert attention.LAUNCHES["flash_attention"] == cfg.num_layers
    full = registry.forward(model, {"tokens": toks}, cfg)
    assert attention.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    torch.testing.assert_close(torch.stack(got, 1), full[:, 128:136],
                               rtol=5e-2, atol=5e-2)
