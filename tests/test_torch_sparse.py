"""The port's sparse iterative path against :mod:`repro.sparse` on the CPU.

Same numpy inputs through both packages:

* formats: ``from_dense`` / ``to_dense`` round trips (padded n,
  rectangular shapes, ELL); the ``indices``, ``indptr``, ``ell_layout``,
  ``block_diagonal`` and ``padded_data`` arrays identical to the
  reference's, and its validation errors word for word;
* operations (``matvec``, ``matvec_t``, ``transpose``, ``diagonal``):
  float32 at rtol = atol = 1e-5 (the reference's own sparse tests),
  float64 at rtol 1e-12;
* the plain SpMV against the reference's Pallas kernel in interpret mode,
  nb ∈ {8, 16, 20, 32}, k ∈ {1, 4}, float32 (rtol = atol = 1e-5) and
  float64 (rtol 1e-12);
* the three sparse preconditioners' ``apply`` on the same vector (float64,
  atol 1e-12);
* ``api.solve`` on BSR for all five methods with no, jacobi, block_jacobi
  and ssor preconditioning, and on ELL: x within 1e-5 (relative, 2-norm)
  of the reference in float64, as the reference's sparse/dense parity
  test asks; iterations within max(1.2×, +2); the same ``info`` schema;
* the reference's errors, the O(nnz) Poisson builder of ``chip_smoke.py``
  against ``from_dense``, and the interop of a reference BSR / ELL.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import operator as joperator
from repro.kernels import spmv as jspmv
from repro.sparse import BSR as JBSR, ELL as JELL
from repro.sparse import precond as jsprecond
from repro.sparse import problems as jproblems
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import operator as toperator
from repro_torch.kernels import ops, ref, spmv
from repro_torch.sparse import BSR, ELL, problems
from repro_torch.sparse import operator as tsoperator
from repro_torch.sparse import precond as tsprecond

METHODS = ("cg", "pipelined_cg", "bicg", "bicgstab", "gmres")
PRECONDS = (None, "jacobi", "block_jacobi", "ssor")
TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL64 = dict(rtol=1e-12, atol=0)


class _x64:
    """``jax_enable_x64`` on inside the block, restored after it."""

    def __enter__(self):
        self.old = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.old)


def _rel(x, ref_x):
    return np.linalg.norm(np.asarray(x) - ref_x) / np.linalg.norm(ref_x)


def _sparse_random(m, n, dtype=np.float32, seed=0, keep=0.3):
    """A random matrix with roughly ``keep`` of its entries nonzero, in
    clusters, so that some bricks are empty and some rows uneven."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    a[rng.random((m, n)) > keep] = 0
    a[:, n // 3: n // 2] = 0                      # empty brick columns
    return a.astype(dtype)


def _both_bsr(a, nb):
    return JBSR.from_dense(a, block_size=nb), BSR.from_dense(a, block_size=nb,
                                                             device="cpu")


SHAPES = {"square": (40, 40, 8), "padded": (37, 37, 8),
          "tall": (40, 24, 8), "wide": (24, 40, 8), "nb20": (64, 64, 20)}


# --------------------------------------------------------------------------
# formats
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
def test_bsr_structure_matches_reference(shape):
    m, n, nb = SHAPES[shape]
    a = _sparse_random(m, n)
    jb, tb = _both_bsr(a, nb)
    assert (tb.shape, tb.nb, tb.n_pad, tb.n_pad_cols, tb.nbr, tb.nbc) \
        == (jb.shape, jb.nb, jb.n_pad, jb.n_pad_cols, jb.nbr, jb.nbc)
    np.testing.assert_array_equal(tb.indices, jb.indices)
    np.testing.assert_array_equal(tb.indptr, jb.indptr)
    np.testing.assert_array_equal(tb.row_ids, jb.row_ids)
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    for got, want in zip(tb.ell_layout(), jb.ell_layout()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb.block_diagonal().numpy(),
                                  np.asarray(jb.block_diagonal()))
    np.testing.assert_array_equal(tb.padded_data().numpy(),
                                  np.asarray(jb.padded_data()))
    np.testing.assert_array_equal(tb.to_dense().numpy(), a)   # round trip
    assert (tb.nnz, tb.density, repr(tb)) == (jb.nnz, jb.density, repr(jb))
    tt, jt = tb.T, jb.T
    np.testing.assert_array_equal(tt.indices, jt.indices)
    np.testing.assert_array_equal(tt.indptr, jt.indptr)
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.to_dense().numpy(), a.T)


@pytest.mark.parametrize("max_nnz", [None, 20])
def test_ell_structure_matches_reference(max_nnz):
    a = _sparse_random(30, 30, seed=3)
    je = JELL.from_dense(a, max_nnz=max_nnz)
    te = ELL.from_dense(a, max_nnz=max_nnz, device="cpu")
    np.testing.assert_array_equal(te.cols, je.cols)
    np.testing.assert_array_equal(te.valid, je.valid)
    np.testing.assert_array_equal(te.data.numpy(), np.asarray(je.data))
    np.testing.assert_array_equal(te.to_dense().numpy(), a)
    assert (te.nnz, te.density, repr(te)) == (je.nnz, je.density, repr(je))


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_validation_errors_match_reference():
    a = _sparse_random(32, 32, seed=4)
    jb, tb = _both_bsr(a, 8)
    d = np.asarray(jb.data)
    decreasing = jb.indptr.copy()
    decreasing[1] = decreasing[2] + 1
    cases = [
        lambda m, k: m.BSR(d[:, :4], jb.indices, jb.indptr, jb.shape, 8,
                           **k),
        lambda m, k: m.BSR(d, jb.indices, jb.indptr[:-1], jb.shape, 8, **k),
        lambda m, k: m.BSR(d[:-1], jb.indices[:-1], jb.indptr, jb.shape, 8,
                           **k),
        lambda m, k: m.BSR(d, jb.indices + 100, jb.indptr, jb.shape, 8, **k),
        lambda m, k: m.BSR(d, jb.indices, decreasing, jb.shape, 8, **k),
        lambda m, k: m.BSR.from_dense(np.ones((4, 4), np.int32), **k),
        lambda m, k: m.BSR.from_dense(np.ones((2, 2, 2)), **k),
        lambda m, k: m.ELL.from_dense(np.ones((4, 6)), **k),
        lambda m, k: m.ELL.from_dense(a, max_nnz=1, **k),
        lambda m, k: m.ELL(np.ones((4, 3)), np.zeros((4, 2)),
                           np.ones((4, 2)), (4, 4), **k),
        lambda m, k: m.ELL(np.ones((4, 2)), np.zeros((4, 2)),
                           np.ones((4, 2)), (5, 5), **k),
        lambda m, k: m.ELL(np.ones((4, 2)), np.full((4, 2), 9),
                           np.ones((4, 2)), (4, 4), **k),
    ]
    import repro.sparse as jmod
    import repro_torch.sparse as tmod
    for case in cases:
        want = _error(lambda: case(jmod, {}))
        got = _error(lambda: case(tmod, {"device": "cpu"}))
        assert got == want


# --------------------------------------------------------------------------
# operations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bsr_operations_match_reference(shape, dtype):
    m, n, nb = SHAPES[shape]
    tol = TOL32 if dtype == "float32" else TOL64
    rng = np.random.default_rng(7)
    a = _sparse_random(m, n, dtype=dtype)
    xs = [rng.standard_normal(n).astype(dtype),
          rng.standard_normal((n, 3)).astype(dtype)]
    us = [rng.standard_normal(m).astype(dtype),
          rng.standard_normal((m, 2)).astype(dtype)]
    with _x64():
        jb, tb = _both_bsr(a, nb)
        for x in xs:
            np.testing.assert_allclose(tb.matvec(torch.from_numpy(x)).numpy(),
                                       np.asarray(jb.matvec(jnp.asarray(x))),
                                       **tol)
            np.testing.assert_allclose(
                tb.T.matvec(torch.from_numpy(us[0])).numpy(),
                np.asarray(jb.T.matvec(jnp.asarray(us[0]))), **tol)
        for u in us:
            np.testing.assert_allclose(
                tb.matvec_t(torch.from_numpy(u)).numpy(),
                np.asarray(jb.matvec_t(jnp.asarray(u))), **tol)
        if m == n:
            np.testing.assert_array_equal(tb.diagonal().numpy(),
                                          np.asarray(jb.diagonal()))
        np.testing.assert_array_equal(tb.padded_data().numpy(),
                                      np.asarray(jb.padded_data()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ell_operations_match_reference(dtype):
    tol = TOL32 if dtype == "float32" else TOL64
    rng = np.random.default_rng(8)
    a = _sparse_random(30, 30, dtype=dtype, seed=9)
    with _x64():
        je = JELL.from_dense(a)
        te = ELL.from_dense(a, device="cpu")
        for x in (rng.standard_normal(30).astype(dtype),
                  rng.standard_normal((30, 2)).astype(dtype)):
            for name in ("matvec", "matvec_t"):
                np.testing.assert_allclose(
                    getattr(te, name)(torch.from_numpy(x)).numpy(),
                    np.asarray(getattr(je, name)(jnp.asarray(x))), **tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("nb", [8, 16, 20, 32])
def test_plain_spmv_matches_pallas_kernel(nb, k, dtype):
    """The plain version of kernel 8 against the reference's Pallas SpMV in
    interpret mode; the CPU dispatch takes the plain version and launches
    nothing."""
    n = 3 * nb + 5                                  # a padded n
    tol = TOL32 if dtype == "float32" else TOL64
    a = _sparse_random(n, n, dtype=dtype, seed=nb)
    rng = np.random.default_rng(k)
    x = rng.standard_normal(n if k == 1 else (n, k)).astype(dtype)
    with _x64():
        jb, tb = _both_bsr(a, nb)
        want = np.asarray(jspmv.bsr_matvec(jb, jnp.asarray(x)))
    spmv.reset_launches()
    got = ref.bsr_matvec(tb, torch.from_numpy(x)).numpy()
    via_ops = ops.bsr_matvec(tb, torch.from_numpy(x)).numpy()
    assert spmv.LAUNCHES == {"bsr_matvec": 0}
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(via_ops, got)


def test_plain_spmv_is_deterministic_and_rejects_other_devices():
    a = _sparse_random(70, 70, seed=2)
    tb = BSR.from_dense(a, block_size=8, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(70)
                         .astype(np.float32))
    assert torch.equal(ops.bsr_matvec(tb, x), ops.bsr_matvec(tb, x))
    with pytest.raises(TypeError, match="must be a tensor"):
        spmv.bsr_matvec(tb, x.numpy())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        spmv.bsr_matvec(tb.to("meta"), x.to("meta"))


# --------------------------------------------------------------------------
# preconditioners
# --------------------------------------------------------------------------

def _poisson(nx=11, dtype=np.float64):
    """2-D Poisson, n = nx² (121: padded to 128 at nb = 16), smooth b."""
    a = jproblems.poisson_2d(nx).astype(dtype)
    return a, jproblems.smooth_rhs(a.shape[0], dtype=dtype)


@pytest.mark.parametrize("kind,fmt", [("jacobi", "bsr"), ("jacobi", "ell"),
                                      ("block_jacobi", "bsr"),
                                      ("ssor", "bsr")])
def test_sparse_preconditioners_match_reference(kind, fmt):
    a = _sparse_random(37, 37, seed=11) + 6 * np.eye(37)
    v = np.random.default_rng(12).standard_normal(37)
    with _x64():
        if fmt == "bsr":
            jm, tm = _both_bsr(a, 8)
        else:
            jm, tm = JELL.from_dense(a), ELL.from_dense(a, device="cpu")
        want = np.asarray(jsprecond.make(kind, jm).apply(jnp.asarray(v)))
    pc = tsprecond.make(kind, tm)
    assert pc.kind == kind
    np.testing.assert_allclose(pc.apply(torch.from_numpy(v)).numpy(), want,
                               rtol=0, atol=1e-12)


def test_sparse_preconditioner_errors_match_reference():
    a = _sparse_random(16, 16, seed=13) + 4 * np.eye(16)
    je, te = JELL.from_dense(a), ELL.from_dense(a, device="cpu")
    jb, tb = _both_bsr(a, 8)
    for name in ("block_jacobi", "ssor"):
        assert _error(lambda: getattr(tsprecond, name)(te)) \
            == _error(lambda: getattr(jsprecond, name)(je))
    assert _error(lambda: tsprecond.ssor(tb, omega=2.0)) \
        == _error(lambda: jsprecond.ssor(jb, omega=2.0))
    assert _error(lambda: tsprecond.make("ilu", tb)) \
        == _error(lambda: jsprecond.make("ilu", jb))
    assert tsprecond.make(None, tb) is None


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------

def _nonsym_sparse(nx=10, dtype=np.float64):
    """Poisson plus an upwind convection term: nonsymmetric, same
    sparsity."""
    a = jproblems.poisson_2d(nx).astype(dtype)
    n = a.shape[0]
    a -= 0.4 * np.eye(n, k=1, dtype=dtype)
    return a, jproblems.smooth_rhs(n, dtype=dtype, seed=1)


SYSTEMS = {"poisson": _poisson, "nonsym": _nonsym_sparse}
NB = 16
MAXITER = 2000


@functools.lru_cache(maxsize=None)
def _reference(system, method, precond, fmt="bsr"):
    a, b = SYSTEMS[system]()
    with _x64():
        m = JBSR.from_dense(a, block_size=NB) if fmt == "bsr" \
            else JELL.from_dense(a)
        r = japi.solve(m, jnp.asarray(b), method=method, precond=precond,
                       maxiter=MAXITER, return_info=True)
    return {"x": np.asarray(r.x), "iterations": int(r.iterations),
            "converged": bool(r.converged),
            "info": {k: (v if isinstance(v, str) or v is None else int(v))
                     for k, v in r.info.items()}}


def _port(system, fmt="bsr", **kw):
    a, b = SYSTEMS[system]()
    m = BSR.from_dense(a, block_size=NB, device="cpu") if fmt == "bsr" \
        else ELL.from_dense(a, device="cpu")
    r = tapi.solve(m, b, maxiter=MAXITER, return_info=True, device="cpu",
                   **kw)
    return {"x": r.x.numpy(), "iterations": r.iterations,
            "converged": bool(r.converged),
            "info": {k: (v if isinstance(v, str) or v is None else int(v))
                     for k, v in r.info.items()}}


def _assert_parity(got, want):
    assert want["converged"] and got["converged"]
    assert got["info"] == want["info"]
    assert set(got["info"]) == {"fail_code", "fail_iter", "fail_reason"}
    ref_it = want["iterations"]
    assert got["iterations"] <= max(1.2 * ref_it, ref_it + 2)
    assert ref_it <= max(1.2 * got["iterations"], got["iterations"] + 2)
    assert _rel(got["x"], want["x"]) <= 1e-5


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("method", METHODS)
def test_sparse_solve_matches_reference(method, precond, backend):
    want = _reference("poisson", method, precond)
    got = _port("poisson", method=method, precond=precond, backend=backend)
    _assert_parity(got, want)


@pytest.mark.parametrize("method", ["bicg", "bicgstab", "gmres"])
def test_nonsymmetric_sparse_solve_matches_reference(method):
    want = _reference("nonsym", method, None)
    got = _port("nonsym", method=method, backend="cuda")
    _assert_parity(got, want)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_ell_solve_matches_reference(precond):
    want = _reference("nonsym", "bicgstab", precond, fmt="ell")
    got = _port("nonsym", fmt="ell", method="bicgstab", precond=precond)
    _assert_parity(got, want)


def test_float32_sparse_solve_within_the_iteration_band():
    a, b = _poisson(dtype=np.float32)
    with _x64():
        want = japi.solve(JBSR.from_dense(a, block_size=NB), jnp.asarray(b),
                          method="cg", return_info=True)
    got = tapi.solve(BSR.from_dense(a, block_size=NB, device="cpu"), b,
                     method="cg", backend="cuda", device="cpu",
                     return_info=True)
    ref_it = int(want.iterations)
    assert bool(got.converged) and got.x.dtype == torch.float32
    assert got.iterations <= max(1.2 * ref_it, ref_it + 2)
    assert _rel(got.x.numpy(), np.asarray(want.x)) <= 1e-4


def test_sparse_operator_builds_the_transpose_only_for_the_kernel():
    a, _ = _nonsym_sparse()
    tb = BSR.from_dense(a, block_size=NB, device="cpu")
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(100))
    for backend, built in (("cuda", True), ("ref", False)):
        op = toperator.make_operator(tb, backend=backend)
        assert isinstance(op, tsoperator.SparseOperator)
        torch.testing.assert_close(op.matvec(v), torch.from_numpy(a) @ v,
                                   rtol=1e-12, atol=1e-12)
        assert op._a_t is None          # Aᵀ only for a method that uses it
        torch.testing.assert_close(op.matvec_t(v), torch.from_numpy(a.T) @ v,
                                   rtol=1e-12, atol=1e-12)
        assert (op._a_t is not None) == built
        a_t = op._a_t
        op.matvec_t(v)
        assert op._a_t is a_t           # built once per operator


# --------------------------------------------------------------------------
# errors, builder, interop
# --------------------------------------------------------------------------

def test_sparse_errors_match_reference():
    a, b = _poisson()
    jb, tb = _both_bsr(a, NB)
    je, te = JELL.from_dense(a), ELL.from_dense(a, device="cpu")
    with _x64():
        for method in ("lu", "cholesky"):
            assert _error(lambda: tapi.solve(tb, b, method=method,
                                             device="cpu")) \
                == _error(lambda: japi.solve(jb, jnp.asarray(b),
                                             method=method))
        assert _error(lambda: tapi.factorize(tb)) \
            == _error(lambda: japi.factorize(jb))
        kind, msg = _error(lambda: tapi.solve(te, b, method="cg",
                                              backend="cuda", device="cpu"))
        assert (kind, msg.replace("'cuda'", "'pallas'")) == _error(
            lambda: japi.solve(je, jnp.asarray(b), method="cg",
                               backend="pallas"))
        want = _error(lambda: joperator.make_operator(jb, mesh=object()))
        got = _error(lambda: toperator.make_operator(tb, mesh=object()))
        assert got[0] == want[0] and got[1].startswith(
            want[1].replace("repro.sparse", "sparse"))
        assert "not" in got[1] and "spmd" in got[1]
        bad = tb.data.clone()
        bad[0, 0, 0] = float("nan")
        jbad = JBSR(jnp.asarray(bad.numpy()), jb.indices, jb.indptr,
                    jb.shape, jb.nb)
        tbad = BSR(bad, tb.indices, tb.indptr, tb.shape, tb.nb, device="cpu")
        assert _error(lambda: tapi.solve(tbad, b, method="cg",
                                         device="cpu")) \
            == _error(lambda: japi.solve(jbad, jnp.asarray(b), method="cg"))


@pytest.mark.parametrize("nx,nb", [(8, 4), (6, 3), (4, 4), (16, 8)])
def test_poisson_3d_bsr_matches_from_dense(nx, nb):
    """The smoke's O(nnz) builder gives the BSR of ``from_dense`` exactly,
    in the port and in the reference."""
    dense = problems.poisson_3d(nx)
    np.testing.assert_array_equal(dense, jproblems.poisson_3d(nx))
    got = problems.poisson_3d_bsr(nx, nb, device="cpu")
    for want in (BSR.from_dense(dense, block_size=nb, device="cpu"),
                 JBSR.from_dense(dense, block_size=nb)):
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.data.dtype == torch.float32
    with pytest.raises(ValueError, match="must divide"):
        problems.poisson_3d_bsr(10, 4, device="cpu")


@pytest.mark.parametrize("make", ["poisson_2d", "poisson_3d", "banded",
                                  "random_spd_sparse", "smooth_rhs"])
def test_problem_generators_are_the_reference_copies(make):
    arg = {"poisson_3d": 4, "poisson_2d": 6}.get(make, 40)
    np.testing.assert_array_equal(getattr(problems, make)(arg),
                                  getattr(jproblems, make)(arg))


def test_interop_carries_a_reference_bsr_and_ell():
    a, b = _nonsym_sparse()
    with _x64():
        jb = JBSR.from_dense(a, block_size=NB)
        je = JELL.from_dense(a)
        want_b = np.asarray(jb.matvec(jnp.asarray(b)))
        want_e = np.asarray(je.matvec(jnp.asarray(b)))
    tb = interop.bsr_from_numpy(np.asarray(jb.data), jb.indices, jb.indptr,
                                jb.shape, jb.nb, device="cpu")
    te = interop.ell_from_numpy(np.asarray(je.data), je.cols, je.valid,
                                je.shape, device="cpu")
    np.testing.assert_allclose(tb.matvec(torch.from_numpy(b)).numpy(),
                               want_b, **TOL64)
    np.testing.assert_allclose(te.matvec(torch.from_numpy(b)).numpy(),
                               want_e, **TOL64)
    np.testing.assert_array_equal(tb.to_dense().numpy(), a)
    np.testing.assert_array_equal(te.to_dense().numpy(), a)
