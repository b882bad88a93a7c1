"""The port's s-step Krylov path against :mod:`repro` on the CPU.

Same numpy inputs through both packages (JAX with ``jax_enable_x64``, as in
``tests/test_ca_krylov.py``):

* the plain Gram matrix against the reference's Pallas ``fused_gram_auto``
  in interpret mode, rtol = atol = 1e-5 (that test file's tolerance);
* ``block_dots`` on the base, dense and sparse engines, both backends,
  within 1e-12 in float64, and the dispatch: only float32 on
  ``backend="cuda"`` reaches ``ops.fused_gram``;
* float64 solves: x within 1e-10 (relative, 2-norm), the same
  ``iterations`` and the same ``fail_code`` / ``fail_iter`` /
  ``fail_reason``;
* float32 solves: ``iterations`` within max(1.2×, +2), the same
  ``fail_reason``, true residuals within 10× of each other;
* the breakdown fallback on a Hilbert matrix, the reference's errors, and
  the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import krylov as jkrylov
from repro.core import operator as joperator
from repro.kernels import krylov_fused as jkrylov_fused
from repro.sparse import BSR as JBSR, ELL as JELL
from repro.sparse import problems as jproblems
from repro_torch.core import api as tapi
from repro_torch.core import krylov as tkrylov
from repro_torch.core import operator as toperator
from repro_torch.kernels import krylov_fused, ops, ref
from repro_torch.launch import solve as cli
from repro_torch.sparse import BSR, ELL
from repro_torch.sparse.operator import SparseOperator

TOL32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return ((a @ a.T / n + 4.0 * np.eye(n)).astype(dtype),
            rng.standard_normal(n).astype(dtype))


def _nonsym(n, dtype=np.float64, seed=1):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype),
            rng.standard_normal(n).astype(dtype))


def _hilbert(n):
    i = np.arange(n)
    return 1.0 / (i[:, None] + i[None, :] + 1)


def _rel(x, want):
    x, want = np.asarray(x, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(x - want) / np.linalg.norm(want)


def _true_residual(a, b, x):
    """‖b − Ax‖/‖b‖ in float64 for a dense numpy ``a``."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    return np.linalg.norm(b64 - a64 @ np.asarray(x, np.float64)) \
        / np.linalg.norm(b64)


def _same_info(got, want):
    assert got.info["fail_reason"] == want.info["fail_reason"]
    assert int(got.info["fail_code"]) == int(want.info["fail_code"])
    assert int(got.info["fail_iter"]) == int(want.info["fail_iter"])


# --------------------------------------------------------------------------
# kernel 3's plain version, its wrapper and block_dots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(9, 300), (1, 1), (5, 4096), (17, 257)])
def test_plain_gram_matches_pallas(k, n):
    v = np.random.default_rng(k * 1000 + n).standard_normal((k, n)) \
        .astype(np.float32)
    want = jkrylov_fused.fused_gram_auto(jnp.asarray(v), interpret=True)
    got = ref.fused_gram(torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == (k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    np.testing.assert_allclose(got.numpy(), v @ v.T, **TOL32)


def test_gram_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    v = torch.from_numpy(np.random.default_rng(3).standard_normal((7, 130))
                         .astype(np.float32))
    krylov_fused.reset_launches()
    want = ref.fused_gram(v)
    assert torch.equal(krylov_fused.fused_gram(v), want)
    assert torch.equal(ops.fused_gram(v), want)
    assert krylov_fused.LAUNCHES["fused_gram"] == 0
    # float64 input: float32 accumulation, returned in float64, as the
    # reference's fused_gram_auto returns it
    g64 = ref.fused_gram(v.double())
    assert g64.dtype == torch.float64
    assert torch.equal(g64, want.double())


@pytest.mark.parametrize("bad,err", [
    (lambda v: v.double(), TypeError),
    (lambda v: v.numpy(), TypeError),
    (lambda v: v[0], ValueError),
    (lambda v: v[:, :0], ValueError),
    (lambda v: v.T, ValueError),
    (lambda v: v[:, ::2], ValueError),
])
def test_gram_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    v = torch.ones(5, 64)
    with pytest.raises(err):
        krylov_fused.fused_gram(bad(v))


def test_block_dots_agree_on_every_engine():
    rng = np.random.default_rng(6)
    vs = rng.standard_normal((5, 64))
    want = np.asarray(jnp.asarray(vs) @ jnp.asarray(vs).T)
    tv = torch.from_numpy(vs)
    bsr = BSR.from_dense(np.eye(64), block_size=16, device="cpu")
    engines = [toperator.LinearOperator(),
               toperator.DenseOperator(torch.eye(64, dtype=torch.float64)),
               toperator.DenseOperator(torch.eye(64, dtype=torch.float64),
                                       backend="cuda"),
               SparseOperator(bsr), SparseOperator(bsr, backend="cuda")]
    for op in engines:
        np.testing.assert_allclose(op.block_dots(tv).numpy(), want,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["dense", "bsr"])
def test_only_float32_on_the_cuda_backend_takes_the_gram_kernel(
        monkeypatch, kind):
    calls = []
    real = ops.fused_gram

    def spy(v):
        calls.append(v.shape)
        return real(v)

    monkeypatch.setattr(ops, "fused_gram", spy)
    for dtype, backend, used in ((np.float32, "cuda", True),
                                 (np.float64, "cuda", False),
                                 (np.float32, "ref", False)):
        a, b = _spd(96, dtype)
        if kind == "bsr":
            a = BSR.from_dense(a, block_size=16, device="cpu")
        calls.clear()
        for method in ("ca_cg", "ca_gmres"):
            tapi.solve(a, b, method=method, s=4, backend=backend,
                       device="cpu")
        assert bool(calls) == used, (dtype, backend, calls)
        if used:
            assert set(calls) == {(9, 96), (5, 96)}   # (2s+1, n), (s+1, n)


# --------------------------------------------------------------------------
# parity with the reference
# --------------------------------------------------------------------------

_CASES = {
    "ca_cg dense": lambda: _spd(192),
    "ca_gmres dense": lambda: _nonsym(160),
}


def _poisson_2d():
    a = jproblems.poisson_2d(12, dtype=np.float64)           # n = 144
    return a, jproblems.smooth_rhs(a.shape[0], dtype=np.float64)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("method,s", [("ca_cg", 1), ("ca_cg", 2),
                                      ("ca_cg", 4), ("ca_gmres", 2),
                                      ("ca_gmres", 4)])
def test_float64_dense_matches_reference(method, s, backend):
    a, b = _CASES[f"{method} dense"]()
    kw = dict(method=method, s=s, tol=1e-10,
              maxiter=600 if method == "ca_cg" else 400, return_info=True)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), **kw)
    got = tapi.solve(a, b, backend=backend, device="cpu", **kw)
    assert got.iterations == int(want.iterations)
    _same_info(got, want)
    assert bool(got.converged) and bool(want.converged)
    assert _rel(got.x, want.x) < 1e-10
    assert _rel(got.x, np.linalg.solve(a, b)) < 1e-8


@pytest.mark.parametrize("fmt,backend", [("bsr", "ref"), ("bsr", "cuda"),
                                         ("ell", "ref")])
def test_float64_poisson_ca_cg_matches_reference(fmt, backend):
    a, b = _poisson_2d()
    if fmt == "bsr":
        ja = JBSR.from_dense(a, block_size=16)
        ta = BSR.from_dense(a, block_size=16, device="cpu")
    else:
        ja, ta = JELL.from_dense(a), ELL.from_dense(a, device="cpu")
    kw = dict(method="ca_cg", s=4, tol=1e-10, maxiter=2000, return_info=True)
    want = japi.solve(ja, jnp.asarray(b), **kw)
    got = tapi.solve(ta, b, backend=backend, device="cpu", **kw)
    assert got.iterations == int(want.iterations)
    _same_info(got, want)
    assert _rel(got.x, want.x) < 1e-10
    assert _rel(got.x, np.linalg.solve(a, b)) < 1e-8


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("jbackend", ["ref", "pallas"])
def test_float32_dense_ca_cg_matches_reference(jbackend, backend):
    """float32 s-step CG at s = 4 (the reference's ``pallas`` backend runs
    its Gram kernel in interpret mode)."""
    a, b = _spd(512, np.float32)
    kw = dict(method="ca_cg", s=4, tol=1e-6, maxiter=600, return_info=True)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), backend=jbackend, **kw)
    got = tapi.solve(a, b, backend=backend, device="cpu", **kw)
    it, ref_it = got.iterations, int(want.iterations)
    assert it <= max(1.2 * ref_it, ref_it + 2)
    assert ref_it <= max(1.2 * it, it + 2)
    assert got.info["fail_reason"] == want.info["fail_reason"] == "ok"
    assert bool(got.converged) and bool(want.converged)
    res = [_true_residual(a, b, x) for x in (got.x.numpy(), want.x)]
    assert max(res) <= 10 * min(res)
    assert max(res) < 1e-4


def _poisson_16():
    a = jproblems.poisson_3d(16).astype(np.float32)
    b = np.random.default_rng(0).standard_normal(a.shape[0]) \
        .astype(np.float32)
    return (a, b, JBSR.from_dense(a, block_size=32),
            BSR.from_dense(a, block_size=32, device="cpu"))


@pytest.mark.parametrize("maxiter", [1, 2, 3])
def test_float32_ca_gmres_s8_poisson_agrees_before_the_references_nan(
        maxiter):
    """float32 CA-GMRES at s = 8 on the 16³ Poisson BSR (nb = 32, Gaussian
    b), cut off after 1–3 cycles: both packages are healthy, run the same
    cycles and reduce the true residual alike (within 2.5×).  The
    reference fails with ``non_finite`` at cycle 4 (next test)."""
    a, b, ja, ta = _poisson_16()
    kw = dict(method="ca_gmres", s=8, maxiter=maxiter, return_info=True)
    want = japi.solve(ja, jnp.asarray(b), **kw)
    for backend in ("ref", "cuda"):
        got = tapi.solve(ta, b, backend=backend, device="cpu", **kw)
        assert got.iterations == int(want.iterations) == maxiter
        _same_info(got, want)
        res = [_true_residual(a, b, x) for x in (got.x.numpy(), want.x)]
        assert max(res) <= 2.5 * min(res) and max(res) < 0.1


def test_float32_ca_gmres_s8_poisson_where_the_reference_fails_non_finite():
    """The reference's ``non_finite`` stop here cannot be matched, for
    rounding reasons (ROADMAP §3).  In float32 at s = 8 the monomial basis
    is at the rounding floor: the accepted Cholesky pivots of the scaled
    Gram matrix come down to a few times sqrt(eps).
    The shrink-s probe factors the leading block and the CholeskyQR step
    factors the masked block again; at the floor the two factorizations,
    rounded differently, can disagree.  At cycle 4 the reference's probe
    accepts all nine columns and its factor of the same 9 × 9 block is
    NaN (the same array factored eagerly with ``jnp.linalg.cholesky`` is
    NaN too, factored inside ``jit`` it is not).  The port's probe and
    factor agree through every cycle (where they disagree, it stops as the
    reference does: the next test); its fifth cycle fails to improve the
    least-squares residual and it stops on stagnation.  Which cycle ends
    the run is decided by rounding.  Held: both runs fail, one cycle
    apart, with finite iterates whose true residuals agree within 2×."""
    a, b, ja, ta = _poisson_16()
    kw = dict(method="ca_gmres", s=8, maxiter=100, return_info=True)
    want = japi.solve(ja, jnp.asarray(b), **kw)
    assert want.info["fail_reason"] == "non_finite"
    assert int(want.info["fail_iter"]) == int(want.iterations) == 4
    want_res = _true_residual(a, b, want.x)
    for backend in ("ref", "cuda"):
        got = tapi.solve(ta, b, backend=backend, device="cpu", **kw)
        assert not bool(got.converged) and not bool(want.converged)
        assert int(got.info["fail_code"]) != 0
        assert abs(got.iterations - int(want.iterations)) <= 1
        assert torch.isfinite(got.x).all()
        res = _true_residual(a, b, got.x.numpy())
        assert max(res, want_res) <= 2 * min(res, want_res)


def test_float32_ca_gmres_s8_non_finite_like_the_reference_on_a_bsr():
    """Where the port's own rounding puts a Cholesky pivot at the floor, it
    stops as the reference does: float32 CA-GMRES at s = 8 on a BSR (nb =
    16) of the n = 96 SPD system.  The shrink-s probe accepts a leading
    block whose last pivot is just above sqrt(eps), the factor of the
    masked 9 × 9 block, rounded otherwise, fails, and the cycle's
    residual is NaN: both packages report ``non_finite`` at cycle 1 with
    the same carried residual ‖b‖."""
    a, b = _spd(96, np.float32)
    kw = dict(method="ca_gmres", s=8, maxiter=100, return_info=True)
    want = japi.solve(JBSR.from_dense(a, block_size=16), jnp.asarray(b),
                      **kw)
    got = tapi.solve(BSR.from_dense(a, block_size=16, device="cpu"), b,
                     device="cpu", **kw)
    assert want.info["fail_reason"] == "non_finite"
    assert got.iterations == int(want.iterations) == 1
    _same_info(got, want)
    np.testing.assert_allclose(float(got.residual), float(want.residual),
                               rtol=1e-6)


@pytest.mark.parametrize("method,s,maxiter", [("ca_cg", 4, 200),
                                              ("ca_gmres", 8, 50)])
def test_breakdown_fallback_stays_finite_like_the_reference(method, s,
                                                            maxiter):
    """Hilbert(64) + 1e-10·I: the monomial basis loses rank at once, and
    the shrink-s fallback must keep x and the residual finite, as the
    reference's own test asks.  Past that, the run is decided by rounding
    (cond ≈ 1e10, and the monomial basis far worse), and the two packages
    stop at different steps for different reasons, so only finiteness is
    common ground."""
    a = _hilbert(64) + 1e-10 * np.eye(64)
    b = np.ones(64)
    want = getattr(jkrylov, method)(joperator.DenseOperator(jnp.asarray(a)),
                                    jnp.asarray(b), tol=1e-12,
                                    maxiter=maxiter, s=s)
    got = getattr(tkrylov, method)(
        toperator.DenseOperator(torch.from_numpy(a)), torch.from_numpy(b),
        tol=1e-12, maxiter=maxiter, s=s)
    assert torch.isfinite(got.x).all() and torch.isfinite(got.residual)
    assert np.all(np.isfinite(np.asarray(want.x)))
    assert np.isfinite(float(want.residual))


# --------------------------------------------------------------------------
# errors and the CLI
# --------------------------------------------------------------------------

def _same_error(jax_call, torch_call, exc):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        torch_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("method", ["ca_cg", "ca_gmres"])
def test_errors_match_reference(method):
    a, b = _spd(64)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    msg = _same_error(
        lambda: japi.solve(ja, jb, method=method, precond="jacobi"),
        lambda: tapi.solve(a, b, method=method, precond="jacobi",
                           device="cpu"), ValueError)
    assert "precondition" in msg
    msg = _same_error(lambda: japi.solve(ja, jb, method=method, s=0),
                      lambda: tapi.solve(a, b, method=method, s=0,
                                         device="cpu"), ValueError)
    assert "s >= 1" in msg
    _same_error(lambda: japi.solve(ja, jb, method=method, t=2),
                lambda: tapi.solve(a, b, method=method, t=2, device="cpu"),
                TypeError)


def test_s_step_methods_are_registered_like_the_reference():
    for name in ("ca_cg", "ca_gmres"):
        got, want = tapi.get_method(name), japi.get_method(name)
        assert (got.kind, got.requires, got.extra) \
            == (want.kind, want.requires, want.extra) \
            == ("iterative", ("gram",), ("s",))
    assert {"ca_cg", "ca_gmres"} <= set(tapi.ITERATIVE)


@pytest.mark.parametrize("method", ["ca_cg", "ca_gmres"])
def test_cli_runs_on_the_cpu(method, capsys):
    assert cli.main(["--n", "128", "--method", method, "--s", "4",
                     "--backend", "cuda", "--device", "cpu"]) == 0
    assert f"method={method}" in capsys.readouterr().out


def test_cli_draws_the_spd_system_for_ca_cg():
    a, _ = cli.make_system(32, spd="ca_cg" in cli.SPD_METHODS, device="cpu")
    assert torch.equal(a, a.T)
    assert "ca_gmres" not in cli.SPD_METHODS
