"""The port's direct solve path against :mod:`repro`'s (LU, Cholesky,
``factorize``), on the CPU with the same numpy inputs.

* float64: the LU factor (with ``perm`` identical), the Cholesky factor and
  x within 1e-10 of ``repro``'s ``backend="ref"``, on a plain Gaussian
  matrix (which pivots) and on the diagonally dominant ``a + nI``, at
  n = 96 and n = 100 (identity-padded to 128), nb = 32.
* float32 with the port's ``backend="cuda"`` on CPU tensors (the kernels'
  plain versions): the factors within rtol 1e-4 / atol 1e-3 of ``repro``'s
  ``backend="pallas"`` factorizations (Pallas interpret mode), ``perm``
  identical; x within 1e-4 relative (2-norm) of ``repro``'s
  ``backend="ref"`` solve.
* multiple right-hand sides, ``factorize``, the ``return_info`` schema, the
  input errors, and ``apply`` on the reference's own factors carried over
  with :mod:`repro_torch.interop`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import cholesky as jcholesky
from repro.core import lu as jlu
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import cholesky as tcholesky
from repro_torch.core import lu as tlu
from repro_torch.kernels import factor_fused

NB = 32
SIZES = (96, 100)
SYSTEMS = ("gaussian", "dominant")


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _matrix(kind, n, dtype):
    rng = np.random.default_rng(n + len(kind))
    a = rng.standard_normal((n, n))
    if kind == "dominant":
        a = a + n * np.eye(n)
    elif kind == "spd":
        a = a @ a.T / n + 4 * np.eye(n)
        a = (a + a.T) / 2
    return a.astype(dtype)


def _rhs(n, dtype, k=None):
    rng = np.random.default_rng(1000 + n)
    return rng.standard_normal((n,) if k is None else (n, k)).astype(dtype)


def _t(v):
    return torch.from_numpy(np.array(v))


@functools.lru_cache(maxsize=None)
def _jax_pallas_factor(method, kind, n):
    """The reference's float32 factorization with its Pallas kernel
    (interpret mode), computed once per case."""
    a = jnp.asarray(_matrix(kind, n, np.float32))
    if method == "lu":
        lu, perm = jlu.lu_factor(a, block_size=NB, backend="pallas")
        return np.asarray(lu), np.asarray(perm)
    return (np.asarray(jcholesky.cholesky_factor(a, block_size=NB,
                                                 backend="pallas")),)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("kind", SYSTEMS)
@pytest.mark.parametrize("n", SIZES)
def test_float64_lu_matches_reference(n, kind, backend):
    a, b = _matrix(kind, n, np.float64), _rhs(n, np.float64)
    want_lu, want_perm = jlu.lu_factor(jnp.asarray(a), block_size=NB)
    got_lu, got_perm = tlu.lu_factor(_t(a), block_size=NB, backend=backend)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    np.testing.assert_allclose(got_lu.numpy(), np.asarray(want_lu),
                               rtol=0, atol=1e-10)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), block_size=NB)
    got = tapi.solve(a, b, block_size=NB, backend=backend, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("n", SIZES)
def test_float64_cholesky_matches_reference(n, backend):
    a, b = _matrix("spd", n, np.float64), _rhs(n, np.float64)
    want_l = jcholesky.cholesky_factor(jnp.asarray(a), block_size=NB)
    got_l = tcholesky.cholesky_factor(_t(a), block_size=NB, backend=backend)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=1e-10)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="cholesky",
                      block_size=NB)
    got = tapi.solve(a, b, method="cholesky", block_size=NB,
                     backend=backend, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) \
        / np.linalg.norm(want)


@pytest.mark.parametrize("kind,n", [("gaussian", 96), ("gaussian", 100),
                                    ("dominant", 96)])
def test_float32_lu_kernel_route_matches_reference(kind, n):
    a, b = _matrix(kind, n, np.float32), _rhs(n, np.float32)
    want_lu, want_perm = _jax_pallas_factor("lu", kind, n)
    factor_fused.reset_launches()
    got_lu, got_perm = tlu.lu_factor(_t(a), block_size=NB, backend="cuda")
    np.testing.assert_array_equal(got_perm.numpy(), want_perm)
    np.testing.assert_allclose(got_lu.numpy(), want_lu, rtol=1e-4,
                               atol=1e-3)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), block_size=NB)
    got = tapi.solve(a, b, block_size=NB, backend="cuda", device="cpu")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4
    assert factor_fused.LAUNCHES["lu_panel_update"] == 0   # plain versions


@pytest.mark.parametrize("n", SIZES)
def test_float32_cholesky_kernel_route_matches_reference(n):
    a, b = _matrix("spd", n, np.float32), _rhs(n, np.float32)
    (want_l,) = _jax_pallas_factor("cholesky", "spd", n)
    got_l = tcholesky.cholesky_factor(_t(a), block_size=NB, backend="cuda")
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-4, atol=1e-3)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="cholesky",
                      block_size=NB)
    got = tapi.solve(a, b, method="cholesky", block_size=NB,
                     backend="cuda", device="cpu")
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("factor", [tlu.lu_factor,
                                    tcholesky.cholesky_factor])
def test_unfused_route_on_cpu_is_the_plain_route(factor):
    """fuse_panel=False composes the triangular-solve and tiled GEMM
    kernels on the card (kernels 6 and 7); on CPU tensors their plain
    versions give the plain route's factor, bit for bit."""
    a = _t(_matrix("spd", 100, np.float32))
    got = factor(a, block_size=NB, backend="cuda", fuse_panel=False)
    want = factor(a, block_size=NB, backend="ref")
    for g, w in zip(*(v if isinstance(v, tuple) else (v,)
                      for v in (got, want))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_multiple_right_hand_sides(method, dtype):
    n = 100
    a = _matrix("spd" if method == "cholesky" else "gaussian", n, dtype)
    b = _rhs(n, dtype, k=3)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method=method,
                      block_size=NB)
    got = tapi.solve(a, b, method=method, block_size=NB, backend="cuda",
                     device="cpu")
    assert got.shape == (n, 3)
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)
    else:
        assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_factorize_matches_reference(method):
    n = 100
    a = _matrix("spd" if method == "cholesky" else "gaussian", n,
                np.float64)
    solve_j = japi.factorize(jnp.asarray(a), method=method, block_size=NB)
    solve_t = tapi.factorize(a, method=method, block_size=NB,
                             backend="cuda", device="cpu")
    for b in (_rhs(n, np.float64), _rhs(n, np.float64, k=2)):
        np.testing.assert_allclose(solve_t(b).numpy(),
                                   np.asarray(solve_j(jnp.asarray(b))),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_apply_on_the_reference_factors(method):
    n = 100
    a = _matrix("spd" if method == "cholesky" else "gaussian", n,
                np.float64)
    b = _rhs(n, np.float64, k=2)
    if method == "lu":
        state_j = jlu.lu_factor(jnp.asarray(a), block_size=NB)
        want = jlu.lu_apply(state_j, jnp.asarray(b), block_size=NB)
        state_t = interop.lu_state_from_numpy(
            *(np.asarray(v) for v in state_j), device="cpu")
        got = tlu.lu_apply(state_t, _t(b), block_size=NB)
    else:
        state_j = jcholesky.cholesky_factor_state(jnp.asarray(a),
                                                  block_size=NB)
        want = jcholesky.cholesky_apply(state_j, jnp.asarray(b),
                                        block_size=NB)
        state_t = interop.cholesky_state_from_numpy(
            np.asarray(state_j[0]), device="cpu")
        got = tcholesky.cholesky_apply(state_t, _t(b), block_size=NB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_return_info_schema_matches_reference(method, k):
    n = 64
    a = _matrix("spd" if method == "cholesky" else "dominant", n,
                np.float64)
    b = _rhs(n, np.float64, k)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method=method,
                      return_info=True)
    got = tapi.solve(a, b, method=method, backend="cuda", return_info=True,
                     device="cpu")
    assert type(got).__name__ == type(want).__name__ == "SolveResult"
    assert got._fields == want._fields
    assert sorted(got.info) == sorted(want.info)
    for key in ("fail_code", "fail_iter"):
        assert int(got.info[key]) == int(want.info[key]) == 0
        assert got.info[key].dtype == torch.int32
    assert got.info["fail_reason"] == want.info["fail_reason"] == "ok"
    assert int(got.iterations) == int(want.iterations) == 0
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.residual), float(want.residual),
                               rtol=0, atol=1e-10)


def _same_error(jax_call, torch_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        torch_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("defect", ["diagonal", "asymmetric"])
def test_cholesky_input_errors_match_reference(defect):
    a = _matrix("spd", 32, np.float64)
    if defect == "diagonal":
        a[5, 5] = -1.0
    else:
        a[3, 7] += 1e-3
    b = _rhs(32, np.float64)
    _same_error(lambda: japi.solve(jnp.asarray(a), jnp.asarray(b),
                                   method="cholesky"),
                lambda: tapi.solve(a, b, method="cholesky", device="cpu"))
    _same_error(lambda: japi.factorize(jnp.asarray(a), method="cholesky"),
                lambda: tapi.factorize(a, method="cholesky", device="cpu"))


def _indefinite(where, n, dtype):
    """Symmetric with a positive diagonal, so the input checks pass, but
    not positive definite: the block that fails is the first or the last."""
    a = _matrix("spd", n, np.float64)
    i = 0 if where == "first" else n - 2
    a[i, i + 1] = a[i + 1, i] = 10 * a[i, i]
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("where", ["first", "last"])
def test_cholesky_of_an_indefinite_matrix_matches_reference(where, dtype):
    n = 100
    a, b = _indefinite(where, n, dtype), _rhs(n, dtype)
    want_l = np.asarray(jcholesky.cholesky_factor(jnp.asarray(a),
                                                  block_size=NB))
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="cholesky",
                      block_size=NB, return_info=True)
    assert np.isnan(np.asarray(want.x)).any()
    for backend in ("ref", "cuda"):
        got_l = tcholesky.cholesky_factor(_t(a), block_size=NB,
                                          backend=backend).numpy()
        np.testing.assert_array_equal(np.isnan(got_l), np.isnan(want_l))
        got = tapi.solve(a, b, method="cholesky", block_size=NB,
                         backend=backend, return_info=True, device="cpu")
        np.testing.assert_array_equal(np.isnan(got.x.numpy()),
                                      np.isnan(np.asarray(want.x)))
        assert bool(got.converged) == bool(want.converged)
        assert np.isnan(float(got.residual)) == np.isnan(
            float(want.residual))
        assert got.info["fail_reason"] == want.info["fail_reason"]


def test_x0_error_matches_reference():
    a, b = _matrix("dominant", 32, np.float64), _rhs(32, np.float64)
    _same_error(lambda: japi.solve(jnp.asarray(a), jnp.asarray(b),
                                   x0=jnp.asarray(b)),
                lambda: tapi.solve(a, b, x0=b, device="cpu"))


def test_factorize_rejects_an_iterative_method():
    a = _matrix("spd", 32, np.float64)
    with pytest.raises(ValueError, match="factorize needs a direct method; "
                                         "'cg' is iterative; available: "
                                         r"\('cholesky', 'lu', 'qr'\)"):
        tapi.factorize(a, method="cg", device="cpu")


def test_default_method_is_lu():
    a, b = _matrix("gaussian", 100, np.float64), _rhs(100, np.float64)
    assert torch.equal(tapi.solve(a, b, device="cpu"),
                       tapi.solve(a, b, method="lu", device="cpu"))
    assert tapi.DIRECT == ("cholesky", "lu", "qr")


def test_unported_direct_inputs_raise():
    a = np.stack([_matrix("dominant", 16, np.float64)] * 2)
    b = np.ones((2, 16))
    with pytest.raises(ValueError, match="batched"):
        tapi.solve(a, b, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        tapi.factorize(a, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tapi.factorize(a[0], engine="spmd", device="cpu")
    with pytest.raises(ValueError, match="BOTH factor= and apply="):
        tapi.register_method("half", tlu.solve, kind="direct",
                             factor=tlu.lu_factor)
