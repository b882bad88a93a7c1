"""The port's iterative solve path against :func:`repro.core.api.solve`.

Same numpy inputs through both packages, on the CPU: five methods × three
preconditioner settings × both port backends (``"cuda"`` on CPU tensors
takes the kernels' plain versions) × float32/float64.

* float64: same iteration count, x within 1e-10 (absolute).
* float32: iteration count within the reference's regression band
  max(1.2×, +2) (``benchmarks/check_regression.check_iteration_counts``),
  x within 1e-4 relative (2-norm).
* The ``fail_code`` / ``fail_iter`` / ``fail_reason`` schema is identical,
  and so are the breakdown record on a singular system and the
  ``ValueError`` on non-finite input.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import blocking as jblocking
from repro.core import precond as jprecond
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import blocking as tblocking
from repro_torch.core import precond as tprecond
from repro_torch.kernels import krylov_fused

METHODS = ("cg", "pipelined_cg", "bicg", "bicgstab", "gmres")
PRECONDS = (None, "jacobi", "block_jacobi")
DTYPES = {"float32": np.float32, "float64": np.float64}
N = 64
BLOCK = 16          # four diagonal blocks, so block-Jacobi is not exact
MAXITER = 200


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _spd(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return ((a @ a.T / n + 4.0 * np.eye(n)).astype(dtype),
            rng.standard_normal(n).astype(dtype))


def _nonsym(n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype),
            rng.standard_normal(n).astype(dtype))


def _system(method, precond, dtype, n=N):
    # BiCG applies M to the shadow system where Mᵀ belongs (the reference
    # passes no precond_t), which is right only for a symmetric M: the
    # nonsymmetric block-Jacobi case is test_bicg_nonsymmetric_block_jacobi.
    spd = method in ("cg", "pipelined_cg") or (
        method == "bicg" and precond == "block_jacobi")
    return (_spd if spd else _nonsym)(n, DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _reference(method, precond, dtype, n=N):
    a, b = _system(method, precond, dtype, n)
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        r = japi.solve(jnp.asarray(a), jnp.asarray(b), method=method,
                       precond=precond, block_size=BLOCK, maxiter=MAXITER,
                       return_info=True)
    finally:
        jax.config.update("jax_enable_x64", old)
    return {"x": np.asarray(r.x), "iterations": int(r.iterations),
            "converged": bool(r.converged),
            "info": {k: (v if isinstance(v, str) or v is None else int(v))
                     for k, v in r.info.items()}}


def _port(a, b, **kw):
    r = tapi.solve(a, b, block_size=BLOCK, maxiter=MAXITER, return_info=True,
                   device="cpu", **kw)
    return {"x": r.x.numpy(), "iterations": r.iterations,
            "converged": bool(r.converged),
            "info": {k: (v if isinstance(v, str) or v is None else int(v))
                     for k, v in r.info.items()}}


def _assert_parity(got, want, dtype):
    assert got["info"] == want["info"]
    assert got["converged"] == want["converged"]
    if dtype == "float64":
        assert got["iterations"] == want["iterations"]
        np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-10)
    else:
        ref_it = want["iterations"]
        assert got["iterations"] <= max(1.2 * ref_it, ref_it + 2)
        assert ref_it <= max(1.2 * got["iterations"], got["iterations"] + 2)
        err = np.linalg.norm(got["x"] - want["x"])
        assert err <= 1e-4 * np.linalg.norm(want["x"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_reference(method, precond, backend, dtype):
    a, b = _system(method, precond, dtype)
    want = _reference(method, precond, dtype)
    got = _port(a, b, method=method, precond=precond, backend=backend)
    assert want["converged"]
    assert set(got["info"]) == {"fail_code", "fail_iter", "fail_reason"}
    _assert_parity(got, want, dtype)


@pytest.mark.parametrize("precond", ["jacobi", "block_jacobi"])
@pytest.mark.parametrize("method", METHODS)
def test_reference_preconditioner_state_carries_across(method, precond):
    """The reference's preconditioner arrays, carried across with interop,
    give the port the same M⁻¹ and the same float64 solve."""
    a, b = _system(method, precond, "float64")
    pc_j = jprecond.make(precond, jnp.asarray(a), BLOCK)
    pc_t = interop.precond_from_numpy(
        pc_j.kind, tuple(np.asarray(d) for d in pc_j.data), device="cpu")
    at, bt, _ = interop.system_from_numpy(a, b, device="cpu")
    got = _port(at, bt, method=method, precond=pc_t, backend="cuda")
    _assert_parity(got, _reference(method, precond, "float64"), "float64")


def test_block_jacobi_pivots_are_shifted_to_one_based():
    a, _ = _nonsym(130, np.float64)          # 130 = pad to 9 blocks of 16
    v = np.random.default_rng(5).standard_normal(130)
    pc_j = jprecond.make("block_jacobi", jnp.asarray(a), BLOCK)
    lu, piv = (np.asarray(d) for d in pc_j.data)
    assert piv.min() == 0                    # JAX: 0-based pivots
    pc_t = interop.precond_from_numpy("block_jacobi", (lu, piv),
                                      device="cpu")
    assert int(pc_t.data[1].min()) == 1      # LAPACK: 1-based pivots
    want = np.asarray(pc_j.apply(jnp.asarray(v)))
    got = pc_t.apply(torch.from_numpy(v)).numpy()
    own = tprecond.make("block_jacobi", torch.from_numpy(a), BLOCK)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(own.apply(torch.from_numpy(v)).numpy(), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_padded_block_jacobi_matches_reference(method):
    """n = 130 is no multiple of the block: the identity-pad policy."""
    a, b = (_spd if method == "cg" else _nonsym)(130, np.float64)
    kw = dict(method=method, precond="block_jacobi", block_size=BLOCK,
              maxiter=MAXITER)
    r = japi.solve(jnp.asarray(a), jnp.asarray(b), return_info=True, **kw)
    got = tapi.solve(a, b, backend="cuda", device="cpu", return_info=True,
                     **kw)
    assert got.iterations == int(r.iterations) and bool(got.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(r.x), rtol=0,
                               atol=1e-10)


def test_bicg_nonsymmetric_block_jacobi():
    """BiCG with a nonsymmetric M stagnates in both packages (M stands in
    for Mᵀ on the shadow system).  Its breakdown test ⟨r̃, z⟩ == 0 then
    hangs on rounding: the jitted reference reads an exact 0 at some step,
    the eager reference and the port do not.  Before that step, the port
    follows the reference's iterates to float64 rounding."""
    a, b = _nonsym(N, np.float64)
    kw = dict(method="bicg", precond="block_jacobi", block_size=BLOCK,
              maxiter=30, return_info=True)
    r = japi.solve(jnp.asarray(a), jnp.asarray(b), **kw)
    got = tapi.solve(a, b, device="cpu", **kw)
    assert int(r.iterations) == got.iterations == 30
    assert not bool(r.converged) and not bool(got.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(r.x), rtol=0,
                               atol=1e-10)


# what the reference's monitor reports on a zero matrix: the CG family and
# BiCGSTAB flag breakdown at once, GMRES stagnates after three cycles, and
# BiCG — whose breakdown test is ⟨r̃, z⟩ = 0, not ⟨p̃, Ap⟩ = 0 — runs out
SINGULAR = {"cg": (1, "breakdown"), "pipelined_cg": (1, "breakdown"),
            "bicgstab": (1, "breakdown"), "gmres": (3, "stagnation"),
            "bicg": (100, "ok")}


@pytest.mark.parametrize("method", METHODS)
def test_singular_system_fails_alike(method):
    a = np.zeros((N, N), np.float32)
    b = np.ones(N, np.float32)
    r = japi.solve(jnp.asarray(a), jnp.asarray(b), method=method,
                   maxiter=100, return_info=True)
    got = tapi.solve(a, b, method=method, backend="cuda", device="cpu",
                     maxiter=100, return_info=True)
    iters, reason = SINGULAR[method]
    assert got.iterations == int(r.iterations) == iters
    assert got.info["fail_reason"] == r.info["fail_reason"] == reason
    assert int(got.info["fail_code"]) == int(r.info["fail_code"])
    assert int(got.info["fail_iter"]) == int(r.info["fail_iter"])
    assert not bool(got.converged) and not bool(r.converged)
    assert torch.isfinite(got.x).all()


@pytest.mark.parametrize("which", ["a", "b"])
def test_non_finite_input_raises_the_same_error(which):
    a, b = _spd(N, np.float32)
    (a if which == "a" else b)[3] = np.nan
    with pytest.raises(ValueError) as want:
        japi.solve(jnp.asarray(a), jnp.asarray(b), method="cg")
    with pytest.raises(ValueError) as got:
        tapi.solve(a, b, method="cg", device="cpu")
    assert str(got.value) == str(want.value)


def test_unported_method_raises_unknown_method():
    """Every method the reference registers is ported, so an unregistered
    name gets the reference's error word for word, with the same list."""
    a, b = _spd(N, np.float32)
    with pytest.raises(ValueError) as got:
        tapi.solve(a, b, method="nope", device="cpu")
    assert str(got.value) == (
        f"unknown method 'nope'; available: "
        f"{sorted(METHODS + ('lu', 'cholesky', 'qr', 'lsqr', 'cgls', 'ca_cg',
                             'ca_gmres'))}")
    with pytest.raises(ValueError) as want:
        japi.solve(jnp.asarray(a), jnp.asarray(b), method="nope")
    assert str(got.value) == str(want.value)


def test_float32_cuda_backend_on_cpu_launches_nothing():
    a, b = _spd(N, np.float32)
    krylov_fused.reset_launches()
    for method in METHODS:
        r = tapi.solve(a, b, method=method, backend="cuda", device="cpu",
                       return_info=True)
        assert bool(r.converged)
    assert krylov_fused.LAUNCHES == {"fused_cg_update": 0,
                                     "fused_pipelined_dots": 0,
                                     "fused_gram": 0}


@pytest.mark.parametrize("n,block", [(64, 16), (130, 16), (7, 128)])
def test_pad_policy_matches_reference(n, block):
    a = np.random.default_rng(n).standard_normal((n, n))
    b = np.random.default_rng(n + 1).standard_normal((n, 2))
    want_a, want_nb, want_n = jblocking.pad_system(jnp.asarray(a), block)
    got_a, got_nb, got_n = tblocking.pad_system(torch.from_numpy(a), block)
    assert (got_nb, got_n) == (want_nb, want_n) \
        == (tblocking.choose_block(n, block),
            tblocking.padded_size(n, tblocking.choose_block(n, block)))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(
        tblocking.pad_rhs(torch.from_numpy(b), got_n).numpy(),
        np.asarray(jblocking.pad_rhs(jnp.asarray(b), want_n)))
    for dtype, name in ((torch.float32, "cuda"), (torch.float64, "ref")):
        assert tblocking.effective_backend("cuda", dtype) == name
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        tblocking.check_backend("pallas")

