"""The port's least-squares path against :mod:`repro`'s, on the CPU with the
same numpy inputs: ``pad_rect``, the blocked Householder QR (factor, apply,
solve, ``reduced``, ``factorize``), LSQR / CGLS, the non-square audit of
``solve``, the CLI's ``--m``, and the plain versions of the QR trailing
update and the tiled GEMM.

* float64: the packed QR, τs and T matrices within 1e-10 of the reference's
  on both trailing-update routes; x within 1e-10.
* float32 with the port's ``backend="cuda"`` on CPU tensors (the kernels'
  plain versions): the packed QR within rtol 1e-3 / atol 1e-4 of the
  reference's ``backend="pallas"`` factorization (its kernels in interpret
  mode), the tolerance of ``tests/test_eigls.py`` for the same comparison;
  x within 1e-4 relative of the reference's ``backend="ref"`` solve.
* The plain GEMM and QR update against the Pallas kernels in interpret
  mode: rtol 1e-4, atol 1e-4 times the depth of the product (the float32
  GEMM tolerance of ``tests/test_kernels.py``).
* LSQR / CGLS: iteration counts within max(1.2×, +2) of the reference's,
  x within 1e-10 in float64, and the ``SolveResult.info`` schema identical.

The reference's ``backend="pallas"`` QR *solve* is not an oracle here: its
R solve reaches ``kernels/trsm.py``, which this JAX version cannot run.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import blocking as jblocking
from repro.core import qr as jqr
from repro.kernels import gemm as jgemm
from repro.kernels import qr_fused as jqr_fused
from repro.sparse import BSR as JBSR
from repro.sparse import problems as jproblems
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import blocking as tblocking
from repro_torch.core import qr as tqr
from repro_torch.core.operator import DenseOperator
from repro_torch.kernels import gemm, ops, qr_fused, ref
from repro_torch.launch import solve as cli
from repro_torch.sparse import BSR as TBSR

# (m, n, nb): block multiples, and m and n padded (100 x 37 at nb 16 pads
# its rows further to host the unit columns)
SHAPES = [(96, 40, 16), (200, 64, 32), (100, 37, 16), (64, 64, 16)]
IDS = [f"{m}x{n}-nb{nb}" for m, n, nb in SHAPES]


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _rect(m, n, dtype, seed=0):
    rng = np.random.default_rng(seed + m + n)
    return (rng.standard_normal((m, n)).astype(dtype),
            rng.standard_normal(m).astype(dtype))


def _t(v):
    return torch.from_numpy(np.array(v))


def _rel(x, want):
    x, want = np.asarray(x, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(x - want) / np.linalg.norm(want)


def _same_error(jax_call, torch_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        torch_call()
    assert str(got.value) == str(want.value)


@functools.lru_cache(maxsize=None)
def _jax_factor(m, n, nb, dtype, backend, fuse):
    a, _ = _rect(m, n, np.dtype(dtype))
    st = jqr.qr_factor(jnp.asarray(a), block_size=nb, backend=backend,
                       fuse_panel=fuse)
    return np.asarray(st.qr), np.asarray(st.taus), np.asarray(st.tmats)


# --------------------------------------------------------------------------
# pad_rect
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,bs", [(70, 33, 32), (100, 37, 16),
                                    (96, 40, 16), (40, 40, 128),
                                    (65, 64, 16)])
def test_pad_rect_matches_reference(m, n, bs):
    a, _ = _rect(m, n, np.float64)
    want, wnb, wm, wn = jblocking.pad_rect(jnp.asarray(a), bs)
    got, nb, mp, np_ = tblocking.pad_rect(_t(a), bs)
    assert (nb, mp, np_) == (wnb, wm, wn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,bs", [((3, 4, 5), 2), ((6,), 2),
                                      ((33, 70), 32), ((70, 33), 0)])
def test_pad_rect_errors_match_reference(shape, bs):
    a = np.zeros(shape)
    _same_error(lambda: jblocking.pad_rect(jnp.asarray(a), bs),
                lambda: tblocking.pad_rect(_t(a), bs))


# --------------------------------------------------------------------------
# QR factorization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("m,n,nb", SHAPES, ids=IDS)
def test_qr_factor_float64_matches_reference(m, n, nb, backend, fuse):
    want = _jax_factor(m, n, nb, "float64", "ref", True)
    a, _ = _rect(m, n, np.float64)
    st = tqr.qr_factor(_t(a), block_size=nb, backend=backend,
                       fuse_panel=fuse)
    for got, w in zip((st.qr, st.taus, st.tmats), want):
        assert got.shape == w.shape
        assert np.abs(got.numpy() - w).max() <= 1e-10
    assert st.nb == nb


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("m,n,nb", SHAPES, ids=IDS)
def test_qr_factor_float32_kernel_route_matches_pallas(m, n, nb, fuse):
    """The port's kernel routes (here the plain versions of kernels 9 and
    7) against the reference's Pallas routes in interpret mode, and both
    against the plain float32 factorization."""
    want_qr, _, want_t = _jax_factor(m, n, nb, "float32", "pallas", fuse)
    a, _ = _rect(m, n, np.float32)
    st = tqr.qr_factor(_t(a), block_size=nb, backend="cuda",
                       fuse_panel=fuse)
    np.testing.assert_allclose(st.qr.numpy(), want_qr, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(st.tmats.numpy(), want_t, rtol=1e-3,
                               atol=1e-4)
    plain = tqr.qr_factor(_t(a), block_size=nb, backend="ref")
    np.testing.assert_allclose(st.qr.numpy(), plain.qr.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_qr_factor_leaves_the_input_alone_and_zero_columns_give_tau_zero():
    a, _ = _rect(96, 40, np.float64)
    a[:, 5] = 0.0                        # a zero column: H = I, τ = 0
    a[:, 21] = 0.0
    at = _t(a)
    st = tqr.qr_factor(at, block_size=16)
    np.testing.assert_array_equal(at.numpy(), a)
    want = jqr.qr_factor(jnp.asarray(a), block_size=16)
    assert float(st.taus[5]) == 0.0 and float(want.taus[5]) == 0.0
    assert np.abs(st.qr.numpy() - np.asarray(want.qr)).max() <= 1e-10
    assert np.abs(st.tmats.numpy() - np.asarray(want.tmats)).max() <= 1e-10


def test_qr_factor_mesh_and_backend_errors():
    a = torch.zeros(8, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="single-device"):
        tqr.qr_factor(a, mesh=object())
    with pytest.raises(ValueError, match="unknown backend"):
        tqr.qr_factor(a, backend="pallas")


@pytest.mark.parametrize("m,n,nb", SHAPES, ids=IDS)
def test_reduced_matches_reference(m, n, nb):
    a, _ = _rect(m, n, np.float64)
    wq, wr = jqr.reduced(jnp.asarray(a), block_size=nb)
    q, r = tqr.reduced(_t(a), block_size=nb)
    assert np.abs(q.numpy() - np.asarray(wq)).max() <= 1e-10
    assert np.abs(r.numpy() - np.asarray(wr)).max() <= 1e-10
    assert np.abs(q.numpy() @ r.numpy() - a).max() <= 1e-10


# --------------------------------------------------------------------------
# QR solve, apply and factorize
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("m,n,nb", SHAPES, ids=IDS)
def test_qr_solve_float64_matches_reference(m, n, nb, backend):
    a, b = _rect(m, n, np.float64)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="qr",
                      block_size=nb)
    got = tapi.solve(a, b, method="qr", block_size=nb, backend=backend,
                     device="cpu")
    assert got.shape == (n,)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-10
    xo = np.linalg.lstsq(a, b, rcond=None)[0]
    assert np.abs(got.numpy() - xo).max() <= 1e-10


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("m,n,nb", SHAPES, ids=IDS)
def test_qr_solve_float32_kernel_route_matches_reference(m, n, nb, fuse):
    a, b = _rect(m, n, np.float32)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="qr",
                      block_size=nb)
    st = dataclasses.replace(
        tqr.qr_factor(_t(a), block_size=nb, backend="cuda", fuse_panel=fuse),
        m0=m, n0=n)
    got = tqr.qr_apply(st, _t(b), block_size=nb, backend="cuda")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qr_multiple_right_hand_sides_and_factorize(dtype):
    m, n, nb = 100, 37, 16
    a, _ = _rect(m, n, dtype)
    bm = np.random.default_rng(5).standard_normal((m, 3)).astype(dtype)
    want = japi.solve(jnp.asarray(a), jnp.asarray(bm), method="qr",
                      block_size=nb)
    got = tapi.solve(a, bm, method="qr", block_size=nb, backend="cuda",
                     device="cpu")
    solver = tapi.factorize(a, method="qr", block_size=nb, backend="cuda",
                            device="cpu")
    again = solver(bm)
    jsolver = japi.factorize(jnp.asarray(a), method="qr", block_size=nb)
    assert got.shape == again.shape == (n, 3)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    for x in (got, again):
        if dtype == np.float64:
            assert np.abs(x.numpy() - np.asarray(want)).max() <= tol
        else:
            assert _rel(x.numpy(), want) <= tol
    np.testing.assert_allclose(again.numpy(),
                               np.asarray(jsolver(jnp.asarray(bm))),
                               rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("m,n,nb", SHAPES, ids=IDS)
def test_qr_apply_on_the_reference_factor(m, n, nb):
    """The reference's factor carried over with interop, applied by the
    port: the same x as the reference's own apply."""
    a, b = _rect(m, n, np.float64)
    st = jqr.qr_factor_state(jnp.asarray(a), block_size=nb)
    want = jqr.qr_apply(st, jnp.asarray(b))
    tst = interop.qr_state_from_numpy(np.asarray(st.qr), np.asarray(st.taus),
                                      np.asarray(st.tmats), st.m0, st.n0,
                                      st.nb, device="cpu")
    got = tqr.qr_apply(tst, _t(b))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-10
    # Qᵀ and Q through both packages
    y = _t(np.random.default_rng(1).standard_normal(st.qr.shape[0]))
    np.testing.assert_allclose(
        tqr.apply_qt(tst, y).numpy(),
        np.asarray(jqr.apply_qt(st, jnp.asarray(y.numpy()))), rtol=0,
        atol=1e-10)
    np.testing.assert_allclose(
        tqr.apply_q(tst, y).numpy(),
        np.asarray(jqr.apply_q(st, jnp.asarray(y.numpy()))), rtol=0,
        atol=1e-10)


def test_qr_apply_rejects_a_rhs_of_other_rows_as_the_reference_does():
    a, b = _rect(96, 40, np.float64)
    jst = jqr.qr_factor_state(jnp.asarray(a), block_size=16)
    tst = tqr.qr_factor_state(_t(a), block_size=16)
    _same_error(lambda: jqr.qr_apply(jst, jnp.asarray(b[:90])),
                lambda: tqr.qr_apply(tst, _t(b[:90])))


# --------------------------------------------------------------------------
# Plain versions of the kernels against the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 64),
                                   (96, 40, 16), (16, 40, 96)])
def test_plain_matmul_matches_pallas(m, n, k):
    rng = np.random.default_rng(m + 2 * n + 3 * k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    bm, bn, bk = (min(128, m), min(128, n), min(32, k))
    want = np.asarray(jgemm.matmul(jnp.asarray(a), jnp.asarray(b), bm=bm,
                                   bn=bn, bk=bk, interpret=True))
    for got in (ref.matmul(_t(a), _t(b)), ops.matmul(_t(a), _t(b))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * k)


def test_matmul_wrapper_takes_any_shape_and_strided_views_on_cpu():
    rng = np.random.default_rng(3)
    big = _t(rng.standard_normal((70, 90)).astype(np.float32))
    before = gemm.LAUNCHES["matmul"]
    for a, b in ((big[:13, :7], big[20:27, 5:50]),     # ragged, strided
                 (big[:33, :].T, big[:33, 60:61]),      # a transposed view
                 (big[:5, :3], big[:3, :0]),            # an empty N
                 (big[:4, :0], big[:0, :6])):           # an empty K
        got = gemm.matmul(a, b)
        assert got.shape == (a.shape[0], b.shape[1])
        np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), rtol=1e-6,
                                   atol=1e-5)
    assert gemm.LAUNCHES["matmul"] == before     # the CPU launches nothing


@pytest.mark.parametrize("a,b,err", [
    (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(3, 2), TypeError),
    (torch.zeros(4, 3), torch.zeros(3, 2, dtype=torch.float16), TypeError),
    (torch.zeros(4, 3), torch.zeros(2, 2), ValueError),
    (torch.zeros(4), torch.zeros(4, 2), ValueError),
    ([[1.0]], torch.zeros(1, 1), TypeError),
])
def test_matmul_wrapper_rejects_what_the_kernel_does_not_take(a, b, err):
    with pytest.raises(err):
        gemm.matmul(a, b)


@pytest.mark.parametrize("k", [0, 16, 32, 48])
def test_plain_qr_panel_update_matches_pallas(k):
    """At each step offset k, with V zero above row k (as the factorization
    builds it): the Pallas kernel takes the full (m, nb) V, the port its
    active rows [k, m); the columns left of k + nb pass through
    unchanged."""
    m, n, nb = 96, 64, 16
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, n)).astype(np.float32)
    v = rng.standard_normal((m, nb)).astype(np.float32)
    v[:k] = 0.0
    t = np.triu(rng.standard_normal((nb, nb))).astype(np.float32) / nb
    want = np.asarray(jqr_fused.qr_panel_update(
        jnp.asarray(a), jnp.asarray(v), jnp.asarray(t), k, nb=nb,
        interpret=True))
    for fn in (ref.qr_panel_update, ops.qr_panel_update,
               qr_fused.qr_panel_update):
        at = _t(a)
        got = fn(at, _t(v[k:]), _t(t), k, nb=nb)
        assert got is at                                  # in place
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * (m - k))
        np.testing.assert_array_equal(got.numpy()[:, :k + nb],
                                      a[:, :k + nb])


def test_qr_panel_update_wrapper_rejects_what_the_kernel_does_not_take():
    m, n, nb = 64, 32, 16
    a, v, t = torch.zeros(m, n), torch.zeros(m, nb), torch.zeros(nb, nb)
    before = qr_fused.LAUNCHES["qr_panel_update"]
    for args, err in (((a.double(), v, t, 0), TypeError),
                      ((a, v.double(), t, 0), TypeError),
                      ((a.T.contiguous().T, v, t, 0), ValueError),
                      ((torch.zeros(16, 32), v, t, 0), ValueError),
                      ((a, v[:, :8], t, 0), ValueError),
                      ((a, v, t[:8], 0), ValueError),
                      ((a, v, t, 32), ValueError),
                      ((a, v, t, -16), ValueError),
                      ((a, v, t, 16), ValueError)):   # v not v[16:]
        with pytest.raises(err):
            qr_fused.qr_panel_update(*args, nb=nb)
    with pytest.raises(ValueError, match="not tiled"):
        qr_fused.qr_panel_update(torch.zeros(64, 40), v, t, 0, nb=nb)
    assert qr_fused.qr_panel_update(a, v[n - nb:], t, n - nb, nb=nb) is a
    assert qr_fused.LAUNCHES["qr_panel_update"] == before


# --------------------------------------------------------------------------
# LSQR and CGLS
# --------------------------------------------------------------------------

def _ls_system(kind, dtype):
    rng = np.random.default_rng(7)
    m, n = 300, 80
    d = rng.standard_normal((m, n))
    b = rng.standard_normal(m).astype(dtype)
    if kind == "bsr":
        d[np.abs(d) < 1.0] = 0
        return (JBSR.from_dense(d.astype(dtype), block_size=16),
                TBSR.from_dense(d.astype(dtype), block_size=16,
                                device="cpu"), d.astype(dtype), b)
    d = d.astype(dtype)
    return jnp.asarray(d), d, d, b


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["dense", "bsr"])
@pytest.mark.parametrize("method", ["lsqr", "cgls"])
def test_ls_iterative_matches_reference(method, kind, dtype, backend):
    dt = np.dtype(dtype)
    ja, ta, dense, b = _ls_system(kind, dt)
    tol = 1e-12 if dt == np.float64 else 1e-5
    want = japi.solve(ja, jnp.asarray(b), method=method, tol=tol,
                      maxiter=400, return_info=True)
    got = tapi.solve(ta, b, method=method, tol=tol, maxiter=400,
                     backend=backend, return_info=True, device="cpu")
    it, ref_it = got.iterations, int(want.iterations)
    assert it <= max(1.2 * ref_it, ref_it + 2)
    assert ref_it <= max(1.2 * it, it + 2)
    assert bool(got.converged) == bool(want.converged)
    assert set(got.info) == set(want.info)
    for key in ("fail_code", "fail_iter"):
        assert int(got.info[key]) == int(want.info[key])
    assert got.info["fail_reason"] == want.info["fail_reason"]
    assert got.x.shape == (80,)
    if dt == np.float64:
        assert it == ref_it
        assert np.abs(got.x.numpy() - np.asarray(want.x)).max() <= 1e-10
        xo = np.linalg.solve(dense.T @ dense, dense.T @ b)
        assert np.abs(got.x.numpy() - xo).max() <= 1e-9
    else:
        assert _rel(got.x.numpy(), want.x) <= 1e-4


def test_cgls_float32_returns_the_best_iterate_as_the_reference_does():
    """Past its attainable accuracy float32 CGLS diverges; both packages
    stop on the divergence cutoff and return the best iterate."""
    rng = np.random.default_rng(0)         # the reference test's system
    a = rng.standard_normal((384, 96)).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="cgls",
                      tol=1e-9, maxiter=500, return_info=True)
    got = tapi.solve(a, b, method="cgls", tol=1e-9, maxiter=500,
                     backend="cuda", return_info=True, device="cpu")
    xo = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                         rcond=None)[0]
    assert int(want.iterations) < 500 and got.iterations < 500
    assert got.info["fail_reason"] == want.info["fail_reason"]
    assert np.abs(got.x.numpy() - xo).max() <= 1e-5
    assert float(got.residual) <= 2 * float(want.residual)


def test_cgls_on_a_square_system_takes_the_fused_update(monkeypatch):
    """Square least squares sends CGLS's paired axpys through the fused
    update (its plain version on CPU tensors); rectangular ones do not."""
    calls = []
    orig = ops.fused_cg_update
    monkeypatch.setattr(ops, "fused_cg_update",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    rng = np.random.default_rng(0)
    n = 64
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = tapi.solve(a, b, method="cgls", backend="cuda", tol=1e-6,
                   maxiter=300, device="cpu")
    assert calls
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-3,
                               atol=1e-3)
    calls.clear()
    ar, br = _rect(96, 40, np.float32)
    tapi.solve(ar, br, method="cgls", backend="cuda", device="cpu")
    assert not calls


def test_axpy_pair_is_the_plain_pair_on_every_shape():
    op = DenseOperator(torch.eye(4), backend="ref")
    x, p = torch.ones(4), torch.arange(4.0)
    r, q = torch.ones(6), torch.arange(6.0)
    xn, rn = op.axpy_pair(x, p, r, q, torch.tensor(0.5))
    assert torch.equal(xn, x + 0.5 * p) and torch.equal(rn, r - 0.5 * q)


def test_lsqr_preconditioner_error_matches_reference():
    a, b = _rect(64, 64, np.float64)
    a = a + 64 * np.eye(64)
    _same_error(lambda: japi.solve(jnp.asarray(a), jnp.asarray(b),
                                   method="lsqr", precond="jacobi"),
                lambda: tapi.solve(a, b, method="lsqr", precond="jacobi",
                                   device="cpu"))


# --------------------------------------------------------------------------
# solve on non-square input, the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"method": "cg"}, {"method": "lu"},
    {"method": "qr", "precond": "jacobi"},
    {"method": "lsqr", "precond": "jacobi"},
    {"method": "lsqr", "engine": "spmd"},
    {"method": "cgls", "engine": "spmd"},
], ids=["cg", "lu", "qr-precond", "lsqr-precond", "lsqr-spmd", "cgls-spmd"])
def test_non_square_audit_messages_match_reference(kw):
    a, b = _rect(96, 40, np.float64)
    _same_error(lambda: japi.solve(jnp.asarray(a), jnp.asarray(b), **kw),
                lambda: tapi.solve(a, b, device="cpu", **kw))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rectangular_return_info_reports_the_normal_equations_residual(
        dtype):
    a, b = _rect(200, 64, dtype)
    want = japi.solve(jnp.asarray(a), jnp.asarray(b), method="qr",
                      block_size=32, return_info=True)
    got = tapi.solve(a, b, method="qr", block_size=32, backend="cuda",
                     return_info=True, device="cpu")
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    res = np.linalg.norm(a64.T @ (b64 - a64 @ got.x.numpy()))
    assert got.iterations == 0 and bool(got.converged)
    assert set(got.info) == set(want.info)
    assert got.info["fail_reason"] == want.info["fail_reason"] == "ok"
    if dtype == np.float64:
        assert abs(float(got.residual) - float(want.residual)) <= 1e-10
        assert abs(float(got.residual) - res) <= 1e-10
    else:
        assert float(got.residual) <= 1e-4 * np.linalg.norm(a64.T @ b64)


def test_qr_is_a_direct_method_that_factorize_takes():
    assert "qr" in tapi.DIRECT and {"lsqr", "cgls"} <= set(tapi.ITERATIVE)
    assert tapi.get_method("qr").rectangular
    assert not tapi.get_method("lu").rectangular
    a, b = _rect(96, 40, np.float64)
    with pytest.raises(ValueError, match="underdetermined"):
        tapi.solve(a.T, b[:40], method="qr", device="cpu")


@pytest.mark.parametrize("method", ["qr", "lsqr", "cgls"])
def test_cli_least_squares_runs_on_the_cpu(method, capsys):
    assert cli.main(["--m", "300", "--n", "120", "--method", method,
                     "--backend", "cuda", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "||Aᵀ(b - Ax)||/||Aᵀb||" in out and "shape=(300, 120)" in out


def test_cli_draws_the_reference_least_squares_system():
    from repro.launch.solve import make_system as ref_make_system
    a, b = cli.make_system(40, spd=False, m=100, device="cpu")
    ra, rb = ref_make_system(40, spd=False, m=100)
    np.testing.assert_array_equal(a.numpy(), ra)
    np.testing.assert_array_equal(b.numpy(), rb)


# --------------------------------------------------------------------------
# GMRES stopping at the float32 rounding floor (ROADMAP §3)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "bsr"])
def test_float32_gmres_stagnates_at_the_rounding_floor_like_the_reference(
        kind):
    """float32 GMRES(32) on the 16³ Poisson system with ``smooth_rhs`` and
    tol 1e-6: both packages reach the float32 floor in two cycles (‖r‖/‖b‖
    ≈ 2.2e-6, above tol) and stop with "stagnation" after three cycles
    with no new best residual.  The cycle they stop at cannot be held
    equal: at the floor each cycle's residual moves by a few per cent with
    the rounding of the matvecs and the Gram-Schmidt sums, which the two
    packages order differently, and whether a cycle sets a new best is
    decided by those last bits.  (On the CPU the reference's per-cycle
    ‖r‖/‖b‖ from cycle 2 on is 2.192, 2.204, 2.215, 2.166, 2.141, ... e-6,
    setting new bests at cycles 5, 6 and 8 and stopping at 11; the port's
    is 2.292, 2.209, 2.227, 2.236, 2.227 e-6 and stops at 6.  Replacing
    ``torch.linalg.pinv`` by an SVD solve with ``jnp.linalg.lstsq``'s
    cut-off moves the port's stop to 7, not 11.)  So the failure code and
    reason are held equal, and both true residuals at the floor."""
    a = jproblems.poisson_3d(16).astype(np.float32)
    b = jproblems.smooth_rhs(a.shape[0]).astype(np.float32)
    if kind == "bsr":
        ja = JBSR.from_dense(a, block_size=8)
        ta = TBSR.from_dense(a, block_size=8, device="cpu")
    else:
        ja, ta = jnp.asarray(a), a
    kw = dict(method="gmres", tol=1e-6, restart=32, maxiter=100,
              return_info=True)
    want = japi.solve(ja, jnp.asarray(b), **kw)
    got = tapi.solve(ta, b, device="cpu", **kw)
    assert int(got.info["fail_code"]) == int(want.info["fail_code"]) == 3
    assert got.info["fail_reason"] == want.info["fail_reason"] \
        == "stagnation"
    assert not bool(got.converged) and not bool(want.converged)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    rel = [np.linalg.norm(b64 - a64 @ np.asarray(x, np.float64))
           / np.linalg.norm(b64) for x in (want.x, got.x.numpy())]
    for r in rel:
        assert 1e-6 < r < 5e-6           # at the floor, above tol
    assert max(rel) <= 1.5 * min(rel)
