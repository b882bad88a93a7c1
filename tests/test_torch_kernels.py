"""The port's kernels against the reference's Pallas kernels.

On the CPU the wrappers of :mod:`repro_torch.kernels` run their plain
versions; these are held against the reference on the same numpy inputs,
at the tolerances of ``tests/test_kernels.py`` for those kernels:

* ``krylov_fused.*_auto`` in interpret mode (vectors rtol = atol = 1e-5,
  dots rtol 1e-4);
* ``factor_fused.lu_panel_update`` / ``cholesky_panel_update`` in
  interpret mode (rtol 1e-4, atol 1e-3);
* the triangular solves against ``jax.scipy.linalg.solve_triangular``
  (rtol = atol = 1e-3): the reference's Pallas ``trsm`` kernel does not run
  on this JAX version (``pl.load`` is gone), so its own tests use the same
  oracle.

The hand-written CUDA kernels themselves are held against the plain
versions on the GPU by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import jax.scipy.linalg as jla
import numpy as np
import pytest
import torch

from repro.kernels import factor_fused as jax_factor_fused
from repro.kernels import krylov_fused as jax_fused
from repro_torch.kernels import factor_fused, krylov_fused, ops, ref, trsm

SIZES = [64, 130, 4096 + 7]


def _vectors(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("n", SIZES)
def test_fused_cg_update_matches_reference(n):
    x, r, p, ap = _vectors(n, 4, seed=n)
    alpha = np.float32(0.41)
    want = jax_fused.fused_cg_update_auto(
        *(jnp.asarray(v) for v in (x, r, p, ap)), alpha, interpret=True)
    got = krylov_fused.fused_cg_update(
        *(torch.from_numpy(v) for v in (x, r, p, ap)),
        torch.tensor(alpha))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert got[2].ndim == 0 and got[2].dtype == torch.float32
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)


@pytest.mark.parametrize("n", SIZES)
def test_fused_pipelined_dots_matches_reference(n):
    r, u, w = _vectors(n, 3, seed=100 + n)
    want = jax_fused.fused_pipelined_dots_auto(
        *(jnp.asarray(v) for v in (r, u, w)), interpret=True)
    got = krylov_fused.fused_pipelined_dots(
        *(torch.from_numpy(v) for v in (r, u, w)))
    assert len(got) == 3
    for g, v in zip(got, want):
        assert g.ndim == 0
        np.testing.assert_allclose(float(g), float(v), rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, r, p, ap = (torch.from_numpy(v) for v in _vectors(130, 4, seed=1))
    krylov_fused.reset_launches()
    got = ops.fused_cg_update(x, r, p, ap, 0.5)
    want = ops.fused_cg_update(x, r, p, ap, 0.5, use_kernel=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dots = ops.fused_pipelined_dots(x, r, p)
    for g, w in zip(dots, ref.fused_pipelined_dots(x, r, p)):
        assert torch.equal(g, w)
    assert krylov_fused.LAUNCHES == {"fused_cg_update": 0,
                                     "fused_pipelined_dots": 0,
                                     "fused_gram": 0}


@pytest.mark.parametrize("bad,err", [
    (lambda v: v.double(), TypeError),
    (lambda v: v.numpy(), TypeError),
    (lambda v: v[:-1], ValueError),
    (lambda v: v.reshape(2, -1), ValueError),
    (lambda v: torch.stack([v, v], 1)[:, 0], ValueError),
])
def test_wrappers_reject_malformed_vectors(bad, err):
    x, r, p, ap = (torch.from_numpy(v) for v in _vectors(130, 4, seed=2))
    with pytest.raises(err):
        krylov_fused.fused_cg_update(x, bad(r), p, ap, 0.5)
    with pytest.raises(err):
        krylov_fused.fused_pipelined_dots(x, r, bad(p))


# tests/test_kernels.py's panel-update cases
LU_PANEL_CASES = [(128, 32, 0), (128, 32, 64), (128, 32, 96), (256, 64, 64)]
CHOL_PANEL_CASES = [(128, 32, 0), (128, 32, 64), (128, 32, 96)]


def _lu_panel_inputs(n, nb, k):
    """The inputs of tests/test_kernels.py::test_lu_panel_update_kernel."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((n, n)).astype(np.float32)
    l11 = np.tril(rng.standard_normal((nb, nb)), -1).astype(np.float32) \
        + np.eye(nb, dtype=np.float32)
    a[k:k + nb, k:k + nb] = l11 + np.triu(a[k:k + nb, k:k + nb])
    return a, np.linalg.inv(l11).astype(np.float32)


def _chol_panel_inputs(n, nb, k):
    """The inputs of tests/test_kernels.py::test_cholesky_panel_update_kernel."""
    rng = np.random.default_rng(13)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a = (a @ a.T / n + 4 * np.eye(n)).astype(np.float32)
    lkk = np.linalg.cholesky(a[k:k + nb, k:k + nb]).astype(np.float32)
    a[k:k + nb, k:k + nb] = lkk
    return a, np.linalg.inv(lkk).astype(np.float32)


@pytest.mark.parametrize("kind,n,nb,k",
                         [("lu",) + c for c in LU_PANEL_CASES]
                         + [("cholesky",) + c for c in CHOL_PANEL_CASES])
def test_panel_update_matches_reference(kind, n, nb, k):
    name = f"{kind}_panel_update"
    a, linv = (_lu_panel_inputs if kind == "lu" else _chol_panel_inputs)(
        n, nb, k)
    want = getattr(jax_factor_fused, name)(jnp.asarray(a), jnp.asarray(linv),
                                           k, nb=nb, interpret=True)
    factor_fused.reset_launches()
    ta = torch.from_numpy(a.copy())
    got = getattr(factor_fused, name)(ta, torch.from_numpy(linv), k, nb=nb)
    assert got is ta                            # in place on the CPU too
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    assert factor_fused.LAUNCHES[name] == 0     # CPU: the plain version


# (n, m, upper): tests/test_kernels.py's trsm shapes (sweep, upper sweep,
# auto padding), plus one right-hand side as a column and as a 1-D vector
TRSM_CASES = [(128, 128, False), (256, 128, False), (128, 256, False),
              (128, 128, True), (256, 64, True), (100, 1, False),
              (130, 7, False), (100, 1, True), (130, 7, True),
              (96, 0, False), (96, 0, True)]


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n,m,upper", TRSM_CASES)
def test_trsm_matches_reference(n, m, upper, unit):
    rng = np.random.default_rng(n + m)
    t = (rng.standard_normal((n, n)) * 0.1 + 2 * np.eye(n)).astype(
        np.float32)
    t = np.triu(t) if upper else np.tril(t)
    b = rng.standard_normal((n, m) if m else (n,)).astype(np.float32)
    want = jla.solve_triangular(jnp.asarray(t), jnp.asarray(b),
                                lower=not upper, unit_diagonal=unit)
    solve = trsm.trsm_upper if upper else trsm.trsm_lower
    trsm.reset_launches()
    got = solve(torch.from_numpy(t), torch.from_numpy(b), unit_diagonal=unit)
    assert got.shape == b.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    # Cholesky's second solve hands over Lᵀ as a transposed view
    if upper:
        got_t = solve(torch.from_numpy(np.ascontiguousarray(t.T)).T,
                      torch.from_numpy(b), unit_diagonal=unit)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)
    assert trsm.LAUNCHES["trsm"] == 0


def test_direct_kernel_ops_take_the_plain_version_on_cpu():
    a, linv = (torch.from_numpy(v) for v in _lu_panel_inputs(128, 32, 64))
    got = ops.lu_panel_update(a.clone(), linv, 64, nb=32)
    want = ref.lu_panel_update(a.clone(), linv, 64, nb=32)
    assert torch.equal(got, want)
    b = torch.ones(128)
    for name in ("trsm_lower", "trsm_upper"):
        assert torch.equal(getattr(ops, name)(a, b, unit_diagonal=True),
                           getattr(ref, name)(a, b, unit_diagonal=True))


@pytest.mark.parametrize("bad,err", [
    (lambda a, linv: (a.double(), linv), TypeError),
    (lambda a, linv: (a[:, :96], linv), ValueError),
    (lambda a, linv: (a.T, linv), ValueError),
    (lambda a, linv: (a, linv[:16, :16]), ValueError),
    (lambda a, linv: (a[:120, :120].contiguous(), linv), ValueError),
])
def test_panel_update_rejects_malformed_inputs(bad, err):
    a, linv = (torch.from_numpy(v) for v in _lu_panel_inputs(128, 32, 64))
    with pytest.raises(err):
        factor_fused.lu_panel_update(*bad(a, linv), 64, nb=32)
    with pytest.raises(ValueError, match="step offset"):
        factor_fused.cholesky_panel_update(a, linv, 112, nb=32)


@pytest.mark.parametrize("bad,err", [
    (lambda t, b: (t.double(), b), TypeError),
    (lambda t, b: (t[:, :64], b), ValueError),
    (lambda t, b: (t, b[:64]), ValueError),
    (lambda t, b: (t[::2, ::2], b[:64]), ValueError),
    (lambda t, b: (t, b[:, None, None]), ValueError),
])
def test_trsm_rejects_malformed_inputs(bad, err):
    t = torch.eye(128) * 2
    b = torch.ones(128)
    with pytest.raises(err):
        trsm.trsm_lower(*bad(t, b))
