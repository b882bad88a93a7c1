"""The port's fused Krylov kernels against the reference's Pallas kernels.

On the CPU the wrappers of :mod:`repro_torch.kernels.krylov_fused` run
their plain versions; these are held against
``repro.kernels.krylov_fused.*_auto`` in interpret mode, on the same numpy
inputs, at the tolerances of ``tests/test_kernels.py`` for those kernels
(vectors rtol = atol = 1e-5, dots rtol 1e-4).  The hand-written CUDA
kernels themselves are held against the plain versions on the GPU by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import krylov_fused as jax_fused
from repro_torch.kernels import krylov_fused, ops, ref

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
                                     "fused_pipelined_dots": 0}


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
