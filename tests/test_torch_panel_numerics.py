"""The order of sums of the Cholesky panel-update kernel against
:mod:`repro` on the CPU.

``csrc/factor_fused.cu`` runs only on the card, so this file emulates in
float32 torch what its Cholesky step computes (each multiply-add rounded
once, as ``fmaf``):

- L21 = C·Lkk⁻ᵀ, each entry summed over nb depths in ascending order;
- A22 −= L21·L21ᵀ on the 128 × 128 tiles on and below the diagonal only,
  one block of the symmetric launch a tile, found from the block's index
  by ``lower_tile``: the tile's product P summed in ascending depth,
  subtracted from its tile and, below the diagonal, P transposed from the
  mirrored tile, which reads its own A;
- L21 into the panel column block.

The emulation is held at ``chip_smoke.panel_update_close``'s tolerance
(atol 1e-5 of the largest change the update makes, rtol 2.5e-7) against
``repro.kernels.factor_fused.cholesky_panel_update`` in interpret mode, on
an A whose upper triangle differs from its lower one too, and against the
port's plain version on a ragged size.  On an exactly symmetric A its
trailing block is bitwise symmetric.  A ``cuda`` test holds the tile map's
Python mirror against the built kernel's; JAX is imported only by the
tests that call it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import factor_fused, ref

BM = 128                  # tile_gemm_sm90.cuh's output tile


def _jax_update(a, linv, k, nb):
    """``repro.kernels.factor_fused.cholesky_panel_update`` in interpret
    mode, on the same float32 inputs."""
    import jax.numpy as jnp
    from repro.kernels import factor_fused as jfactor_fused
    out = jfactor_fused.cholesky_panel_update(
        jnp.asarray(a.numpy()), jnp.asarray(linv.numpy()), k, nb=nb,
        interpret=True)
    return torch.tensor(np.asarray(out))


def _fma(acc, a, b):
    """acc + a·b rounded once to float32 (the float64 product is exact)."""
    return (acc.double() + a.double() * b.double()).float()


def lower_tile(b):
    """``sm90::lower_tile``: the tile (i, j), i ≥ j, of block b, the lower
    tiles row by row."""
    i = int((math.sqrt(8.0 * b + 1.0) - 1.0) / 2.0)
    while i * (i + 1) // 2 > b:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= b:
        i += 1
    return i, b - i * (i + 1) // 2


def _ordered_rows(x, y):
    """X·Yᵀ with each entry Σ_q fma(x[i, q], y[j, q]) over ascending q."""
    acc = torch.zeros(x.shape[0], y.shape[0])
    for q in range(x.shape[1]):
        acc = _fma(acc, x[:, q, None], y[None, :, q])
    return acc


def emulate_cholesky_update(a, linv, k, nb):
    """Kernel 5's step on a copy of the (n, n) ``a``."""
    out = a.clone()
    m = a.shape[0] - k - nb
    if m == 0:
        return out
    col = out[k + nb:, k:k + nb]
    l21 = _ordered_rows(col, linv)          # B(q, j) = Linv[j, q]
    a22 = out[k + nb:, k + nb:]
    t = -(-m // BM)
    for b in range(t * (t + 1) // 2):
        i, j = lower_tile(b)
        ri = slice(i * BM, min(m, (i + 1) * BM))
        rj = slice(j * BM, min(m, (j + 1) * BM))
        p = _ordered_rows(l21[ri], l21[rj])
        a22[ri, rj] -= p
        if i > j:
            a22[rj, ri] -= p.T
    col.copy_(l21)
    return out


def _step(n, nb, k, seed, shape="spd"):
    """The SPD ``g gᵀ/n + 4I`` of a seeded Gaussian g (``shape``
    "symmetric": made exactly symmetric as (a + aᵀ)/2; "unsymmetric": a
    Gaussian upper triangle added), with Lkk in its diagonal block at k and
    Lkk⁻¹, as the factorization hands them to the kernel."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    a = torch.tensor(g @ g.T / n + 4 * np.eye(n), dtype=torch.float32)
    if shape == "symmetric":
        a = (a + a.T) / 2
    elif shape == "unsymmetric":
        a += torch.triu(torch.tensor(rng.standard_normal((n, n)),
                                     dtype=torch.float32), 1)
    lkk = torch.linalg.cholesky(a[k:k + nb, k:k + nb])
    a[k:k + nb, k:k + nb] = lkk
    linv = torch.linalg.solve_triangular(lkk, torch.eye(nb), upper=False)
    return a, linv


def _hold(got, want, a_in):
    """``chip_smoke.panel_update_close``: |got − want| ≤ 1e-5·max|want −
    a_in| + 2.5e-7·|want|."""
    change = float((want - a_in).abs().max())
    assert change > 0
    torch.testing.assert_close(got, want, rtol=2.5e-7, atol=1e-5 * change)


# (n, nb, k): m = n − k − nb trailing rows; ragged last tiles (m = 224,
# 352, 192, 32), whole ones (m = 128, 256), and nb = 192 > 128
PANEL_CASES = [(256, 32, 0), (256, 32, 96), (256, 32, 192), (256, 128, 0),
               (384, 32, 0), (384, 32, 160), (384, 32, 320), (384, 128, 0),
               (384, 128, 128), (384, 192, 0)]


@pytest.mark.parametrize("n,nb,k", PANEL_CASES)
def test_cholesky_update_order_matches_the_pallas_kernel(n, nb, k):
    a, linv = _step(n, nb, k, seed=n + nb + k)
    got = emulate_cholesky_update(a, linv, k, nb)
    assert torch.equal(got[:, :k], a[:, :k])
    assert torch.equal(got[:k + nb, k:], a[:k + nb, k:])
    _hold(got, _jax_update(a, linv, k, nb), a)


@pytest.mark.parametrize("n,nb,k", [(384, 32, 0), (256, 128, 0),
                                    (384, 32, 160)])
def test_cholesky_update_reads_each_tile_of_an_unsymmetric_a(n, nb, k):
    """An upper triangle that differs from the lower one by O(1): a mirror
    that read its source tile's A, transposed, would miss by that much."""
    a, linv = _step(n, nb, k, seed=k + 3, shape="unsymmetric")
    tail = a[k + nb:, k + nb:]
    assert float((tail - tail.T).abs().max()) > 1.0
    _hold(emulate_cholesky_update(a, linv, k, nb),
          _jax_update(a, linv, k, nb), a)


@pytest.mark.parametrize("n,nb,k", PANEL_CASES)
def test_emulated_update_is_bitwise_symmetric_on_a_symmetric_a(n, nb, k):
    a, linv = _step(n, nb, k, seed=n * nb + k, shape="symmetric")
    tail = emulate_cholesky_update(a, linv, k, nb)[k + nb:, k + nb:]
    assert torch.equal(tail, tail.T)
    assert not torch.equal(tail, a[k + nb:, k + nb:])


def test_lower_tile_map_covers_every_lower_tile_once():
    for t in list(range(1, 130)) + [255, 1024]:
        tiles = [lower_tile(b) for b in range(t * (t + 1) // 2)]
        assert tiles == [(i, j) for i in range(t) for j in range(i + 1)]


@pytest.mark.parametrize("n,nb,k", [(500, 10, 20), (390, 13, 13)])
def test_cholesky_emulation_matches_the_plain_version_on_a_ragged_size(
        n, nb, k):
    """Trailing blocks of 470 and 364 rows (ragged in the last tile), nb
    not a multiple of 4, against the port's plain update."""
    a, linv = _step(n, nb, k, seed=5)
    _hold(emulate_cholesky_update(a, linv, k, nb),
          ref.cholesky_panel_update(a.clone(), linv, k, nb=nb), a)


# blocks of the direct path's launches (T = 127 tiles at n = 16384, k = 0:
# 8128 blocks), and the ends of the last two rows of the largest grid the
# launch takes (T = 65535: 2147450880 blocks)
TILE_BLOCKS = list(range(0, 8128, 97)) + [8127, 2147385344, 2147385345,
                                          2147450879]


@pytest.mark.cuda
def test_lower_tile_map_matches_the_built_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    for b in TILE_BLOCKS:
        assert factor_fused.lower_tile(b) == lower_tile(b)
