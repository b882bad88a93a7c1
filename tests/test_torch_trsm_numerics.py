"""The order of sums of the triangular-solve kernel against :mod:`repro` on
the CPU.

``csrc/trsm.cu`` runs only on the card, so this file emulates in float32
torch the two orders in which the port's kernels have summed the blocked
substitution X_j = Linv_jj (B_j − Σ_{i<j} L_ji X_i), both on the wrapper's
own inverted diagonal blocks (``trsm.diag_inverses``):

- the old right-looking order: one step per block row i, which forms X_i
  and subtracts L_ji X_i from every later block of a working copy of B;
- the new left-looking order of the one-launch kernel: block row j sums
  L_ji X_i into float32 registers in ascending i, each tile in the
  kernel's physical frame (its memory order: descending logical order for
  an upper triangle) and, for one right-hand side, in the kernel's two
  interleaved halves of each tile's depth (float4 steps 0, 2, ... and 1,
  3, ... of a row-major tile; even and odd depths of a transposed one)
  added at the end; then B_j − sum, then the product with Linv_jj in the
  same two halves.

Both run on the direct path's triangles at n = 1024: the unit L and the U
of ``a + nI``'s LU, the U of a Gaussian matrix's pivoted LU, and
Cholesky's Lᵀ read as a transposed view.  Each is held against a float64
solve and against ``jax.scipy.linalg.solve_triangular``; the Pallas
``trsm`` cannot be the oracle, because JAX 0.9 has no ``pl.load``.  The
new order must stay inside the gate the card holds the kernel to
(``chip_smoke.py`` phase 3b: rtol 1e-3, atol 1e-3 · max|x|, here against
the JAX float32 solve), and its error against float64 must be at most
twice the old order's.
"""
import numpy as np
import pytest
import torch
from jax.scipy.linalg import solve_triangular as jax_solve_triangular

from repro_torch.kernels import trsm

N = 1024
SB = trsm.BLOCK_ROWS


def _factors(kind: str):
    """(t, upper, unit) for the direct path's triangles, float32, from a
    seeded Gaussian matrix."""
    rng = np.random.default_rng(21)
    a = torch.tensor(rng.standard_normal((N, N)), dtype=torch.float32)
    if kind == "cholesky_lt":
        spd = a @ a.T / N + 4.0 * torch.eye(N)
        return torch.linalg.cholesky(spd).T, True, False   # Lᵀ, a view
    if kind != "gaussian_u":
        a = a + N * torch.eye(N)
    lu = torch.linalg.lu_factor(a).LU
    if kind == "dominant_l":
        return lu, False, True          # trsm_lower reads the strict lower
    return lu, True, False              # trsm_upper reads the upper


def _halves(m: int, trans: bool, depth: int):
    """The half of a tile's depth q each sum of the kernel takes: two
    halves for one right-hand side (float4 steps alternating in a row-major
    tile, single depths alternating in a transposed one), one otherwise."""
    q = torch.arange(depth)
    if m != 1:
        return torch.zeros(depth, dtype=torch.long), 1
    return (q % 2 if trans else (q // 4) % 2), 2


def _sequential(mat, vec, halves, nh, acc=None):
    """acc[h] += mat[:, q] · vec[q] for q ascending, each q into its half
    (float32, one rounding a product and one a sum)."""
    acc = [torch.zeros(mat.shape[0], vec.shape[1]) for _ in range(nh)] \
        if acc is None else acc
    for q in range(mat.shape[1]):
        h = int(halves[q])
        acc[h] = acc[h] + mat[:, q, None] * vec[q, None, :]
    return acc


def _left_looking(t, b, upper, unit):
    """The one-launch kernel's order of sums; returns X (physical rows)."""
    n, m = t.shape[0], b.shape[1]
    trans = not t.is_contiguous()
    phys = t.contiguous()               # P[r, c]: L' in the physical frame
    linv = trsm.diag_inverses(t, rev=upper, unit_diagonal=unit)
    nblk = -(-n // SB)

    def rows(k):                        # physical rows of logical block k
        lo = n - SB * (k + 1) if upper else SB * k
        return max(lo, 0), min(lo + SB, n), lo

    x = torch.zeros(n, m)
    tile_halves, nh = _halves(m, trans, SB)
    inv_halves, nh_inv = _halves(m, False, SB)
    for j in range(nblk):
        r0, r1, lo = rows(j)
        acc = None
        for i in range(j):
            c0, c1, _ = rows(i)
            acc = _sequential(phys[r0:r1, c0:c1], x[c0:c1], tile_halves, nh,
                              acc)
        total = torch.zeros(r1 - r0, m) if acc is None else \
            (acc[0] + acc[1] if nh == 2 else acc[0])
        # ws in logical order: block row l is physical row lo + 127 − l
        # (upper) or lo + l, those outside [0, n) zero
        ws = torch.zeros(SB, m)
        local = torch.arange(r0 - lo, r1 - lo)
        logical = SB - 1 - local if upper else local
        ws[logical] = b[r0:r1] - total
        out = _sequential(linv[j], ws, inv_halves, nh_inv)
        out = out[0] + out[1] if nh_inv == 2 else out[0]
        x[r0:r1] = out[logical]
    return x


def _right_looking(t, b, upper, unit):
    """The earlier kernel's order: X_i = Linv_ii W_i, then W_j −= L_ji X_i
    for every later block j, one block row a step (logical frame)."""
    n = t.shape[0]
    lp = t.flip(0, 1) if upper else t
    w = (b.flip(0) if upper else b).clone()
    linv = trsm.diag_inverses(t, rev=upper, unit_diagonal=unit)
    x = torch.zeros_like(w)
    for i in range(-(-n // SB)):
        s = slice(i * SB, min(n, (i + 1) * SB))
        k = s.stop - s.start
        x[s] = linv[i][:k, :k] @ w[s]
        w[s.stop:] -= lp[s.stop:, s] @ x[s]
    return x.flip(0) if upper else x


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("kind", ["dominant_l", "dominant_u", "gaussian_u",
                                  "cholesky_lt"])
def test_left_looking_order_holds_the_gate(kind, m):
    t, upper, unit = _factors(kind)
    rng = np.random.default_rng(m)
    b = torch.tensor(rng.standard_normal((N, m)), dtype=torch.float32)
    tri = torch.triu(t) if upper else torch.tril(t)
    if unit:
        tri = tri - torch.diag(tri.diagonal()) + torch.eye(N)
    x64 = torch.linalg.solve_triangular(tri.double(), b.double(),
                                        upper=upper)
    x_jax = torch.tensor(np.asarray(jax_solve_triangular(
        tri.numpy(), b.numpy(), lower=not upper, unit_diagonal=unit)))
    new = _left_looking(t, b, upper, unit)
    old = _right_looking(t, b, upper, unit)
    assert bool(torch.isfinite(new).all())
    scale = float(x_jax.abs().max())
    torch.testing.assert_close(new, x_jax, rtol=1e-3, atol=1e-3 * scale)
    err_new = float((new.double() - x64).abs().max())
    err_old = float((old.double() - x64).abs().max())
    err_jax = float((x_jax.double() - x64).abs().max())
    print(f"[trsm-order] {kind} m={m} err_new={err_new:.3e} "
          f"err_old={err_old:.3e} err_jax={err_jax:.3e} max|x|={scale:.3e}")
    assert err_new <= 2.0 * err_old


def test_emulation_matches_the_plain_solve_on_a_ragged_size():
    """The emulation's block arithmetic (ragged last block, reversal) on a
    size that is not a multiple of 128, against the port's plain solve."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(5)
    n = 300
    a = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32) \
        * (0.5 / n ** 0.5) + 2 * torch.eye(n)
    b = torch.tensor(rng.standard_normal((n, 2)), dtype=torch.float32)
    for t, upper in ((torch.tril(a), False), (torch.triu(a), True),
                     (torch.tril(a).T, True)):
        plain = (ref.trsm_upper if upper else ref.trsm_lower)(t, b)
        for m in (1, 2):
            got = _left_looking(t, b[:, :m], upper, False)
            torch.testing.assert_close(got, plain[:, :m], rtol=1e-4,
                                       atol=1e-5)
