"""The order of sums of the QR-update and Gram kernels against :mod:`repro`
on the CPU.

``csrc/qr_fused.cu`` and ``csrc/krylov_fused.cu`` run only on the card, so
this file emulates in float32 torch the order in which each kernel sums
(each multiply-add rounded once, as ``fmaf``):

- kernel 9, the QR trailing update A −= V·(Tᵀ·(Vᵀ·A)) on the window of
  R = m − k rows and N = n − k − nb columns: W = VᵀA split over R into the
  parts that ``tile_gemm_sm90.cuh``'s ``splits_for`` gives on an H100's
  132 SMs (32-deep slices, each part ascending in depth); the fold, which
  sums W's parts in the order 0, 1, … and applies Tᵀ in ascending depth;
  then A − V·Y, each entry's product ascending over nb depths (split, and
  its parts subtracted in order, only where nb is deep and the tiles few);
- kernel 3, the Gram matrix G = V·Vᵀ for k ≤ 16: thread t of the grid's
  T threads sums the 4-column quads t, t + T, … in that order, the block
  sums its threads by a shuffle tree in each warp (offsets 16, 8, 4, 2, 1)
  and its 8 warps in order, and the last block sums the blocks' partials in
  block order; the grid is one block per 256 quads, at most 264 (132 above
  k = 10).

Each emulation is held at ``chip_smoke.py``'s tolerances (the QR update
rtol 1e-5, atol 1e-4 of the change it makes; the Gram matrix rtol 1e-5,
atol 1e-5 of max|G|) against the Pallas kernel in interpret mode
(``repro.kernels.qr_fused.qr_panel_update``,
``repro.kernels.krylov_fused.fused_gram_auto``), and against the port's
plain version on a ragged size.  Two ``cuda`` tests hold the emulation's
split and block counts against the built kernels' own; JAX is imported
only by the tests that call it, so the ``cuda`` tests also run where
JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import qr
from repro_torch.kernels import krylov_fused, qr_fused, ref

SMS = 132                 # an H100's SMs: the split counts and grids follow
BM, BK = 128, 32          # tile_gemm_sm90.cuh's output tile and slice depth
BLOCKS_PER_SM = 2
MIN_SPLIT_DEPTH = 512
THREADS = 256             # the Gram kernel's block


def _pallas():
    """``jax.numpy`` and the Pallas kernels of :mod:`repro`."""
    import jax.numpy as jnp
    from repro.kernels import krylov_fused as jkrylov_fused
    from repro.kernels import qr_fused as jqr_fused
    return jnp, jkrylov_fused, jqr_fused


def _fma(acc, a, b):
    """acc + a·b rounded once to float32 (the float64 product is exact)."""
    return (acc.double() + a.double() * b.double()).float()


# --------------------------------------------------------------------------
# kernel 9
# --------------------------------------------------------------------------

def _splits_for(m, n, k):
    """``sm90::splits_for`` on SMS SMs."""
    tiles = -(-m // BM) * -(-n // BM)
    resident = SMS * BLOCKS_PER_SM
    if tiles >= resident:
        return 1
    return max(1, min(resident // tiles, k // MIN_SPLIT_DEPTH))


def _split_ranges(k, splits):
    """``sm90::split_depth``: the non-empty parts' depth ranges."""
    kc = -(-k // splits)
    kc = -(-kc // BK) * BK
    return [(lo, min(k, lo + kc)) for lo in range(0, k, kc)]


def _ordered_product(a_cols, b_rows, lo, hi):
    """Σ_{q = lo}^{hi − 1} a_cols[q] ⊗ b_rows[q], ascending q."""
    acc = torch.zeros(a_cols.shape[1], b_rows.shape[1])
    for q in range(lo, hi):
        acc = _fma(acc, a_cols[q, :, None], b_rows[q, None, :])
    return acc


def _in_order(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def emulate_qr_update(a, v, t, k, nb):
    """Kernel 9's order of sums on a copy of the (m, n) ``a``; ``v`` is
    the active (m − k, nb) block."""
    out = a.clone()
    win = out[k:, k + nb:]
    rows, cols = win.shape
    if cols == 0:
        return out
    # 1. W's parts: W_z[i, j] = Σ_q V[q, i] A[q, j] over part z
    w = _in_order([_ordered_product(v, win, lo, hi) for lo, hi in
                   _split_ranges(rows, _splits_for(nb, cols, rows))])
    # 2. the fold: Y[i, j] = Σ_q T[q, i] W[q, j], ascending q
    y = _ordered_product(t, w, 0, nb)
    # 3. A −= V Y: V(i, q) read as vᵀ's rows
    vt = v.T.contiguous()
    upd = [_ordered_product(vt, y, lo, hi) for lo, hi in
           _split_ranges(nb, _splits_for(rows, cols, nb))]
    win -= _in_order(upd)
    return out


def _panel(m, n, nb, k, seed):
    """A Gaussian A/√m with its panel at column k factored by the port's
    panel QR (float32, CPU), that panel's active V and its T."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.standard_normal((m, n)) / m ** 0.5,
                     dtype=torch.float32)
    pan = a[k:, k:k + nb]
    taus = qr._panel_qr(pan)
    v = qr._panel_v(pan)
    return a, v, qr._form_t(v, taus)


def _hold_update(got, want, a):
    change = float((want - a).abs().max())
    assert change > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * change)


# (m, n, nb, k): W split into 4 parts (R = 2100 over 1 tile), W unsplit
# (R < 1024), and a ragged window that is not 16-byte aligned (n = 250)
QR_CASES = [(2100, 256, 128, 0), (600, 256, 64, 64), (1000, 250, 10, 20)]


@pytest.mark.parametrize("m,n,nb,k", QR_CASES)
def test_qr_update_order_matches_the_pallas_kernel(m, n, nb, k):
    jnp, _, jqr_fused = _pallas()
    a, v, t = _panel(m, n, nb, k, seed=m + k)
    v_full = torch.zeros(m, nb)
    v_full[k:] = v
    want = torch.tensor(np.asarray(jqr_fused.qr_panel_update(
        jnp.asarray(a.numpy()), jnp.asarray(v_full.numpy()),
        jnp.asarray(t.numpy()), k, nb=nb, interpret=True)))
    got = emulate_qr_update(a, v, t, k, nb)
    assert torch.equal(got[:, :k + nb], a[:, :k + nb])
    _hold_update(got, want, a)


def test_qr_update_split_counts_follow_the_sm_count():
    """The main path's parts at m = 32768, n = 8192, nb = 128: W in 4
    at k = 0 (63 tiles, 252 blocks), 8 at k = 4096, and at k = 7936 48
    splits of 544 depths, of which 46 hold any; the update's K = 128 never
    split."""
    for k, parts in ((0, 4), (4096, 8), (7936, 46)):
        rows, cols = 32768 - k, 8192 - k - 128
        assert len(_split_ranges(rows, _splits_for(128, cols, rows))) == \
            parts
        assert _splits_for(rows, cols, 128) == 1
    # nb deep and the tiles few: the update's K is split in two
    assert len(_split_ranges(1024, _splits_for(2048, 1024, 1024))) == 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# the main path's steps at m = 32768, n = 8192, nb = 128, QR_CASES, and an
# update whose depth nb = 1024 is split
QR_PLAN_CASES = [(32768, 8192, 128, k) for k in (0, 4096, 7936, 8064)] + \
    QR_CASES + [(2048, 2048, 1024, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,nb,k", QR_PLAN_CASES)
def test_qr_update_split_counts_match_the_built_kernel(m, n, nb, k):
    """The emulation's parts are the kernel's on this card (the emulation
    assumes an H100's 132 SMs)."""
    dev = _card()
    if torch.cuda.get_device_properties(dev).multi_processor_count != SMS:
        pytest.skip(f"the emulation's split counts are an H100's ({SMS} SMs)")
    rows, cols = m - k, n - k - nb
    want = (0, 0) if cols == 0 else (
        len(_split_ranges(rows, _splits_for(nb, cols, rows))),
        len(_split_ranges(nb, _splits_for(rows, cols, nb))))
    assert qr_fused.plan_parts(m, n, k, nb, dev) == want


@pytest.mark.parametrize("m,n,nb,k", [(1000, 250, 10, 20),
                                      (1100, 390, 13, 13)])
def test_qr_emulation_matches_the_plain_version_on_a_ragged_size(m, n, nb,
                                                                 k):
    """Ragged windows (N = 220, 364 columns; R = 980, 1087 rows), against
    the port's plain update."""
    a, v, t = _panel(m, n, nb, k, seed=7)
    want = ref.qr_panel_update(a.clone(), v, t, k, nb=nb)
    _hold_update(emulate_qr_update(a, v, t, k, nb), want, a)


# --------------------------------------------------------------------------
# kernel 3
# --------------------------------------------------------------------------

def _gram_blocks(k, n):
    """``gram_stream_blocks``: one block per 256 quads, at most two an SM
    (one above k = 10)."""
    quads = -(-n // 4)
    return min(-(-quads // THREADS), (2 if k <= 10 else 1) * SMS)


def emulate_gram(v):
    """Kernel 3's order of sums for a (k, n) float32 V, k ≤ 16."""
    k, n = v.shape
    quads = -(-n // 4)
    blocks = _gram_blocks(k, n)
    grid = blocks * THREADS
    rounds = -(-quads // grid)
    x = torch.zeros(k, rounds * grid * 4)
    x[:, :n] = v                     # zero columns add exact zeros
    x = x.view(k, rounds, grid, 4)
    iu = torch.triu_indices(k, k)    # the upper triangle, row by row
    acc = torch.zeros(grid, iu.shape[1])
    for r in range(rounds):          # thread t: quads t, t + grid, ...
        for c in range(4):
            col = x[:, r, :, c]
            acc = _fma(acc, col[iu[0]].T, col[iu[1]].T)
    lanes = acc.view(blocks, THREADS // 32, 32, -1)
    for off in (16, 8, 4, 2, 1):     # __shfl_down_sync tree, lane 0 keeps
        lanes = lanes[:, :, :off] + lanes[:, :, off:2 * off]
    block = _in_order(list(lanes[:, :, 0].unbind(1)))   # warps in order
    total = _in_order(list(block.unbind(0)))            # blocks in order
    g = torch.zeros(k, k)
    g[iu[0], iu[1]] = total
    g[iu[1], iu[0]] = total
    return g


def _hold_gram(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# (k, n): the s-step path's k = 5 and 9 at n = 16384 (16 blocks) and
# 64³ (256 blocks, one quad a thread), k = 9 over 2²⁰ (264 blocks, four
# quads a thread), and k = 16 (132 blocks)
GRAM_CASES = [(5, 16384), (9, 16384), (5, 64 ** 3), (9, 1 << 20),
              (16, 300000)]


@pytest.mark.parametrize("k,n", GRAM_CASES)
def test_gram_order_matches_the_pallas_kernel(k, n):
    jnp, jkrylov_fused, _ = _pallas()
    v = np.random.default_rng(k * 31 + n).standard_normal((k, n)) \
        .astype(np.float32)
    want = torch.tensor(np.asarray(jkrylov_fused.fused_gram_auto(
        jnp.asarray(v), interpret=True)))
    got = emulate_gram(torch.from_numpy(v))
    assert torch.equal(got, got.T)
    _hold_gram(got, want)


@pytest.mark.parametrize("n", [4 * 70000 + 1, 4 * 70000 + 2, 4 * 70000 + 3,
                               127])
@pytest.mark.parametrize("k", [1, 9])
def test_gram_emulation_matches_the_plain_version_on_a_ragged_size(k, n):
    """n ≡ 1, 2, 3 (mod 4): the last quad's missing columns are zeros."""
    v = torch.from_numpy(np.random.default_rng(n).standard_normal((k, n))
                         .astype(np.float32))
    _hold_gram(emulate_gram(v), ref.fused_gram(v))


def test_gram_block_counts_are_a_function_of_the_shape():
    assert _gram_blocks(9, 16384) == 16
    assert _gram_blocks(5, 64 ** 3) == 256
    assert _gram_blocks(9, 128 ** 3) == 264
    assert _gram_blocks(11, 128 ** 3) == 132
    assert _gram_blocks(9, 1) == 1


# the s-step main path's k = 5, 9 at n = 16384, 64³ and 128³, GRAM_CASES,
# and the smallest V
GRAM_PLAN_CASES = [(k, n) for k in (5, 9) for n in (16384, 64 ** 3,
                                                    128 ** 3)] + \
    GRAM_CASES + [(9, 1), (11, 128 ** 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", GRAM_PLAN_CASES)
def test_gram_block_counts_match_the_built_kernel(k, n):
    """The emulation's grid is the one-launch kernel's (a function of the
    shape alone, fixed for an H100's 132 SMs)."""
    _card()
    assert krylov_fused._lib().krylov_gram_stream_blocks(k, n) == \
        _gram_blocks(k, n)
