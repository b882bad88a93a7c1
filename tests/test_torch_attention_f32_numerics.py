"""The arithmetic of the float32 attention kernel against :mod:`repro` on
the CPU.

``csrc/attention.cu`` runs only on the card, so this file holds an
emulation of its order of operations in plain float32 torch: S = Q·Kᵀ
summed over ascending depth; the online softmax over its key tiles of 128
(the reference's ``bk``), applied to a row only where the reference's
(row tile, key tile) pair is live; the scores scaled, masked to −1e30, the
row's max taken over the keys that exist; ``p = exp(s − m)``; a row's sum
as the kernel forms it (each of the row's 16 threads keeps its part of
``l``: rescaled by ``exp(m_old − m)``, plus its 8 keys' ``p`` in order, at
each tile; a xor tree over the 16 parts at the end); O rescaled, then P·V
summed over ascending keys; the final division by ``l`` (1 where ``l`` is
0).  The emulation is held
against the Pallas kernel in interpret mode at the gate the card holds the
kernel to (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3f):
rtol = atol = 1e-4.  The kernel walks the live key tiles of a row tile as
one interval; a test checks that the reference's skips always leave one.
"""
import numpy as np
import pytest
import torch

from repro.kernels import attention as jattn

TILE = 128          # the kernel's row and key tiles, the reference's bq, bk
NEG_INF = -1e30     # the reference's _NEG_INF
THREADS_A_ROW = 16  # a row's scores are spread over 16 threads, 8 each


def _live(row0, key0, tq, tk, causal, window) -> bool:
    """Whether the reference computes the tile of rows from ``row0`` and
    keys from ``key0`` (its skip test, on its tiles min(128, T))."""
    bq, bk = min(TILE, tq), min(TILE, tk)
    first_q = row0 + tk - tq
    last_q = first_q + bq - 1
    first_k = (key0 // bk) * bk
    if causal and first_k > last_q:
        return False
    return window is None or first_k + bk - 1 > first_q - window


def _thread_sums(p: torch.Tensor) -> torch.Tensor:
    """The 16 threads' sums of a key tile's p (at most 128 keys, last
    axis): thread tx adds keys 4tx .. 4tx + 3, then 64 + 4tx .., from 0."""
    p = torch.nn.functional.pad(p, (0, TILE - p.shape[-1]))
    quads = p.unflatten(-1, (2, THREADS_A_ROW, 4))   # [half][tx][e]
    part = torch.zeros(p.shape[:-1] + (THREADS_A_ROW,))
    for half in range(2):
        for e in range(4):
            part = part + quads[..., half, :, e]
    return part


def _xor_tree(part: torch.Tensor) -> torch.Tensor:
    """The 16 threads' parts (last axis) added by xor shuffles 8, 4, 2, 1."""
    lanes = torch.arange(THREADS_A_ROW)
    for off in (8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    return part[..., 0]


def _emulate(q, k, v, *, causal=True, window=None):
    """The float32 kernel's order of operations (float32 throughout)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = np.float32(d ** -0.5)
    kf = k.repeat_interleave(group, 1)
    vf = v.repeat_interleave(group, 1)
    s = torch.zeros(b, hq, tq, tk)
    for e in range(d):                           # ascending depth
        s = s + q[..., e, None] * kf[..., None, :, e]
    x = s * float(scale)
    qpos = torch.arange(tq)[:, None] + (tk - tq)
    kpos = torch.arange(tk)[None, :]
    visible = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        visible &= kpos <= qpos
    if window is not None:
        visible &= kpos > qpos - window
    x = torch.where(visible, x, torch.tensor(NEG_INF))

    m = torch.full((b, hq, tq), NEG_INF)
    l = torch.zeros(b, hq, tq, THREADS_A_ROW)       # the threads' parts
    acc = torch.zeros(b, hq, tq, d)
    for key0 in range(0, tk, TILE):
        active = torch.zeros(tq, dtype=torch.bool)
        for row0 in range(0, tq, TILE):
            if _live(row0, key0, tq, tk, causal, window):
                active[row0:row0 + TILE] = True
        if not active.any():
            continue
        xt = x[..., key0:key0 + TILE]
        m_new = torch.maximum(m, xt.amax(-1))
        p = torch.exp(xt - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = alpha[..., None] * l + _thread_sums(p)
        acc_new = acc * alpha[..., None]
        for j in range(p.shape[-1]):             # ascending keys
            acc_new = acc_new + p[..., j, None] * vf[..., None, key0 + j, :]
        m = torch.where(active, m_new, m)
        l = torch.where(active[:, None], l_new, l)
        acc = torch.where(active[:, None], acc_new, acc)
    l = _xor_tree(l)
    return acc / torch.where(l == 0, 1.0, l)[..., None]


def _inputs(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


def _pallas(q, k, v, **kw):
    got = jattn.flash_attention(*(x.numpy() for x in (q, k, v)),
                                interpret=True, **kw)
    return torch.from_numpy(np.array(got, np.float32))


# (label, B, Hq, Hkv, Tq, Tk, D, causal, window)
CASES = [
    ("causal-g2-d128", 1, 4, 2, 384, 384, 128, True, None),
    ("full-g1-d64", 1, 2, 2, 256, 256, 64, False, None),
    ("window-g4-d64", 1, 4, 1, 512, 512, 64, True, 200),
    ("decode-offset-g2-d128", 1, 4, 2, 128, 512, 128, True, None),
    ("no-visible-key-dead-tile", 1, 2, 1, 256, 128, 16, True, None),
    ("no-visible-key-live-tile", 1, 2, 1, 128, 64, 16, True, None),
    ("causal-g2-d112", 1, 4, 2, 256, 256, 112, True, None),
    ("full-g4-d112", 2, 8, 2, 128, 128, 112, False, None),
    ("short-causal-d32", 1, 4, 4, 100, 100, 32, True, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_holds_the_float32_gate(case):
    label, b, hq, hkv, tq, tk, d, causal, window = case
    q, k, v = _inputs(sum(map(ord, label)), b, hq, hkv, tq, tk, d)
    kw = {"causal": causal, "window": window}
    got = _emulate(q, k, v, **kw)
    want = _pallas(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_rows_without_a_visible_key_follow_the_reference():
    """Causal with Tq > Tk: rows of a dead tile are 0, rows masked inside a
    live tile the mean of its values, in the emulation as in Pallas."""
    q, k, v = _inputs(5, 1, 2, 1, 256, 128, 16)
    assert bool((_emulate(q, k, v)[:, :, :128] == 0).all())
    q, k, v = _inputs(6, 1, 2, 1, 128, 64, 16)
    got = _emulate(q, k, v)[:, :, :64]
    want = v.mean(dim=2, keepdim=True).expand(1, 2, 64, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_live_key_tiles_form_one_interval():
    """The kernel walks a row tile's live key tiles as t_lo .. t_hi: the
    reference's causal skip ends them and its window skip takes a prefix,
    so for every row tile the live tiles are one run."""
    for tq, tk in ((128, 128), (2048, 2048), (1920, 1920), (128, 2048),
                   (256, 128), (100, 100), (4096, 4096)):
        for causal, window in ((True, None), (False, None), (True, 1024),
                               (True, 200), (False, 300)):
            for row0 in range(0, tq, TILE):
                live = [t for t in range(-(-tk // TILE))
                        if _live(row0, t * TILE, tq, tk, causal, window)]
                if live:
                    assert live == list(range(live[0], live[-1] + 1))
