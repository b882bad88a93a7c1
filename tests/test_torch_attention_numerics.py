"""The arithmetic of the tensor-core attention kernel against :mod:`repro`
on the CPU.

``csrc/attention_wgmma.cu`` runs only on the card, so this file holds an
emulation of its arithmetic in plain torch, step for step: q, k and v in
bf16 / fp16; S accumulated in float32 over 16-wide steps of D; the online
softmax over the kernel's 64-key tiles in base 2 (the kernel's exp2 is the
special-function unit's, within 2 ulp of ``torch.exp2``), with liveness on
the reference's 128-tiles and the warpgroups' exact skips; P fed to P·V as
three bf16 terms (fp16: two fp16 terms of P·2¹⁵), each 16-key step and
term added in the kernel's order; one rounding at the end.  The emulation
is held against the Pallas kernel in interpret mode on the float32 values
of the same inputs, under the gate the card holds the kernel to
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3f): element by
element within one rounding of the output type (2⁻⁸ bf16, 2⁻¹¹ fp16) of
|o| plus 1e-5.  One case pins why P is split: the same emulation with P
rounded once to bf16 misses that gate.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels import attention as jattn

# the gate of tests/test_torch_cuda.py and chip_smoke.py, unchanged
ATTENTION_ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
ATTENTION_F32_SLACK = 1e-5

ROWS, KEYS, TILE, KSTEP = 128, 64, 128, 16   # CTA rows, key tile, ref tile
NEG_INF = -1e30                              # the reference's _NEG_INF
HALF_SCALE = 2.0 ** 15


def _split(p: torch.Tensor, dtype, terms: int) -> list[torch.Tensor]:
    """p (float32) as ``terms`` values of ``dtype``, each the rounding of
    what the earlier ones leave (the residuals are exact in float32)."""
    out, rest = [], p
    for _ in range(terms):
        t = rest.to(dtype)
        out.append(t)
        rest = rest - t.float()
    return out


def _emulate(q, k, v, *, causal=True, window=None, terms=None):
    """The kernel's arithmetic; returns its output in q's dtype."""
    dtype = q.dtype
    half = dtype == torch.float16
    terms = terms or (2 if half else 3)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale_log2 = np.float32(d ** -0.5 * math.log2(math.e))
    qf = q.float()
    kf = k.repeat_interleave(group, 1).float()
    vf = v.repeat_interleave(group, 1).float()
    s = torch.zeros(b, hq, tq, tk)
    for d0 in range(0, d, KSTEP):                # float32 sums, 16 at a time
        s = s + torch.einsum("bhqd,bhkd->bhqk", qf[..., d0:d0 + KSTEP],
                             kf[..., d0:d0 + KSTEP])
    x = s * float(scale_log2)

    q_offset = tk - tq
    bq, bk = min(TILE, tq), min(TILE, tk)
    qpos = torch.arange(tq)[:, None] + q_offset
    kpos = torch.arange(tk)[None, :]
    visible = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        visible &= kpos <= qpos
    if window is not None:
        visible &= kpos > qpos - window
    x = torch.where(visible, x, torch.tensor(NEG_INF))

    m = torch.full((b, hq, tq), NEG_INF)
    l = torch.zeros(b, hq, tq)
    acc = torch.zeros(b, hq, tq, d)
    for key0 in range(0, tk, KEYS):
        keys = slice(key0, min(key0 + KEYS, tk))
        key_last = keys.stop - 1
        first_k = (key0 // bk) * bk
        active = torch.zeros(tq, dtype=torch.bool)
        for row0 in range(0, tq, ROWS):
            first_q = row0 + q_offset                # the reference's tile
            last_q = first_q + bq - 1
            if causal and first_k > last_q:
                continue
            if window is not None and first_k + bk - 1 <= first_q - window:
                continue
            for w0 in range(row0, min(row0 + ROWS, tq), 64):   # warpgroups
                wg_first = w0 + q_offset
                wg_last = wg_first + 63
                dead = (causal and key0 > wg_last) or (
                    window is not None and key_last <= wg_first - window)
                if not (dead and (not causal or wg_first >= 0)):
                    active[w0:w0 + 64] = True
        if not active.any():
            continue
        xt = x[..., keys]
        m_new = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None]
        pin = p * HALF_SCALE if half else p
        for k0 in range(0, p.shape[-1], KSTEP):  # 16 keys a wgmma step
            vt = vf[..., key0 + k0:key0 + k0 + KSTEP, :]
            for t in _split(pin[..., k0:k0 + KSTEP], dtype, terms):
                acc_new = acc_new + t.float() @ vt
        m = torch.where(active, m_new, m)
        l = torch.where(active, l_new, l)
        acc = torch.where(active[:, None], acc_new, acc)
    if half:
        acc = acc / HALF_SCALE
    return (acc / torch.where(l == 0, 1.0, l)[..., None]).to(dtype)


def _inputs(seed, b, hq, hkv, tq, tk, d, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _pallas_f32(q, k, v, **kw):
    """The Pallas kernel in interpret mode on the float32 values of the
    16-bit inputs."""
    got = jattn.flash_attention(*(x.float().numpy() for x in (q, k, v)),
                                interpret=True, **kw)
    return torch.from_numpy(np.array(got, np.float32))


def _worst_share(got, want):
    """The largest |got − want| over the gate's limit."""
    err = (got.float() - want).abs()
    limit = ATTENTION_ROUNDING[got.dtype] * want.abs() + ATTENTION_F32_SLACK
    return float((err / limit).max())


# (label, B, Hq, Hkv, Tq, Tk, D, causal, window, dtype)
CASES = [
    ("causal-g1-d64-bf16", 1, 2, 2, 512, 512, 64, True, None, torch.bfloat16),
    ("full-g2-d128-bf16", 1, 4, 2, 512, 512, 128, False, None,
     torch.bfloat16),
    ("window-g8-d64-bf16", 1, 8, 1, 512, 512, 64, True, 128, torch.bfloat16),
    ("decode-offset-g2-d112-bf16", 1, 4, 2, 128, 512, 112, True, None,
     torch.bfloat16),
    ("causal-g8-d112-bf16", 1, 8, 1, 512, 512, 112, True, None,
     torch.bfloat16),
    ("causal-g2-d128-fp16", 1, 4, 2, 512, 512, 128, True, None,
     torch.float16),
    ("full-g1-d64-fp16", 1, 2, 2, 512, 512, 64, False, None, torch.float16),
    ("window-g8-d112-fp16", 1, 8, 1, 512, 512, 112, True, 200,
     torch.float16),
    ("decode-offset-g1-d128-fp16", 1, 2, 2, 128, 512, 128, True, None,
     torch.float16),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_arithmetic_holds_the_one_rounding_gate(case):
    _, b, hq, hkv, tq, tk, d, causal, window, dtype = case
    q, k, v = _inputs(sum(map(ord, case[0])), b, hq, hkv, tq, tk, d, dtype)
    kw = {"causal": causal, "window": window}
    got = _emulate(q, k, v, **kw)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert _worst_share(got, _pallas_f32(q, k, v, **kw)) <= 1.0


def test_one_bf16_rounding_of_p_misses_the_gate():
    """Why P is split: the same arithmetic with P rounded once to bf16 (as
    a one-term tensor-core kernel does) misses the gate many times over,
    while three terms hold it on the same inputs."""
    q, k, v = _inputs(7, 1, 4, 2, 512, 512, 128, torch.bfloat16)
    want = _pallas_f32(q, k, v, causal=True)
    assert _worst_share(_emulate(q, k, v, terms=1), want) > 10.0
    assert _worst_share(_emulate(q, k, v), want) <= 1.0


@pytest.mark.parametrize("dtype,terms,scale,rel", [
    (torch.bfloat16, 3, 1.0, 0.0),
    (torch.float16, 2, HALF_SCALE, 2.0 ** -22 * (1 + 2.0 ** -10))])
def test_p_terms_carry_what_the_kernel_claims(dtype, terms, scale, rel):
    """bf16: three terms carry every bit of a float32 p in [2⁻⁴⁰, 1]; fp16:
    two terms of p·2¹⁵ carry 22 bits of p from 2⁻¹⁷ up, and lose at most
    2⁻³⁹ more below (where the second term is an fp16 subnormal)."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.exp2(rng.uniform(-40, 0, 100_000))
                         .astype(np.float32))
    total = sum(t.double() for t in _split(p * scale, dtype, terms)) / scale
    err = (total - p.double()).abs()
    normal = p >= 2.0 ** -17
    assert float((err[normal] / p.double()[normal]).max()) <= rel
    assert bool((err <= rel * p.double() + 2.0 ** -39).all())
