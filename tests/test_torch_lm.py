"""The port's dense transformer serving path against :mod:`repro` on the CPU.

The same numpy arrays go through both packages: attention's plain version
against the Pallas kernel in interpret mode, each path of
``attention_core``, the layer functions, and ``forward`` / ``prefill`` /
``decode_step`` of the REDUCED qwen3-1.7b and tinyllama-1.1b configs with
the reference's weights carried across by
``interop.transformer_params_from_numpy``.

Tolerances: float32 1e-4 (``tests/test_kernels.py``'s attention bar; the
sums run in another order); bfloat16 5e-2 (``tests/test_models.py``'s bar:
the two frameworks round bf16 at other places); bfloat16 attention paths
2e-2 of max|o| (one or two bf16 roundings of intermediate values).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.base import get_config as jget_config
from repro.kernels import attention as jattn
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro_torch import interop, runtime
from repro_torch.configs.base import get_config
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import registry as treg
from repro_torch.models import transformer as TT

F32_TOL = 1e-4
BF16_TOL = 5e-2


def _arrays(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _qkv(seed, b, hq, hkv, tq, tk, d):
    return _arrays(seed, (b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------
# kernel 10's plain version against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_pallas_gqa(hq, hkv, causal):
    q, k, v = _qkv(4, 2, hq, hkv, 256, 256, 64)
    want = jattn.flash_attention(q, k, v, causal=causal, interpret=True)
    got = tref.attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("case", ["window", "decode_offset"])
def test_plain_attention_matches_pallas_window_and_offset(case):
    if case == "window":
        q, k, v = _qkv(5, 1, 2, 2, 256, 256, 64)
        kw = {"causal": True, "window": 128}
    else:
        q, k, v = _qkv(6, 1, 2, 2, 128, 512, 64)
        kw = {"causal": True}
    want = jattn.flash_attention(q, k, v, interpret=True, **kw)
    got = ops.flash_attention(_t(q), _t(k), _t(v), **kw)   # CPU: plain
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               _np(jref.attention(q, k, v, **kw)),
                               rtol=F32_TOL, atol=F32_TOL)


def test_rows_without_a_visible_key_tq_above_tk():
    """Causal with Tq > Tk: the first Tq − Tk rows see no key.  The Pallas
    kernel (and the CUDA kernel, held in ``test_torch_cuda.py``) returns 0
    for rows whose tiles are all skipped and the mean of the live tile's
    values for rows masked inside a live tile; both plain versions return
    NaN there.  Every other row agrees."""
    for (tq, tk), seed in (((256, 128), 7), ((128, 64), 8)):
        q, k, v = _qkv(seed, 1, 2, 1, tq, tk, 16)
        pallas = _np(jattn.flash_attention(q, k, v, causal=True,
                                           interpret=True))
        plain = tref.attention(_t(q), _t(k), _t(v), causal=True).numpy()
        dead = tq - tk
        assert np.isnan(plain[:, :, :dead]).all()
        assert np.isnan(_np(jref.attention(q, k, v, causal=True))[
            :, :, :dead]).all()
        np.testing.assert_allclose(plain[:, :, dead:], pallas[:, :, dead:],
                                   rtol=F32_TOL, atol=F32_TOL)
        if tq == 256:       # bq = bk = 128: the first q tile is skipped
            assert (pallas[:, :, :dead] == 0).all()
        else:               # bq = 128, bk = 64: one live tile of 64 keys
            np.testing.assert_allclose(
                pallas[0, :, :dead],
                np.broadcast_to(v[0, :, None].mean(axis=2), (2, dead, 16)),
                rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_contract_on_the_cpu():
    q, k, v = (_t(a) for a in _qkv(9, 1, 4, 2, 256, 256, 16))
    with pytest.raises(ValueError, match="not tiled"):
        tattn.flash_attention(q[:, :, :200], k, v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 128, 264)
        tattn.flash_attention(big, big, big)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tattn.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="requires grad"):
        tattn.flash_attention(q.requires_grad_(), k, v)
    before = tattn.LAUNCHES["flash_attention"]
    tattn.flash_attention(q.detach(), k, v)
    assert tattn.LAUNCHES["flash_attention"] == before   # no launch on CPU


# --------------------------------------------------------------------------
# attention_core: each of its four paths against the reference's
# --------------------------------------------------------------------------

# (name, B, Hq, Hkv, T, D, window, force): "kernel" forces the kernel path
# (on the CPU the plain version; the reference's Pallas kernel in interpret
# mode), the others take the length rules of both packages
CORE_PATHS = [
    ("kernel", 2, 4, 2, 256, 16, None, True),
    ("dense", 2, 4, 2, 256, 16, None, None),
    ("banded", 1, 2, 1, 4096, 16, 1024, None),
    ("chunked", 1, 2, 1, 3072, 16, None, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", CORE_PATHS, ids=[c[0] for c in CORE_PATHS])
def test_attention_core_paths_match_reference(path, dtype, monkeypatch):
    name, b, hq, hkv, t, d, window, force = path
    q, k, v = _qkv(10, b, hq, hkv, t, t, d)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    taken = []
    for fn in ("_dense_attention", "_window_banded_jnp", "_flash_jnp"):
        real = getattr(TL, fn)
        monkeypatch.setattr(TL, fn, lambda *a, _r=real, _n=fn, **kw:
                            (taken.append(_n), _r(*a, **kw))[1])
    real_ops = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw:
                        (taken.append("kernel"), real_ops(*a, **kw))[1])
    with jrt.force_pallas(force), runtime.force_kernel(force):
        want = JL.attention_core(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                 causal=True, window=window)
        got = TL.attention_core(*(_t(a, td) for a in (q, k, v)),
                                causal=True, window=window)
    expect = {"kernel": "kernel", "dense": "_dense_attention",
              "banded": "_window_banded_jnp", "chunked": "_flash_jnp"}[name]
    assert taken == [expect]
    assert got.dtype == td
    want = _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


# --------------------------------------------------------------------------
# the layer functions
# --------------------------------------------------------------------------

def test_rope_and_norms_match_reference():
    cfg = jget_config("qwen3-1.7b", reduced=True)
    (x,) = _arrays(11, (2, 4, 64, 16))
    for theta in (10_000.0, 1_000_000.0):
        for pos in (np.arange(64), np.arange(128).reshape(2, 64)):
            want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
            got = TL.apply_rope(_t(x), torch.from_numpy(pos), theta)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                                       atol=F32_TOL)
    (h, scale, bias) = _arrays(12, (2, 8, 64), (64,), (64,))
    for norm in ("rms", "layer"):
        c = dataclasses.replace(cfg, norm=norm)
        jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        tp = {"scale": _t(scale), "bias": _t(bias)}
        for dtype in ("float32", "bfloat16"):
            want = JL.apply_norm(jp, jnp.asarray(h, dtype), c)
            got = TL.apply_norm(tp, _t(h, getattr(torch, dtype)), c)
            tol = F32_TOL if dtype == "float32" else 1e-2
            np.testing.assert_allclose(got.float().numpy(), _np(want),
                                       rtol=tol, atol=tol)
    want = JL._rms_head(jnp.asarray(x), jnp.asarray(scale[:16]))
    got = TL._rms_head(_t(x), _t(scale[:16]))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               act_dtype="float32")


def _attn_params(cfg):
    jp = jax.tree.map(np.asarray, JL.init_attention(cfg, jax.random.key(3)))
    tp = TL.Params({n: torch.from_numpy(np.array(a)) for n, a in jp.items()})
    return jp, tp


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "tinyllama-1.1b"])
def test_attention_fwd_and_decode_attention_match_reference(arch):
    cfg = _f32(jget_config(arch, reduced=True))
    jp, tp = _attn_params(cfg)
    (x,) = _arrays(13, (2, 128, cfg.d_model))
    pos = np.arange(128)
    want, (wk, wv) = JL.attention_fwd(jp, jnp.asarray(x), cfg,
                                      positions=jnp.asarray(pos))
    with torch.inference_mode():
        got, (gk, gv) = TL.attention_fwd(tp, _t(x), cfg,
                                         positions=torch.from_numpy(pos))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=F32_TOL,
                                   atol=F32_TOL)

    # one decode step into a cache of 16 slots holding 9 earlier positions
    hd, c = cfg.resolved_head_dim, 16
    ck, cv = _arrays(14, (2, cfg.num_kv_heads, c, hd),
                     (2, cfg.num_kv_heads, c, hd))
    cpos = np.concatenate([np.arange(9), -np.ones(c - 9)]).astype(np.int32)
    (xt,) = _arrays(15, (2, 1, cfg.d_model))
    for window in (None, 4):
        want, wc = JL.decode_attention(
            jp, jnp.asarray(xt), {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                                  "pos": jnp.asarray(cpos)}, cfg,
            index=jnp.asarray(9, jnp.int32), window=window)
        cache = {"k": _t(ck), "v": _t(cv), "pos": torch.from_numpy(cpos)}
        got, gc = TL.decode_attention(tp, _t(xt), cache, cfg, index=9,
                                      window=window)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(gc[key].numpy(), _np(wc[key]),
                                       rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


# --------------------------------------------------------------------------
# the model: forward, prefill, decode_step
# --------------------------------------------------------------------------

def _models(arch, dtype):
    jcfg = jget_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    if dtype == "float32":
        jcfg, tcfg = _f32(jcfg), _f32(tcfg)
    jp = jreg.init_params(jcfg, jax.random.key(1))
    tp = interop.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "tinyllama-1.1b"])
def test_forward_prefill_decode_match_reference(arch, dtype):
    jcfg, jp, tcfg, tp = _models(arch, dtype)
    rng = np.random.default_rng(16)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    want = jreg.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got = treg.forward(tp, {"tokens": tt}, tcfg)
    assert got.shape == (2, 12, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    _close(got, want, dtype)
    last = treg.forward(tp, {"tokens": tt}, tcfg, last_only=True)
    _close(last, jreg.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                              last_only=True), dtype)

    # prefill 8 tokens into a 12-slot cache, then decode 4
    jl, js = JT.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jcfg,
                        cache_len=12)
    tl, ts = TT.prefill(tp, {"tokens": tt[:, :8]}, tcfg, cache_len=12)
    _close(tl, jl, dtype)
    for key in ("k", "v"):
        _close(ts[key].float(), js[key], dtype)
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    for i in range(8, 12):
        jl, js = jreg.decode_step(jp, js, jnp.asarray(toks[:, i]),
                                  jnp.asarray(i, jnp.int32), jcfg)
        tl, ts = treg.decode_step(tp, ts, tt[:, i], i, tcfg)
        _close(tl, jl, dtype)
    for key in ("k", "v"):
        _close(ts[key].float(), js[key], dtype)
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "tinyllama-1.1b"])
def test_decode_matches_forward_in_the_port(arch):
    """Token-by-token decode logits == full forward logits (same tokens),
    at the reference's bar, from an empty decode state and after a prefill
    that goes through the kernel path (forced; the plain version here)."""
    cfg = get_config(arch, reduced=True)
    model = treg.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 256)))
    with runtime.force_kernel(True):
        full = treg.forward(model, {"tokens": toks}, cfg)
        _, state = TT.prefill(model, {"tokens": toks[:, :128]}, cfg,
                              cache_len=256)
    got = [treg.decode_step(model, state, toks[:, i], i, cfg)[0]
           for i in range(128, 136)]
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               full[:, 128:136].numpy(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    state = treg.init_decode_state(model, cfg, 2, 8)
    got = [treg.decode_step(model, state, toks[:, i], i, cfg)[0]
           for i in range(8)]
    np.testing.assert_allclose(
        torch.stack(got, 1).numpy(),
        treg.forward(model, {"tokens": toks[:, :8]}, cfg).numpy(),
        rtol=BF16_TOL, atol=BF16_TOL)


def test_configs_and_registry():
    for arch in ("qwen3-1.7b", "codeqwen1.5-7b", "tinyllama-1.1b",
                 "minicpm-2b"):
        for reduced in (False, True):
            jc, tc = jget_config(arch, reduced), get_config(arch, reduced)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert tc.param_count() == jc.param_count()
            assert tc.padded_vocab == jc.padded_vocab
    cfg = get_config("qwen3-1.7b")
    assert (cfg.padded_vocab, cfg.resolved_head_dim) == (152_064, 128)
    with pytest.raises(NotImplementedError, match="item 12"):
        get_config("mamba2-780m")
    moe = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                              family="moe")
    with pytest.raises(NotImplementedError, match="item 12"):
        treg.init_params(moe, torch.Generator(), device="cpu")
    # init_params: the reference's tree, shapes and dtypes
    small = get_config("minicpm-2b", reduced=True)
    model = treg.init_params(small, torch.Generator().manual_seed(0),
                             device="cpu")
    ref_tree = jax.eval_shape(lambda: jreg.init_params(
        jget_config("minicpm-2b", reduced=True), jax.random.key(0)))
    assert model["embed"]["embedding"].shape == \
        ref_tree["embed"]["embedding"].shape
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(ref_tree))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert not any(p.requires_grad for p in model.parameters())
