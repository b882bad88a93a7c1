"""Building blocks of the dense transformer (port of
:mod:`repro.models.layers`).

Parameters live in :class:`Params`, an ``nn.Module`` that is read like the
reference's dict (``p["wq"]``, ``"q_norm" in p``), so the apply functions
keep the reference's names and signatures.  Parameters need no gradient:
the ported path serves (the training slice is ROADMAP item 12).  Attention
has four execution paths, chosen as the reference chooses them:

* the flash-attention kernel (:func:`repro_torch.kernels.ops.flash_attention`)
  when ``runtime.use_kernel`` is on (CUDA tensors, by default) and both
  lengths are multiples of 128;
* dense masked attention up to ``dense_threshold`` positions;
* the banded sliding-window path;
* the chunked flash path in plain tensor code, O(qc·kc) live memory.

Layouts: activations (B, S, d); attention heads (B, H, S, head_dim).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import runtime
from repro_torch.configs.base import ModelConfig

_NEG = -1e30


class Params(nn.Module):
    """A named group of tensors and sub-groups, read like a dict."""

    def __init__(self, items: dict):
        super().__init__()
        for name, item in items.items():
            if isinstance(item, nn.Module):
                self.add_module(name, item)
            else:
                self.register_parameter(
                    name, nn.Parameter(item, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def dtype_of(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    return getattr(torch, cfg.param_dtype if kind == "param"
                   else cfg.act_dtype)


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal float32 draws from ``generator``, on ``device``."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int | None = None, *, device) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones(d, dtype=dtype_of(cfg), device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros(d, dtype=dtype_of(cfg), device=device)
    return Params(p)


def apply_norm(p, x, cfg: ModelConfig, eps: float | None = None):
    eps = eps or cfg.rms_eps
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def _rms_head(x, scale, eps=1e-6):
    """Per-head rmsnorm (qk_norm), x (..., head_dim)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embedding
# --------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (B, H, S, D), positions (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    angles = positions.float()[..., None] * freq     # (S,half) or (B,S,half)
    if angles.ndim == 2:
        angles = angles[None, None, :, :]               # (1,1,S,half)
    else:
        angles = angles[:, None, :, :]                  # (B,1,S,half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention core
# --------------------------------------------------------------------------

def _positions_mask(qpos, kpos, *, causal, window):
    mask = torch.ones(qpos.shape[0], kpos.shape[-1], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _dense_attention(q, k, v, *, causal, window, scale):
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = _positions_mask(qpos, kpos, causal=causal, window=window)
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, tq, d).to(q.dtype)


def _chunk_of(t: int, target: int) -> int:
    """Largest divisor of t that is <= target (chunked attention tiling)."""
    c = min(target, t)
    while t % c:
        c -= 1
    return c


def _flash_jnp(q, k, v, *, causal, window, scale, q_chunk=512,
               k_chunk=1024):
    """Chunked flash attention in plain tensor code: O(qc·kc) live memory.
    The operands keep their dtype and the products accumulate in float32,
    as the reference's bf16 einsums with float32 accumulation."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    qc = _chunk_of(tq, q_chunk)
    kc = _chunk_of(tk, k_chunk)
    off = tk - tq
    qg = q.reshape(b, hkv, g, tq, d)
    dev = q.device
    outs = []
    for i0 in range(0, tq, qc):
        qf = qg[:, :, :, i0:i0 + qc].float()
        qp = off + i0 + torch.arange(qc, device=dev)[:, None]
        m = torch.full((b, hkv, g, qc), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, qc, d), dtype=torch.float32, device=dev)
        for j0 in range(0, tk, kc):
            k_blk, v_blk = k[:, :, j0:j0 + kc], v[:, :, j0:j0 + kc]
            kp = j0 + torch.arange(kc, device=dev)[None, :]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_blk.float()) * scale
            mask = _positions_mask(qp, kp, causal=causal, window=window)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v_blk.float())
            m = m_new
        out = acc / torch.where(l == 0, 1.0, l)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, hq, tq, d)


def _window_banded_jnp(q, k, v, *, window, scale, q_chunk=512):
    """Sliding-window attention that only touches the live band: each q
    chunk attends to the (window + qc) keys ending at its last position;
    the probabilities are cast to v's dtype for the PV product."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    qc = _chunk_of(tq, q_chunk)
    lw = min(window + qc, tk)                      # live keys per q chunk
    off = tk - tq
    qg = q.reshape(b, hkv, g, tq, d)
    dev = q.device
    outs = []
    for i0 in range(0, tq, qc):
        q_end = off + i0 + qc                      # one past last q pos
        start = min(max(q_end - lw, 0), tk - lw)
        k_blk = k[:, :, start:start + lw]
        v_blk = v[:, :, start:start + lw]
        qpos = off + i0 + torch.arange(qc, device=dev)[:, None]
        kpos = start + torch.arange(lw, device=dev)[None, :]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, i0:i0 + qc].float(),
                         k_blk.float()) * scale
        mask = (kpos <= qpos) & (kpos > qpos - window)
        s = torch.where(mask, s, _NEG)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, v_blk))
    return torch.cat(outs, dim=3).reshape(b, hq, tq, d).to(q.dtype)


def attention_core(q, k, v, *, causal=True, window=None, scale=None,
                   dense_threshold=2048):
    """Dispatch between the kernel / dense / banded-window / chunked paths."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    tq, tk = q.shape[2], k.shape[2]
    if runtime.use_kernel(q.device) and tq % 128 == 0 and tk % 128 == 0:
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if max(tq, tk) <= dense_threshold:
        return _dense_attention(q, k, v, causal=causal, window=window,
                                scale=scale)
    if window is not None and causal and tq == tk and window + 512 < tk:
        return _window_banded_jnp(q, k, v, window=window, scale=scale)
    return _flash_jnp(q, k, v, causal=causal, window=window, scale=scale)


# --------------------------------------------------------------------------
# attention layer (projections + rope + qk_norm + cache handling)
# --------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   cross: bool = False, *, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    s = d ** -0.5
    pt = dtype_of(cfg)
    p = {name: (_normal(generator, shape, device) * s).to(pt)
         for name, shape in (("wq", (d, hq * hd)), ("wk", (d, hkv * hd)),
                             ("wv", (d, hkv * hd)), ("wo", (hq * hd, d)))}
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, dtype=pt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=pt, device=device)
    return Params(p)


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def _merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def attention_fwd(p, x, cfg: ModelConfig, *, positions=None, causal=True,
                  window=None, kv_src=None):
    """Full-sequence attention (prefill).  ``kv_src`` = cross-attn source
    sequence (B, S_kv, d); positions only rotate self-attention.  The heads
    go to ``attention_core`` as strided views of the projections."""
    hd = cfg.resolved_head_dim
    src = x if kv_src is None else kv_src
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(src @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(src @ p["wv"], cfg.num_kv_heads, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = _rms_head(q, p["q_norm"])
        k = _rms_head(k, p["k_norm"])
    if kv_src is None and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attention_core(q, k, v, causal=causal and kv_src is None,
                       window=window)
    return _merge_heads(o) @ p["wo"], (k, v)


def decode_attention(p, x, cache, cfg: ModelConfig, *, index: int,
                     window=None):
    """Single-token decode with a (possibly ring-buffered) KV cache.

    cache: {"k": (B,Hkv,C,D), "v": ..., "pos": (C,) global position of each
    slot, -1 = empty}.  ``index`` is the global position of the new token,
    a host integer.  The new key and value are written into ``cache["k"]``
    and ``cache["v"]`` in place (the reference returns updated copies; a
    copy of every layer's cache a token is what this saves); ``pos`` comes
    back as a new tensor.
    """
    pos = cache["pos"].clone()
    pos[index % pos.shape[0]] = index
    out = decode_attention_at(p, x, cache["k"], cache["v"], pos, cfg,
                              index=index, window=window)
    return out, {"k": cache["k"], "v": cache["v"], "pos": pos}


def decode_attention_at(p, x, k, v, pos, cfg: ModelConfig, *, index: int,
                        window=None):
    """:func:`decode_attention` given ``pos`` with the new token's slot
    already set, as ``decode_step`` sets it once for all layers.  Writes the
    new key and value into ``k`` and ``v`` in place; returns the output."""
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)       # (B,H,1,D)
    k_new = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v_new = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = _rms_head(q, p["q_norm"])
        k_new = _rms_head(k_new, p["k_norm"])
    where = torch.full((1,), index, device=x.device)    # no host copy
    q = apply_rope(q, where, cfg.rope_theta)
    k_new = apply_rope(k_new, where, cfg.rope_theta)

    slot = index % k.shape[2]
    k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0].to(v.dtype)

    b, hq = q.shape[0], cfg.num_heads
    hkv = cfg.num_kv_heads
    g = hq // hkv
    qf = q.reshape(b, hkv, g, 1, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * (hd ** -0.5)
    valid = (pos >= 0) & (pos <= index)
    if window is not None:
        valid &= pos > index - window
    s = torch.where(valid, s, _NEG)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.float())
    o = o.reshape(b, hq, 1, hd).to(x.dtype)
    return _merge_heads(o) @ p["wo"]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=None, device):
    c = min(seq_len, window) if window else seq_len
    hd = cfg.resolved_head_dim
    dt = dtype or dtype_of(cfg, "act")
    shape = (batch, cfg.num_kv_heads, c, hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((c,), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, generator: torch.Generator, *, device
             ) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pt = dtype_of(cfg)
    width = 2 * f if cfg.act == "silu" else f   # SwiGLU: fused gate+up
    return Params({
        "wi": (_normal(generator, (d, width), device) * d ** -0.5).to(pt),
        "wo": (_normal(generator, (f, d), device) * f ** -0.5).to(pt),
    })


def mlp_fwd(p, x, cfg: ModelConfig):
    h = x @ p["wi"]
    if cfg.act == "silu":
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g) * u
    else:
        h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    return h @ p["wo"]


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, generator: torch.Generator, *,
               device) -> Params:
    pt = dtype_of(cfg)
    p = {"embedding": (_normal(generator, (cfg.padded_vocab, cfg.d_model),
                               device) * 0.02).to(pt)}
    if not cfg.tie_embeddings:
        p["unembed"] = (_normal(generator, (cfg.d_model, cfg.padded_vocab),
                                device) * cfg.d_model ** -0.5).to(pt)
    return Params(p)


def embed(p, tokens, cfg: ModelConfig):
    return p["embedding"][tokens].to(dtype_of(cfg, "act"))


def unembed(p, x, cfg: ModelConfig):
    w = p["embedding"].T if cfg.tie_embeddings else p["unembed"]
    return (x @ w.to(x.dtype)).float()
