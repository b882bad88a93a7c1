"""Dense decoder-only transformer, serving path (port of
:mod:`repro.models.transformer` for qwen3 / codeqwen / tinyllama / minicpm).

The model is a :class:`Transformer` module: ``embed``, an ``nn.ModuleList``
of ``layers`` and ``final_norm``, read like the reference's param pytree
(``params["layers"]``), with the layers as a list where the reference
stacks them on a leading axis for its scan.  The plain functions keep the
reference's names and signatures over it and run under
``torch.inference_mode()``: ``forward``, ``prefill``, ``init_decode_state``
and ``decode_step``.  ``decode_step`` updates the cache of the state it is
given in place and returns it.  ``loss_fn`` and remat wait for the training
slice (ROADMAP item 12).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class Transformer(L.Params):
    """The parameters of one dense model."""

    def __init__(self, embed: L.Params, layers: list[L.Params],
                 final_norm: L.Params):
        super().__init__({"embed": embed, "layers": nn.ModuleList(layers),
                          "final_norm": final_norm})


def init_layer(cfg: ModelConfig, generator: torch.Generator, *,
               device) -> L.Params:
    return L.Params({
        "ln1": L.init_norm(cfg, device=device),
        "attn": L.init_attention(cfg, generator, device=device),
        "ln2": L.init_norm(cfg, device=device),
        "mlp": L.init_mlp(cfg, generator, device=device),
    })


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> Transformer:
    """Random weights drawn from ``generator`` with the reference's
    distributions and scales, on ``device`` (``None``: the GPU)."""
    dev = _device.resolve(device)
    return Transformer(
        L.init_embed(cfg, generator, device=dev),
        [init_layer(cfg, generator, device=dev)
         for _ in range(cfg.num_layers)],
        L.init_norm(cfg, device=dev))


def _layer_fwd(cfg, x, lp, positions):
    h = L.apply_norm(lp["ln1"], x, cfg)
    a, kv = L.attention_fwd(lp["attn"], h, cfg, positions=positions,
                            causal=True, window=cfg.window)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.mlp_fwd(lp["mlp"], h, cfg), kv


@torch.inference_mode()
def forward(params, batch, cfg: ModelConfig, last_only: bool = False):
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in params["layers"]:
        x, _ = _layer_fwd(cfg, x, lp, positions)
    x = L.apply_norm(params["final_norm"], x, cfg)
    if last_only:
        x = x[:, -1:]
    return L.unembed(params["embed"], x, cfg)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_decode_state(params, cfg: ModelConfig, batch: int, seq_len: int,
                      batch_ctx=None):
    dev = params["final_norm"]["scale"].device
    cache1 = L.init_cache(cfg, batch, seq_len, window=cfg.window, device=dev)
    shape = (cfg.num_layers,) + tuple(cache1["k"].shape)
    return {"k": cache1["k"].new_zeros(shape),
            "v": cache1["v"].new_zeros(shape), "pos": cache1["pos"]}


@torch.inference_mode()
def decode_step(params, state, token, index: int, cfg: ModelConfig,
                batch_ctx=None):
    """One new token given a KV cache.  token (B,), index a host int: the
    token's global position.  Writes the token's keys and values into
    ``state`` and returns (logits (B, V) float32, state)."""
    index = int(index)
    x = L.embed(params["embed"], token[:, None], cfg)
    pos = state["pos"].clone()
    pos[index % pos.shape[0]] = index
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(lp["ln1"], x, cfg)
        x = x + L.decode_attention_at(lp["attn"], h, state["k"][i],
                                      state["v"][i], pos, cfg, index=index,
                                      window=cfg.window)
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = x + L.mlp_fwd(lp["mlp"], h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)[:, 0, :]
    state["pos"] = pos
    return logits, state


@torch.inference_mode()
def prefill(params, batch, cfg: ModelConfig, cache_len: int | None = None):
    """Forward pass that also fills a decode cache (serving warm-up)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    pad = cache_len - s
    if pad < 0:
        raise ValueError("cache_len shorter than prompt")
    act = L.dtype_of(cfg, "act")
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    ks = torch.zeros((cfg.num_layers, b, cfg.num_kv_heads, cache_len,
                      cfg.resolved_head_dim), dtype=act, device=x.device)
    vs = torch.zeros_like(ks)
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = _layer_fwd(cfg, x, lp, positions)
        ks[i, :, :, :s] = k
        vs[i, :, :, :s] = v
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    pos = torch.cat([torch.arange(s, device=x.device),
                     torch.full((pad,), -1, device=x.device)]
                    ).to(torch.int32)
    return logits, {"k": ks, "v": vs, "pos": pos}
