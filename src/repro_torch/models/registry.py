"""Uniform model interface: family → module dispatch (port of
:mod:`repro.models.registry` for the serving functions).

Every family module exposes ``init_params``, ``forward``,
``init_decode_state`` and ``decode_step`` with the same signatures; this
registry is the single place the serving and launch layers touch.  The port
has the dense family; the others raise ``NotImplementedError`` (ROADMAP
item 12, the LM stack).
"""
from __future__ import annotations

from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

FAMILIES: dict[str, ModuleType] = {"dense": transformer}


def get_module(cfg: ModelConfig) -> ModuleType:
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: the port has "
            f"{sorted(FAMILIES)}; the others wait for ROADMAP item 12 (the "
            "LM stack)") from None


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None):
    return get_module(cfg).init_params(cfg, generator, device=device)


def forward(params, batch, cfg: ModelConfig, last_only: bool = False):
    return get_module(cfg).forward(params, batch, cfg, last_only=last_only)


def init_decode_state(params, cfg: ModelConfig, batch: int, seq_len: int,
                      batch_ctx=None):
    return get_module(cfg).init_decode_state(params, cfg, batch, seq_len,
                                             batch_ctx=batch_ctx)


def decode_step(params, state, token, index, cfg: ModelConfig,
                batch_ctx=None):
    return get_module(cfg).decode_step(params, state, token, index, cfg,
                                       batch_ctx=batch_ctx)
