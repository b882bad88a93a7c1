"""Configuration type: one frozen dataclass per architecture (port of
:mod:`repro.configs.base`).

Each config module ``configs/<id>.py`` defines ``CONFIG`` (the published
configuration) and ``REDUCED`` (a tiny config of the same family for the
CPU tests).  The port runs the dense family only, so :func:`get_config`
resolves the four dense archs and raises ``NotImplementedError`` for the
others (ROADMAP item 12, the rest of the LM stack).  The fields of every
family are kept so that a config converts field for field; the other
families' parameter counts and the shape sets wait for that item too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"            # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rms"            # rms | layer
    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid / local attention --------------------------------------------
    window: Optional[int] = None          # sliding-window attention size
    # --- encoder-decoder -----------------------------------------------------
    enc_layers: int = 0
    dec_target_len: int = 448             # whisper max_target_positions
    # --- VLM -----------------------------------------------------------------
    cross_attn_period: int = 0            # every k-th layer cross-attends
    img_tokens: int = 0                   # stub patch-embedding length
    # --- numerics ------------------------------------------------------------
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    # --- training ------------------------------------------------------------
    remat: bool = True
    z_loss: float = 1e-4

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6·N·D) of the
        dense family, the only one the port runs."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        ffn = (3 if self.act == "silu" else 2) * d * f
        return int(emb + self.num_layers * (attn + ffn + 2 * d) + d)


DENSE_ARCH_IDS = ("qwen3-1.7b", "codeqwen1.5-7b", "tinyllama-1.1b",
                  "minicpm-2b")


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in DENSE_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported: the port runs the dense "
            f"family {DENSE_ARCH_IDS}; the other families wait for ROADMAP "
            "item 12 (the LM stack)")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.REDUCED if reduced else mod.CONFIG
