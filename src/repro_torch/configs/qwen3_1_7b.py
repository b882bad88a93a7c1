"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=6144, vocab_size=151_936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen3-1.7b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=512,
    qk_norm=True, tie_embeddings=True, vocab_pad_multiple=16,
)
