"""minicpm-2b [dense] — llama-like arch. [arXiv:2404.06395; hf]

Its WSD training schedule waits for the training slice.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    head_dim=64, d_ff=5760, vocab_size=122_753,
    rope_theta=10_000.0, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="minicpm-2b-reduced", family="dense",
    num_layers=2, d_model=72, num_heads=6, num_kv_heads=6,
    head_dim=12, d_ff=144, vocab_size=512, tie_embeddings=True,
    vocab_pad_multiple=16,
)
