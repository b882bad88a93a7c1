"""tinyllama-1.1b [dense] — llama2-arch small. [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=64, d_ff=5632, vocab_size=32_000,
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="tinyllama-1.1b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    head_dim=8, d_ff=128, vocab_size=512, vocab_pad_multiple=16,
)
