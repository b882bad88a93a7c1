"""codeqwen1.5-7b [dense] — qwen1.5 arch. [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    head_dim=128, d_ff=13_440, vocab_size=92_416,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="codeqwen1.5-7b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=160, vocab_size=512, vocab_pad_multiple=16,
)
