"""stablelm-3b [dense]: 32L d=2560 32H (kv=32, i.e. MHA) d_ff=6912
vocab=50304, head_dim=80.  [hf:stabilityai/stablelm-*]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, head_dim=80,
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16,
)
