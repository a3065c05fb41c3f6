"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064,
RoPE + SwiGLU + GQA.  [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=200064, head_dim=128,
)

SMOKE_CONFIG = ModelConfig(
    name="phi4-mini-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=16,
)
