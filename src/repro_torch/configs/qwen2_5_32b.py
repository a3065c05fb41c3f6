"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
QKV bias.  [hf:Qwen/Qwen2.5-*]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16, qkv_bias=True,
)
