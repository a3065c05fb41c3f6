"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) per-expert d_ff=14336,
vocab=32000, 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128,
    n_experts=8, n_experts_active=2, sliding_window=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16,
    n_experts=4, n_experts_active=2, sliding_window=32,
)
