"""mamba2-1.3b [ssm]: 48L d=2048, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280 (padded to 50432 so the embedding shards over a
16-way model axis).  [arXiv:2405.21060]

The depthwise causal conv1d (R=4) inside every block runs the paper's SFC
1-D fast path when ``use_sfc_conv`` is set (SFC-6(6,4), ``sfc6_6_r4``: 12
multiplications per 6 outputs against 24 direct).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, head_dim=0,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
    use_sfc_conv=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=512, head_dim=0,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_headdim=16,
    use_sfc_conv=True, ssm_chunk=16,
)
