"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d=2048 + one shared attention
block (32H MHA, d_ff=8192) applied every 6 layers; ssm_state=64,
vocab=32000.  [arXiv:2411.15242]

The shared block reuses one set of attention+MLP weights at every insertion
point (the Zamba2 weight-sharing scheme; we omit the per-invocation LoRA
deltas and input-concat).  The Mamba2 depthwise conv1d
supports the SFC fast path (use_sfc_conv).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
    shared_attn_every=6, use_sfc_conv=True,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_headdim=16,
    shared_attn_every=2, use_sfc_conv=True, ssm_chunk=16,
)
