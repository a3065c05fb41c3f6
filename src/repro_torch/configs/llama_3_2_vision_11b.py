"""llama-3.2-vision-11b [vlm]: 40L (32 self + 8 gated cross-attn) d=4096,
32H GQA kv=8, d_ff=14336, vocab=128256.  [hf:meta-llama/Llama-3.2-11B-Vision]

The vision frontend is a STUB per the task spec: ``input_specs`` provides
precomputed patch embeddings of shape (B, n_vision_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, head_dim=128, rope_theta=5e5,
    cross_attn_every=4, n_vision_tokens=1601,
)

SMOKE_CONFIG = ModelConfig(
    name="llama-3.2-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16, cross_attn_every=2, n_vision_tokens=9,
)
