"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, per-expert d_ff=2048,
vocab=129280, MoE 1 shared + 256 routed top-8, first 3 layers dense
(d_ff dense = 18432), MTP depth 1.  [arXiv:2412.19437]

Its parameters are stored in bf16 (``param_dtype``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab_size=129280, head_dim=128,
    n_experts=256, n_experts_active=8, n_shared_experts=1,
    first_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    mtp_depth=1, param_dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, head_dim=16,
    n_experts=8, n_experts_active=2, n_shared_experts=1,
    first_dense_layers=1,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
    mtp_depth=1,
)
