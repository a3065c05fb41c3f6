"""whisper-tiny [audio]: enc-dec, 4 encoder + 4 decoder layers, d=384,
6H MHA, d_ff=1536, vocab=51865 (padded 51968).  [arXiv:2212.04356]

The conv frontend is a STUB per the task spec: ``input_specs`` provides
precomputed frame embeddings (B, S_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, encoder_layers=2, d_model=48, n_heads=3, n_kv_heads=3,
    d_ff=96, vocab_size=512, head_dim=16,
)
