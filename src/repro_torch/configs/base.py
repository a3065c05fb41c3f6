"""Model/run configuration dataclasses.

One ``ModelConfig`` describes any architecture of the LM pool; family-
specific fields default to "absent".  Configs are frozen and hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0       # 0 = full attention
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0   # deepseek: first k layers use dense FFN
    router_aux_coef: float = 0.01
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    mtp_depth: int = 0            # multi-token-prediction extra heads
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    use_sfc_conv: bool = False    # SFC fast path for the depthwise conv1d
    # hybrid (zamba2)
    shared_attn_every: int = 0    # insert the shared attention block every k
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq_ratio: int = 1    # encoder frames per decoder token (stub)
    # VLM (llama-3.2-vision): cross-attention block every k self-attn layers
    cross_attn_every: int = 0
    n_vision_tokens: int = 1601   # stub frontend output length
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    max_seq_len: int = 524288

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        # a multiple of 256, so the vocab dim divides a 16-way model axis
        return pad_vocab(self.vocab_size, 256)

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        n_attn_layers = self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family in ("dense", "moe", "vlm", "encdec"):
            if self.use_mla:
                attn = (d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads
                        * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                        + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                        + self.kv_lora_rank * self.n_heads
                        * (self.qk_nope_head_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * d)
            else:
                attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * self.head_dim * d
            dense_ffn = 3 * d * f
            if self.family == "moe":
                moe_ffn = 3 * d * f * self.n_experts \
                    + self.n_shared_experts * 3 * d * f + d * self.n_experts
                n_moe = self.n_layers - self.first_dense_layers
                total += self.first_dense_layers * (attn + dense_ffn)
                total += n_moe * (attn + moe_ffn)
            else:
                total += n_attn_layers * (attn + dense_ffn)
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                total += n_cross * (attn + dense_ffn)
            if self.family == "encdec":
                total += self.encoder_layers * (attn + dense_ffn) \
                    + self.n_layers * attn  # decoder cross-attention
        elif self.family == "ssm":
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * N + H) + di * d + self.ssm_conv * (di + 2 * N)
            total += self.n_layers * per
        elif self.family == "hybrid":
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * N + H) + di * d + self.ssm_conv * (di + 2 * N)
            attn = 4 * d * self.n_heads * self.head_dim + 3 * d * f
            total += self.n_layers * per + attn  # one shared block
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts only routed-active experts."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        n_moe = self.n_layers - self.first_dense_layers
        inactive = n_moe * 3 * d * f * (self.n_experts - self.n_experts_active)
        return int(full - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# smoke-test shapes (reduced)
SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
