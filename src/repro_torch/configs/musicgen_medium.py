"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model); the head predicts the 2048
EnCodec codes. Positional encoding adapted to RoPE (original uses learned
sinusoidal; recorded in DESIGN.md §Hardware-adaptation).
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        num_layers=48, d_model=1536, d_ff=6144, vocab_size=2048,
        attn=AttnConfig(num_heads=24, num_kv_heads=24, head_dim=64,
                        rope_base=10000.0),
        pattern=("attn",), ffn_type="mlp", norm_type="layernorm",
        input_mode="embeddings", weight_bits=4,
    )
