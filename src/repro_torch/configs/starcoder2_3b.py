"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, LayerNorm + bias, classic GeLU MLP.
[arXiv:2402.19173; hf]
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        num_layers=30, d_model=3072, d_ff=12288, vocab_size=49152,
        attn=AttnConfig(num_heads=24, num_kv_heads=2, head_dim=128,
                        qkv_bias=True, rope_base=100_000.0),
        pattern=("attn",), ffn_type="mlp", norm_type="layernorm",
        weight_bits=4,
    )
