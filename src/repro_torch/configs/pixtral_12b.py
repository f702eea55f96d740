"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=131072 — mistral-nemo text backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The pixtral-ViT frontend is a STUB per the assignment: input_specs()
provides precomputed patch embeddings (B, S, d_model).
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        num_layers=40, d_model=5120, d_ff=14336, vocab_size=131072,
        attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                        rope_base=1_000_000.0),
        pattern=("attn",), ffn_type="glu", norm_type="rmsnorm",
        input_mode="embeddings", weight_bits=4,
    )
