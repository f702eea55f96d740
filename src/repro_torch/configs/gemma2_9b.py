"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) head_dim=256 d_ff=14336
vocab=256000 — local(4096)/global alternating, softcaps, sandwich norms,
tied embeddings. [arXiv:2408.00118; hf]
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, d_ff=14336, vocab_size=256000,
        attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                        rope_base=10000.0, softcap=50.0,
                        sliding_window=4096),
        pattern=("local", "attn"), ffn_type="glu", norm_type="rmsnorm",
        post_norms=True, final_softcap=30.0, embed_scale=True,
        tie_embeddings=True, weight_bits=4,
    )
