"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216
vocab=256000 — local(4096)/global alternating, attn softcap 50, final
softcap 30, sandwich RMSNorms, tied embeddings. [arXiv:2408.00118; hf]
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        num_layers=26, d_model=2304, d_ff=9216, vocab_size=256000,
        attn=AttnConfig(num_heads=8, num_kv_heads=4, head_dim=256,
                        rope_base=10000.0, softcap=50.0,
                        sliding_window=4096),
        pattern=("local", "attn"), ffn_type="glu", norm_type="rmsnorm",
        post_norms=True, final_softcap=30.0, embed_scale=True,
        tie_embeddings=True, weight_bits=4,
    )
