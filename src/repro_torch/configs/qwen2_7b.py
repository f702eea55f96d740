"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
— GQA with QKV bias, SwiGLU, RMSNorm. [arXiv:2407.10671; hf]
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        num_layers=28, d_model=3584, d_ff=18944, vocab_size=152064,
        attn=AttnConfig(num_heads=28, num_kv_heads=4, head_dim=128,
                        qkv_bias=True, rope_base=1_000_000.0),
        pattern=("attn",), ffn_type="glu", norm_type="rmsnorm",
        weight_bits=4,
    )
