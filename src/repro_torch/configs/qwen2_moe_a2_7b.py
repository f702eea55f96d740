"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA) d_ff=1408 vocab=151936,
MoE 60 routed top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Distribution note: 60 routed experts are PADDED to 64 so the expert axis
shards on 16-wide model meshes (4 padding experts are routable but
initialized like the rest; they only affect perf accounting, recorded in
DESIGN.md §Arch-applicability).
"""
from ..models.config import AttnConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, d_ff=1408, vocab_size=151936,
        attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                        qkv_bias=True, rope_base=1_000_000.0),
        moe=MoEConfig(num_experts=64, top_k=4, d_expert=1408, num_shared=4),
        pattern=("attn",), ffn_type="glu", norm_type="rmsnorm",
        weight_bits=4,
    )
