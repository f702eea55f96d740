"""zamba2-7b [hybrid]: 81 Mamba2 layers d_model=3584, ssm_state=64, plus TWO
shared attention+MLP blocks (32H, d_ff=14336) invoked alternately after
every 6th Mamba2 layer (13 invocations; 81 = 13·6 + 3 trailing).
[arXiv:2411.15242; unverified]
"""
from ..models.config import AttnConfig, ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, d_ff=14336, vocab_size=32000,
        attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=112,
                        rope_base=10000.0),
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1,
                      d_conv=4, chunk=256),
        pattern=("mamba",) * 6, num_shared_blocks=2, shared_every=6,
        ffn_type="glu", norm_type="rmsnorm", weight_bits=4,
    )
