"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), d_inner=4096, 64 heads of 64.
[arXiv:2405.21060; unverified]
"""
from ..models.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                      d_conv=4, chunk=256),
        pattern=("mamba",), norm_type="rmsnorm", tie_embeddings=True,
        weight_bits=4,
    )
