"""llama2-7b — the paper's own end-to-end model (Fig. 12/16/17 anchors):
32L d_model=4096 32H MHA d_ff=11008 vocab=32000. [arXiv:2307.09288]
"""
from ..models.config import AttnConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense",
        num_layers=32, d_model=4096, d_ff=11008, vocab_size=32000,
        attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=128,
                        rope_base=10000.0),
        pattern=("attn",), ffn_type="glu", norm_type="rmsnorm",
        weight_bits=2,
    )
