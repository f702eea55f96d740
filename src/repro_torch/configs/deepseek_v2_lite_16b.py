"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA) vocab=102400,
MoE 64 routed top-6 + 2 shared experts (d_expert=1408), MLA kv_lora=512.
[arXiv:2405.04434; hf]

Assignment note: the pool line reads "2 shared+160 routed"; 160 routed is
full DeepSeek-V2 — V2-LITE (per its HF config and the same pool line's
"MoE 64e top-6") has 64 routed experts, which we use. Layer 0 keeps a dense
FFN (first_k_dense_replace=1, d_ff=10944).
"""
from ..models.config import AttnConfig, MLAConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="mla_moe",
        num_layers=27, d_model=2048, d_ff=1408, vocab_size=102400,
        attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                        rope_base=10000.0),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                      first_dense=1, first_dense_d_ff=10944),
        pattern=("attn",), ffn_type="glu", norm_type="rmsnorm",
        weight_bits=4,
    )
