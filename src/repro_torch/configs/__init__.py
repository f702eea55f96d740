"""Architecture registry of the port: the paper's llama2-7b, the dense
qwen2-7b and starcoder2-3b, and the mixture-of-experts qwen2-moe-a2.7b (the
JAX package's other architectures are still to be ported, ROADMAP A7), and
reduced ("tiny") variants for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

# arch id -> (module, long_500k runnable?) — the JAX package's registry
ARCHS = {
    "qwen2-moe-a2.7b": ("qwen2_moe_a2_7b", False),
    "starcoder2-3b": ("starcoder2_3b", False),
    "qwen2-7b": ("qwen2_7b", False),
    "llama2-7b": ("llama2_7b", False),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"{arch!r} is not ported yet (ROADMAP A7); the port "
                       f"has {tuple(ARCHS)}")
    mod, _ = ARCHS[arch]
    return importlib.import_module(f".{mod}", __package__).get_config()


def long_ok(arch: str) -> bool:
    return ARCHS[arch][1]


def tiny_config(arch: str) -> ModelConfig:
    """Same family and topology at tiny dims — the JAX package's
    `tiny_config` for the attention archs the port has (MoE: 8 experts,
    top-2, d_expert 32, a fused shared FFN 64 wide where the config has
    shared experts)."""
    cfg = get_config(arch)
    attn = dataclasses.replace(
        cfg.attn, num_heads=4, num_kv_heads=min(cfg.attn.num_kv_heads, 2),
        head_dim=16, sliding_window=8 if cfg.attn.sliding_window else None)
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, num_experts=8, top_k=2, d_expert=32,
        shared_d_ff=64 if (cfg.moe.num_shared or cfg.moe.shared_d_ff)
        else None)
    return dataclasses.replace(
        cfg, name=f"tiny-{cfg.name}", num_layers=2 * len(cfg.pattern),
        d_model=64, d_ff=128, vocab_size=256, attn=attn, moe=moe)
