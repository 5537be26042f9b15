"""LM architecture registry: ``get_arch(id)`` + per-arch smoke variants
(the LM part of ``repro/configs/__init__.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.configs.lm_archs import (
    LM_ARCHS, QWEN2_MOE_A2_7B, LLAMA4_SCOUT_17B_A16E, MINITRON_8B, GLM4_9B,
    QWEN3_1_7B,
)

ARCHS = dict(LM_ARCHS)


def get_arch(arch_id: str) -> LMConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke_config(arch_id: str) -> LMConfig:
    """A reduced same-family config that runs on a laptop CPU (the same
    reduction as the JAX package's ``smoke_config``)."""
    cfg = get_arch(arch_id)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=4, top_k=min(2, moe.top_k),
            n_shared_experts=min(1, moe.n_shared_experts), d_ff_expert=64)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=max(1, 4 // (cfg.n_heads // cfg.n_kv_heads)),
        head_dim=16, d_ff=128, vocab_size=512, moe=moe, attn_chunk=32)


__all__ = [
    "ARCHS", "get_arch", "smoke_config", "LMConfig", "MoEConfig",
    "QWEN2_MOE_A2_7B", "LLAMA4_SCOUT_17B_A16E", "MINITRON_8B", "GLM4_9B",
    "QWEN3_1_7B",
]
