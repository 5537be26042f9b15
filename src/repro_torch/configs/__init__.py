"""Architecture registry: ``get_arch(id)``, ``get_shape`` and per-arch
smoke variants (the LM and recsys parts of ``repro/configs/__init__.py``;
GNN waits)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    LMConfig, MoEConfig, RecSysConfig, ShapeSpec, LM_SHAPES, RECSYS_SHAPES,
    shapes_for,
)
from repro_torch.configs.lm_archs import (
    LM_ARCHS, QWEN2_MOE_A2_7B, LLAMA4_SCOUT_17B_A16E, MINITRON_8B, GLM4_9B,
    QWEN3_1_7B,
)
from repro_torch.configs.other_archs import (
    RECSYS_ARCHS, SASREC, MIND, BST, WIDE_DEEP,
)

ARCHS = dict(LM_ARCHS)
ARCHS.update(RECSYS_ARCHS)


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(cfg, shape_name: str) -> ShapeSpec:
    for s in shapes_for(cfg):
        if s.name == shape_name:
            return s
    raise KeyError(f"{cfg.name} has no shape {shape_name!r}; "
                   f"available: {[s.name for s in shapes_for(cfg)]}")


def smoke_config(arch_id: str):
    """A reduced same-family config that runs on a laptop CPU (the same
    reduction as the JAX package's ``smoke_config``)."""
    cfg = get_arch(arch_id)
    if isinstance(cfg, RecSysConfig):
        return dataclasses.replace(
            cfg, name=cfg.name + "-smoke",
            embed_dim=max(8, cfg.embed_dim // 8), n_items=128,
            sparse_vocab=64, seq_len=min(cfg.seq_len, 8) if cfg.seq_len else 0,
            mlp_dims=tuple(d // 16 for d in cfg.mlp_dims) if cfg.mlp_dims
            else ())
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
    "ARCHS", "get_arch", "get_shape", "smoke_config", "LMConfig",
    "MoEConfig", "RecSysConfig", "ShapeSpec", "LM_SHAPES", "RECSYS_SHAPES",
    "shapes_for", "QWEN2_MOE_A2_7B", "LLAMA4_SCOUT_17B_A16E", "MINITRON_8B",
    "GLM4_9B", "QWEN3_1_7B", "SASREC", "MIND", "BST", "WIDE_DEEP",
]
