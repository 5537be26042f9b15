"""The five assigned LM transformer architectures (exact public configs)."""
from __future__ import annotations

from repro_torch.configs.base import LMConfig, MoEConfig

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
# vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
QWEN2_MOE_A2_7B = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4,
                  d_ff_expert=1408, dispatch="ep"),
    rope_theta=1_000_000.0,
)

# [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H
# (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1, early fusion.
LLAMA4_SCOUT_17B_A16E = LMConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared_experts=1,
                  d_ff_expert=8192, dispatch="ep"),
    rope_theta=500_000.0,
)

# [arXiv:2407.14679; hf] Minitron-8B (pruned Nemotron): 32L d_model=4096
# 32H (GQA kv=8) d_ff=16384 vocab=256000.
MINITRON_8B = LMConfig(
    name="minitron-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    head_dim=128,
)

# [hf:THUDM/glm-4-9b; hf] 40L d_model=4096 32H (GQA kv=2) d_ff=13696
# vocab=151552, RoPE.
GLM4_9B = LMConfig(
    name="glm4-9b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
)

# [hf:Qwen/Qwen3-*; hf] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
# vocab=151936, qk_norm.
QWEN3_1_7B = LMConfig(
    name="qwen3-1.7b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)

LM_ARCHS = {
    c.name: c for c in (
        QWEN2_MOE_A2_7B, LLAMA4_SCOUT_17B_A16E, MINITRON_8B, GLM4_9B,
        QWEN3_1_7B,
    )
}
