"""The assigned recsys architecture configs (exact public dims; a copy
of the recsys part of ``repro/configs/other_archs.py``, GNN waits)."""
from __future__ import annotations

from repro_torch.configs.base import RecSysConfig

# [arXiv:1808.09781; paper] SASRec: embed_dim=50, 2 blocks, 1 head, seq 50.
SASREC = RecSysConfig(
    name="sasrec", kind="sasrec",
    embed_dim=50, seq_len=50, n_blocks=2, n_heads=1,
    interaction="self-attn-seq",
)

# [arXiv:1904.08030; unverified] MIND: embed_dim=64, 4 interest capsules,
# 3 dynamic-routing iterations.
MIND = RecSysConfig(
    name="mind", kind="mind",
    embed_dim=64, seq_len=50, n_interests=4, capsule_iters=3,
    interaction="multi-interest",
)

# [arXiv:1905.06874; paper] BST (Alibaba): embed_dim=32, seq 20, 1 block,
# 8 heads, MLP 1024-512-256.
BST = RecSysConfig(
    name="bst", kind="bst",
    embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    mlp_dims=(1024, 512, 256), interaction="transformer-seq",
)

# [arXiv:1606.07792; paper] Wide&Deep: 40 sparse fields, embed_dim=32,
# MLP 1024-512-256.
WIDE_DEEP = RecSysConfig(
    name="wide-deep", kind="wide_deep",
    embed_dim=32, n_sparse=40, mlp_dims=(1024, 512, 256),
    interaction="concat",
)

RECSYS_ARCHS = {c.name: c for c in (SASREC, MIND, BST, WIDE_DEEP)}
