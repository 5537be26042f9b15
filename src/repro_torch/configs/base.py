"""LM and recsys configuration dataclasses and the recsys and LM input
shapes (a copy of those parts of ``repro/configs/base.py``; GNN waits).
Plain frozen dataclasses, so configs hash, compare and print cleanly.
The port's transformer runs the dense path with its layers unrolled;
``remat``, ``scan_layers``, ``seq_parallel`` and ``attn_chunk`` are kept
so a config prints the same in both packages, and are read only by the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (GShard/Switch style)."""
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert hidden width
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # dispatch strategy: 'sort' (argsort grouped, default — never builds the
    # (T,E,C) one-hot tensor) | 'einsum' (GShard one-hot; small-T only)
    dispatch: str = "sort"
    # tokens are split into n_groups capacity groups; groups align with the
    # data-parallel shards so the dispatch argsort is shard-local (no
    # cross-device sort). Must be a multiple of the data axis size.
    n_groups: int = 32


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer (dense or MoE)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # attention chunk size for the blockwise online-softmax path
    attn_chunk: int = 1024
    remat: bool = True            # activation checkpointing per layer
    scan_layers: bool = True      # lax.scan over the layer stack
    # Megatron-style sequence-parallel residuals: the layer carry (and so
    # every remat-saved activation) is sharded over 'model' on the seq
    # axis -> 16x less residual memory, collective-neutral (§Perf)
    seq_parallel: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, (
            f"{self.name}: n_heads={self.n_heads} not divisible by "
            f"n_kv_heads={self.n_kv_heads}")

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def param_count(self) -> int:
        """Total parameter count (embeddings included)."""
        d, h = self.d_model, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) \
            + (self.n_heads * h) * d
        if self.moe is not None:
            m = self.moe
            ffn = m.n_experts * 3 * d * m.d_ff_expert          # routed experts
            ffn += m.n_shared_experts * 3 * d * m.d_ff_expert  # shared experts
            ffn += d * m.n_experts                             # router
        else:
            ffn = 3 * d * self.d_ff                            # SwiGLU
        norms = 2 * d + (2 * h if self.qk_norm else 0)
        per_layer = attn + ffn + norms
        embed = self.vocab_size * d
        unembed = 0 if self.tie_embeddings else self.vocab_size * d
        return self.n_layers * per_layer + embed + unembed + d  # final norm

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top_k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        routed_all = self.n_layers * m.n_experts * 3 * d * m.d_ff_expert
        routed_active = self.n_layers * m.top_k * 3 * d * m.d_ff_expert
        return self.param_count() - routed_all + routed_active


@dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str                     # sasrec | mind | bst | wide_deep
    embed_dim: int
    n_items: int = 1_000_000      # item vocab (sparse table rows)
    # sequential models
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    # MIND
    n_interests: int = 0
    capsule_iters: int = 0
    # wide&deep / MLP heads
    n_sparse: int = 0             # number of categorical fields
    sparse_vocab: int = 100_000   # rows per categorical field table
    mlp_dims: Tuple[int, ...] = ()
    interaction: str = ""
    dtype: str = "float32"
    dropout: float = 0.0

    @property
    def multi_hot(self) -> int:
        """Avg multi-hot ids per sparse field (embedding-bag size)."""
        return 4


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell.

    kind:
      train      -> train step
      prefill    -> full-sequence forward (serving)
      decode     -> one new token against a KV cache
      serve      -> recsys forward scoring
      retrieval  -> 1 query vs n_candidates scoring + top-k
    (the GNN kinds of the JAX package wait with the GNN port)
    """
    name: str
    kind: str
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    # recsys
    n_candidates: int = 0


LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", global_batch=65536),
    ShapeSpec("serve_p99", "serve", global_batch=512),
    ShapeSpec("serve_bulk", "serve", global_batch=262144),
    ShapeSpec("retrieval_cand", "retrieval", global_batch=1,
              n_candidates=1_000_000),
)


def shapes_for(cfg) -> Tuple[ShapeSpec, ...]:
    if isinstance(cfg, LMConfig):
        return LM_SHAPES
    if isinstance(cfg, RecSysConfig):
        return RECSYS_SHAPES
    raise TypeError(f"unknown config type {type(cfg)}")
