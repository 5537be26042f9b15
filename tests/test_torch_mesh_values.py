"""The port's sharded values against the JAX package on the CPU.

- ``moe_ffn_ep``'s three local steps chained across 4 simulated 'model'
  ranks (the all-to-alls done by indexing) against JAX's ``moe_ffn_ep``
  on a one-device mesh applied to each rank's token shard: on one device
  JAX's Ep = E and C = capacity(T_loc, ...), and the port's pad experts
  are never routed to, so each shard's output is what the reference's
  multi-device ``shard_map`` gives for it;
- the row-sharded bag and the sequence-sharded decode step, chained the
  same way across 4 ranks, against the unsharded JAX functions;
- the sharded functions themselves run on 4 simulated ranks, each rank
  a fake process group of its own (its DTensors hold that rank's real
  blocks; only the collectives are simulated): GraphSAGE's edge-sharded
  aggregation and its batch of whole graphs a rank, retrieval's and the
  cache lookup's per-rank top-k with the merge after the all-gather,
  against the unsharded JAX functions;
- on an in-process gloo group of one rank (``make_smoke_mesh(1)``): a
  Qwen3 smoke train step through the workload builder, an MoE forward
  through the 'ep' route, a Wide&Deep step with a row-sharded table and
  a GraphSAGE step of each kind, each against the unsharded port and JAX
  on the same numpy weights;
- ``checkpoint.restore`` onto DTensor placements of two mesh shapes;
- narrow cells counted on the reference's 256- and 512-rank meshes (fake
  process groups, meta): collectives and the 1- and 2-layer
  extrapolation;
- ``launch/train.py --devices 2 --device cpu``: two gloo ranks against
  the one-process run.

Tolerances: fp32 throughout; 1e-5 of the output's largest magnitude
(sums taken in other orders), 1e-5 relative on losses. Each process
group is torn down by its fixture; one test spawns processes. The
module runs on one core (JAX compiles ``shard_map`` programs here,
which would otherwise take several cores from the parallel suite's
timing-sensitive tests).
"""
import contextlib
import dataclasses
import itertools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed.act_sharding import use_dp_axes as jax_use_dp_axes
from repro.index import flat as jflat
from repro.models import attention as jattn
from repro.models import gnn as jgnn
from repro.models import moe as jmoe
from repro.models import recsys as jrecsys
from repro.models import transformer as JT
from repro_torch.configs import get_shape, smoke_config
from repro_torch.data import graph_data
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import act_sharding
from repro_torch.distributed.act_sharding import use_dp_axes
from repro_torch.index.sharded import mesh_cosine_topk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dp_axes, make_smoke_mesh
from repro_torch.launch.workloads import build_gnn, build_lm, build_recsys
from repro_torch.models import gnn, moe, recsys
from repro_torch.models import transformer as tr
from repro_torch.models.attention import merge_decode_partials
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 4


def _pin(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:                 # the thread ended meanwhile
            pass


@pytest.fixture(scope="module", autouse=True)
def one_core():
    cores = os.sched_getaffinity(0)
    _pin({min(cores)})
    yield
    _pin(cores)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture
def one_rank():
    """An in-process gloo group of one rank and its smoke mesh (1, 1),
    torn down after the test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_smoke_mesh(1)
    finally:
        dist.destroy_process_group()


def test_ep_chained_over_four_ranks_matches_jax_per_shard():
    """4 'model' ranks of 24 tokens each and E 6 experts (two a rank,
    the last rank's second a pad expert): y within 1e-5 of the largest
    |y| of JAX's per-shard ``moe_ffn_ep``; each rank's aux equal to
    JAX's for its shard, so their mean is the reference's ``pmean``."""
    n_experts = 6
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-moe-a2.7b").moe,
                               n_experts=n_experts)
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b").moe,
                              n_experts=n_experts)
    d, F, T_loc = 64, cfg.d_ff_expert, 24
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N_RANKS * T_loc, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, n_experts)).astype(np.float32),
         "wg": rng.standard_normal((n_experts, d, F)).astype(np.float32)
         * d ** -0.5,
         "wu": rng.standard_normal((n_experts, d, F)).astype(np.float32)
         * d ** -0.5,
         "wd": rng.standard_normal((n_experts, F, d)).astype(np.float32)
         * F ** -0.5}
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    shards = [x[r * T_loc:(r + 1) * T_loc] for r in range(N_RANKS)]
    want = [jmoe.moe_ffn_ep(jnp.asarray(s), jp, jcfg, jmesh)
            for s in shards]

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    C = moe.capacity(T_loc, cfg.top_k, n_experts, cfg.capacity_factor)
    E_loc = -(-n_experts // N_RANKS)
    sent = [moe.ep_dispatch(torch.from_numpy(s), tp["router"], cfg,
                            N_RANKS, C) for s in shards]
    S = torch.stack([s[0] for s in sent])        # (from, to, E_loc C, d)
    outs = []
    for j in range(N_RANKS):                     # rank j's experts
        w = [tp[n][j * E_loc:(j + 1) * E_loc] for n in ("wg", "wu", "wd")]
        w = [moe._pad_experts(t, E_loc - t.shape[0]) for t in w]
        outs.append(moe.ep_experts(S[:, j], *w, C))
    O = torch.stack(outs)                        # (expert rank, to, ...)
    for r, (_, state, aux) in enumerate(sent):
        y = moe.ep_combine(O[:, r], state, torch.float32)
        _close(y.numpy(), np.asarray(want[r][0]))
        np.testing.assert_allclose(float(aux), float(want[r][1]),
                                   rtol=1e-6)


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_row_sharded_bag_chained_matches_jax(mode):
    """A (1000, 16) table in 4 row shards (250 a rank), ids over every
    shard with a mask: the ranks' ``local_bag`` partial sums add up to
    JAX's unsharded ``embedding_bag`` within 1e-5 of its largest
    magnitude (the port weighs each id by mask / count where JAX sums
    and divides)."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((1000, 16)).astype(np.float32)
    ids = rng.integers(0, 1000, (6, 3, 5)).astype(np.int32)
    mask = rng.random((6, 3, 5)) < 0.7
    want = np.asarray(jrecsys.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask), mode))
    w = recsys.bag_weights(torch.from_numpy(ids), torch.from_numpy(mask),
                           mode)
    rows = 1000 // N_RANKS
    got = sum(recsys.local_bag(torch.from_numpy(table[r * rows:
                                                      (r + 1) * rows]),
                               r * rows, torch.from_numpy(ids), w, 3)
              for r in range(N_RANKS))
    _close(got.numpy(), want)


def test_sequence_sharded_decode_chained_matches_jax():
    """A (B 3, S 64, K 2, D 16) cache in 4 sequence shards, 8 query
    heads, lengths [37, 37, 37] (the new token at position 37, in the
    third shard): each rank writes the token only if it owns position
    37, its kernel part gives (out, lse), and the merged output is JAX's
    ``decode_attention`` over the whole cache with the token written, to
    1e-5 of its largest magnitude; the shards, put back together, are
    that cache exactly."""
    rng = np.random.default_rng(9)
    B, S, K, D, H, pos = 3, 64, 2, 16, 8, 37
    kc = rng.standard_normal((B, S, K, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    vn = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    k_full, v_full = kc.copy(), vc.copy()
    k_full[:, pos], v_full[:, pos] = kn[:, 0], vn[:, 0]
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q[:, None]), jnp.asarray(k_full), jnp.asarray(v_full),
        jnp.full((B,), pos + 1, jnp.int32)))[:, 0]
    length = torch.full((B,), pos, dtype=torch.int32)
    n = S // N_RANKS
    parts, caches = [], []
    for r in range(N_RANKS):
        k_l = torch.from_numpy(kc[:, r * n:(r + 1) * n].copy())
        v_l = torch.from_numpy(vc[:, r * n:(r + 1) * n].copy())
        parts.append(tr.decode_local(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            k_l, v_l, length, r * n))
        caches.append((k_l, v_l))
    out = merge_decode_partials(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]))
    _close(out.numpy(), want)
    assert np.array_equal(torch.cat([c[0] for c in caches], 1).numpy(),
                          k_full)
    assert np.array_equal(torch.cat([c[1] for c in caches], 1).numpy(),
                          v_full)
    # the last rank holds no valid position: its lse is -inf, out 0
    assert torch.isinf(parts[-1][1]).all() and not parts[-1][0].any()


@contextlib.contextmanager
def _fake_rank(rank: int, shape=(1, N_RANKS)):
    """Rank ``rank`` of a fake process group of prod(shape) ranks and its
    ("data", "model") mesh: a DTensor placed there holds this rank's
    real block, and no collective carries data."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape,
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _gathered_on_four_ranks(module, run):
    """``run(rank, mesh)`` on each of the 4 'model' ranks of a (1, 4)
    fake mesh, twice, with ``module.gather_over`` simulated: the first
    pass records what each rank hands to each all-gather, the second
    gives every rank the ranks' tensors in rank order, as the collective
    does. Returns the second pass's results by rank."""
    sent = [[] for _ in range(N_RANKS)]
    real = module.gather_over
    out = []
    try:
        for record in (True, False):
            for r in range(N_RANKS):
                calls = itertools.count()

                def gather(t, mesh, axis, r=r, calls=calls, record=record):
                    i = next(calls)
                    if record:
                        sent[r].append(t.clone())
                        return torch.cat([t] * N_RANKS)
                    return torch.cat([sent[q][i] for q in range(N_RANKS)])
                module.gather_over = gather
                with _fake_rank(r) as mesh:
                    res = run(r, mesh)
                if not record:
                    out.append(res)
    finally:
        module.gather_over = real
    return out


def test_gnn_edge_shards_and_graph_shards_on_four_ranks_match_jax():
    """GraphSAGE on 4 simulated ranks of a (2, 2) mesh, JAX's weights.
    Full graph: 90 edges (a fifth masked) padded with masked edges to 92
    and sharded over both axes (23 a rank); each layer's
    ``_edge_local_sums`` on every rank, its Partial sums and degrees
    added over the ranks, gives logits within 1e-5 of JAX's
    ``full_graph_forward`` on the unpadded edges, for the mean and the
    sum. A batch of 6 molecules (one without edges) sharded by whole
    graphs over 'data': each rank's ``batched_graphs_forward`` logits are
    JAX's for its 3 graphs, equal on the two 'model' ranks."""
    mshape = (2, 2)
    jcfg0 = jax_smoke_config("graphsage-reddit")
    cfg0 = smoke_config("graphsage-reddit")
    tree = jax.tree.map(np.asarray, jgnn.init_params(jcfg0,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    n, E, E_pad = 40, 90, 92
    feats = rng.standard_normal((n, cfg0.d_feat)).astype(np.float32)
    edges = rng.integers(0, n, (E_pad, 2)).astype(np.int32)
    mask = (rng.random(E_pad) < 0.8) & (np.arange(E_pad) < E)
    src = torch.from_numpy(np.where(mask, edges[:, 0], n).astype(np.int64))
    dst = torch.from_numpy(np.where(mask, edges[:, 1], n).astype(np.int64))
    all_axes = shd.P(("data", "model"))
    for agg in ("mean", "sum"):
        jcfg = dataclasses.replace(jcfg0, aggregator=agg)
        cfg = dataclasses.replace(cfg0, aggregator=agg)
        p = gnn.params_from_numpy(cfg, tree, "cpu")
        h = torch.from_numpy(feats)
        for layer in p["layers"]:
            hp = torch.cat([h, h.new_zeros((1, h.shape[1]))])
            summed = deg = 0
            for r in range(math.prod(mshape)):
                with _fake_rank(r, mshape) as mesh:
                    s_r, d_r = gnn._edge_local_sums(
                        shd.distribute(hp, shd.NamedSharding(mesh, shd.P())),
                        *(shd.distribute(t, shd.NamedSharding(mesh, all_axes))
                          for t in (src, dst)), n + 1)
                    summed = summed + s_r.to_local()
                    deg = deg + d_r.to_local()
            a = summed if agg == "sum" \
                else summed / torch.clamp(deg, min=1.0)[:, None]
            h = gnn._sage_layer(cfg, layer, h, a[:n], last=False)
        want = np.asarray(jgnn.full_graph_forward(
            jcfg, tree, jnp.asarray(feats), jnp.asarray(edges[:E]),
            jnp.asarray(mask[:E])))
        _close((h @ p["head"]).numpy(), want)

    b = graph_data.batched_molecules(6, 7, 12, cfg0.d_feat, cfg0.n_classes, 3)
    b["edge_mask"][4] = False                     # a graph with no edges
    want = np.asarray(jgnn.batched_graphs_forward(
        jcfg0, tree, *(jnp.asarray(b[k]) for k in ("feats", "edges",
                                                   "edge_mask"))))
    got = []
    for r in range(math.prod(mshape)):
        with _fake_rank(r, mshape) as mesh:
            spec = shd.gnn_batch_spec(mesh, "batched_graphs")
            p = shd.distribute_tree(gnn.params_from_numpy(cfg0, tree, "cpu"),
                                    mesh, shd.gnn_param_specs(cfg0, tree))
            out = gnn.batched_graphs_forward(cfg0, p, *(
                shd.distribute(b[k], shd.NamedSharding(mesh, spec[k]))
                for k in ("feats", "edges", "edge_mask")))
            got.append(out.to_local())
    for r, g in enumerate(got):
        d = r // mshape[1]
        _close(g.numpy(), want[3 * d:3 * (d + 1)])
        assert torch.equal(g, got[d * mshape[1]])


def test_sharded_retrieval_on_four_ranks_matches_jax():
    """``recsys._sharded_retrieval`` on 4 simulated 'model' ranks: 30
    candidates sharded 8, 8, 8, 6 (the short shard padded), k 8, a
    candidate repeated in another shard (a tie): each rank's top 8 and
    the merge of the 4 gathered lists give JAX's unsharded top-k, ids
    equal and scores within 1e-6 of the largest (dot products of 16
    terms in another order), for one user vector a row (JAX's
    ``topk_scores``) and for 3 interests a row (max over interests,
    ``lax.top_k``)."""
    rng = np.random.default_rng(6)
    B, N, d, k = 5, 30, 16, 8
    cand = rng.standard_normal((N, d)).astype(np.float32)
    cand[27] = cand[2]                            # ties across shards
    ids = rng.permutation(1000)[:N].astype(np.int32)
    for u in (rng.standard_normal((B, d)).astype(np.float32),
              rng.standard_normal((B, 3, d)).astype(np.float32)):
        if u.ndim == 2:
            wv, wi = jflat.topk_scores(jnp.asarray(u), jnp.asarray(cand),
                                       jnp.asarray(ids), k)
        else:
            sc = jnp.einsum("bkd,cd->bkc", u, cand).max(axis=1)
            wv, j = jax.lax.top_k(sc, k)
            wi = jnp.take(jnp.asarray(ids), j)

        def run(r, mesh, u=u):
            rows = shd.NamedSharding(mesh, shd.P("model", None))
            v, i = recsys._sharded_retrieval(
                torch.from_numpy(u), shd.distribute(cand, rows),
                shd.distribute(ids, shd.NamedSharding(mesh, shd.P("model"))),
                k)
            return v.to_local(), i.to_local()
        for v, i in _gathered_on_four_ranks(recsys, run):
            np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
            _close(v.numpy(), np.asarray(wv), rel=1e-6)


def test_mesh_cosine_topk_on_four_ranks_matches_jax():
    """``index.sharded.mesh_cosine_topk`` (the cache lookup on the
    production mesh) on 4 simulated 'model' ranks: 64 rows, 16 a rank,
    one row repeated in a later shard (a tie), k 4: each rank's scan of
    its rows, offset to global ids, and the merge of the gathered lists
    give JAX's unsharded ``cosine_topk``, ids equal and scores within
    1e-6."""
    rng = np.random.default_rng(8)
    corpus = rng.standard_normal((64, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    corpus[50] = corpus[5]
    q[0] = corpus[5]                             # the tie is the top-1
    wv, wi = jflat.cosine_topk(jnp.asarray(q), jnp.asarray(corpus), k=4)

    def run(r, mesh):
        v, i = mesh_cosine_topk(torch.from_numpy(q), shd.distribute(
            corpus, shd.NamedSharding(mesh, shd.P("model", None))), k=4)
        return v.to_local(), i.to_local()
    for v, i in _gathered_on_four_ranks(act_sharding, run):
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=0,
                                   atol=1e-6)


def _lm(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def test_one_rank_mesh_train_step_matches_unsharded_and_jax(one_rank):
    """A Qwen3 smoke train step through ``build_lm(mesh=)`` on the
    one-rank mesh, its weights JAX's: loss and grad norm equal the
    unsharded port step's to 1e-5 and the loss JAX's ``train_loss``;
    the new params are DTensors placed by ``lm_param_specs`` and equal
    the unsharded step's to 1e-5 of their largest magnitude."""
    mesh = one_rank
    jcfg, cfg, tree = _lm("qwen3-1.7b")
    shape = dataclasses.replace(get_shape(cfg, "train_4k"), global_batch=2,
                                seq_len=64)
    wl = build_lm(cfg, shape, "cpu", mesh=mesh)
    batch = wl.args[2]
    plain = tr.params_from_numpy(cfg, tree, "cpu")
    params = shd.distribute_tree(plain, mesh, shd.lm_param_specs(cfg))
    p1, _, m = wl.fn(params, opt.init(params, opt.AdamWConfig()), batch)
    ref_b = {k: v.full_tensor() for k, v in batch.items()}
    step = opt.make_train_step(lambda p, b: tr.train_loss(cfg, p, b),
                               opt.AdamWConfig())
    q1, _, rm = step(plain, opt.init(plain, opt.AdamWConfig()), ref_b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k].full_tensor()), float(rm[k]),
                                   rtol=1e-5)
    jl = JT.train_loss(jcfg, jax.tree.map(jnp.asarray, tree),
                       {k: jnp.asarray(v.numpy()) for k, v in ref_b.items()})
    np.testing.assert_allclose(float(m["loss"].full_tensor()), float(jl),
                               rtol=1e-5)
    wq = p1["layers"]["wq"]
    assert list(wq.placements) == shd.placements(
        mesh, shd.lm_param_specs(cfg)["layers"]["wq"])
    _close(wq.full_tensor().numpy(), q1["layers"]["wq"].numpy())


def test_one_rank_mesh_moe_ep_forward_matches_jax(one_rank):
    """Qwen2-MoE smoke (``dispatch="ep"``) on the one-rank mesh: the
    MoE layers take ``moe_ffn_ep`` (its all-to-alls over a group of
    one) and the hidden states and aux equal JAX's ``forward`` under
    ``use_dp_axes`` on a one-device mesh, which takes the reference's
    'ep' route, to 1e-5."""
    mesh = one_rank
    jcfg, cfg, tree = _lm("qwen2-moe-a2.7b")
    assert cfg.moe.dispatch == "ep"
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(jmesh), jax_use_dp_axes(("data",), mesh=jmesh):
        jh, jaux = JT.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(toks))
    params = shd.distribute_tree(tr.params_from_numpy(cfg, tree, "cpu"),
                                 mesh, shd.lm_param_specs(cfg))
    t = shd.distribute(torch.from_numpy(toks), shd.NamedSharding(
        mesh, shd.lm_batch_spec(mesh)["tokens"]))
    calls = []
    real = moe.ep_dispatch

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    moe.ep_dispatch = spy
    try:
        with use_dp_axes(dp_axes(mesh), mesh=mesh), torch.no_grad():
            h, aux = tr.forward(cfg, params, t)
    finally:
        moe.ep_dispatch = real
    assert len(calls) == cfg.n_layers
    _close(h.full_tensor().numpy(), np.asarray(jh))
    np.testing.assert_allclose(float(aux.full_tensor()), float(jaux),
                               rtol=1e-5)


def test_one_rank_mesh_wide_deep_step_matches_unsharded_and_jax(one_rank):
    """A Wide&Deep train step with its 8,192-row tables row-sharded over
    'model' (sparse_vocab 256): loss equal to the unsharded port step's
    and JAX's ``train_loss`` to 1e-5, the updated tables to 1e-5 of
    their largest magnitude."""
    mesh = one_rank
    arch = "wide-deep"
    jcfg = dataclasses.replace(jax_smoke_config(arch), sparse_vocab=256,
                               dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), sparse_vocab=256,
                              dtype="float32")
    tree = jax.tree.map(np.asarray, jrecsys.init_params(
        jcfg, jax.random.PRNGKey(0)))
    shape = dataclasses.replace(get_shape(cfg, "train_batch"),
                                global_batch=16)
    wl = build_recsys(cfg, shape, "cpu", mesh=mesh)
    spec = shd.recsys_param_specs(cfg, tree)
    assert spec["tables"] == shd.P("model", None)
    plain = recsys.params_from_numpy(cfg, tree, "cpu")
    params = shd.distribute_tree(plain, mesh, spec)
    batch = wl.args[2]
    p1, _, m = wl.fn(params, opt.init(params, opt.AdamWConfig()), batch)
    ref_b = {k: v.full_tensor() for k, v in batch.items()}
    step = opt.make_train_step(lambda p, b: recsys.train_loss(cfg, p, b),
                               opt.AdamWConfig())
    q1, _, rm = step(plain, opt.init(plain, opt.AdamWConfig()), ref_b)
    np.testing.assert_allclose(float(m["loss"].full_tensor()),
                               float(rm["loss"]), rtol=1e-5)
    jl = jrecsys.train_loss(jcfg, jax.tree.map(jnp.asarray, tree),
                            {k: jnp.asarray(v.numpy())
                             for k, v in ref_b.items()})
    np.testing.assert_allclose(float(m["loss"].full_tensor()), float(jl),
                               rtol=1e-5)
    _close(p1["tables"].full_tensor().numpy(), q1["tables"].numpy())


@pytest.mark.parametrize("shape_name,cut", [
    ("full_graph_sm", dict(n_nodes=40, n_edges=90)),
    ("minibatch_lg", dict(n_nodes=200, n_edges=1000, batch_nodes=8,
                          fanout=(3, 2))),
    ("molecule", dict(global_batch=6, n_nodes=7, n_edges=12))])
def test_one_rank_mesh_gnn_step_matches_unsharded_and_jax(one_rank,
                                                          shape_name, cut):
    """A GraphSAGE smoke train step through ``build_gnn(mesh=)`` on the
    one-rank mesh for each kind (the shape cut to a few nodes, d_feat
    8), JAX's weights: loss and grad norm equal the unsharded port
    step's to 1e-5 and the loss JAX's on the same batch (the full
    graph's label-masked cross-entropy as a masked sum over the classes,
    the molecules by whole graphs a rank); the updated weights to 1e-5
    of their largest magnitude."""
    mesh = one_rank
    jcfg = jax_smoke_config("graphsage-reddit")
    cfg = smoke_config("graphsage-reddit")
    tree = jax.tree.map(np.asarray, jgnn.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    shape = dataclasses.replace(get_shape(cfg, shape_name),
                                d_feat=cfg.d_feat, **cut)
    wl = build_gnn(cfg, shape, "cpu", mesh=mesh)
    plain = gnn.params_from_numpy(cfg, tree, "cpu")
    params = shd.distribute_tree(plain, mesh, shd.gnn_param_specs(cfg, tree))
    batch = wl.args[2]
    p1, _, m = wl.fn(params, opt.init(params, opt.AdamWConfig()), batch)
    ref_b = {k: v.full_tensor() for k, v in batch.items()}
    loss = {"full_graph": gnn.full_graph_loss, "minibatch": gnn.minibatch_loss,
            "batched_graphs": gnn.batched_graphs_loss}[shape.kind]
    jloss = {"full_graph": jgnn.full_graph_loss,
             "minibatch": jgnn.minibatch_loss,
             "batched_graphs": jgnn.batched_graphs_loss}[shape.kind]
    step = opt.make_train_step(lambda p, b: loss(cfg, p, b),
                               opt.AdamWConfig())
    q1, _, rm = step(plain, opt.init(plain, opt.AdamWConfig()), ref_b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k].full_tensor()), float(rm[k]),
                                   rtol=1e-5)
    jl = jloss(jcfg, jax.tree.map(jnp.asarray, tree),
               {k: jnp.asarray(v.numpy()) for k, v in ref_b.items()})
    np.testing.assert_allclose(float(m["loss"].full_tensor()), float(jl),
                               rtol=1e-5)
    for got, want in ((p1["layers"][0]["w_neigh"], q1["layers"][0]["w_neigh"]),
                      (p1["head"], q1["head"])):
        _close(got.full_tensor().numpy(), want.numpy())


def test_restore_onto_placements_reshards(tmp_path):
    """A checkpoint of plain tensors restores onto DTensor placements of
    a 2x2 mesh and of a 4x2 mesh (fake groups, rank 0): each leaf comes
    back placed by its spec, rank 0's shard the matching block of the
    saved value (the reference's elastic reshard)."""
    w = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    b = torch.arange(5, dtype=torch.int32)
    ck.save(tmp_path, 3, {"w": w, "b": b})
    like = {"w": torch.empty(8, 12), "b": torch.empty(5, dtype=torch.int32)}
    for shape in ((2, 2), (4, 2)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=shape[0] * shape[1])
        try:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            out = ck.restore(tmp_path, 3, like, shardings=shd.tree_shardings(
                mesh, {"w": shd.P("data", "model"), "b": shd.P()}))
            rows, cols = 8 // shape[0], 12 // shape[1]
            assert out["w"].shape == w.shape
            assert torch.equal(out["w"].to_local(), w[:rows, :cols])
            assert torch.equal(out["b"].to_local(), b)
        finally:
            dist.destroy_process_group()
    plain = ck.restore(tmp_path, 3, like, shardings={"w": "cpu", "b": "cpu"})
    assert torch.equal(plain["w"], w)


def test_train_devices_two_ranks_match_one_process(tmp_path):
    """``python -m repro_torch.launch.train --devices 2 --device cpu
    --smoke --steps 2``: two gloo ranks on a (1, 2) mesh through a
    FileStore; rank 0's lines name the mesh, and its loss and grad-norm
    rows equal the one-process run's to 1e-3 relative (bf16 weights,
    sums over the 'model' ranks in another order)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--steps", "2"]
    runs = [subprocess.run(cmd + extra, capture_output=True, text=True,
                           env=env, timeout=240, cwd=ROOT)
            for extra in (["--devices", "2"], [])]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    two, one = ([ln.split() for ln in r.stdout.splitlines()
                 if ln.startswith("step")] for r in runs)
    assert "mesh {'data': 1, 'model': 2}" in runs[0].stdout
    assert len(two) == len(one) == 1
    for a, b in zip(two, one):
        np.testing.assert_allclose([float(a[3]), float(a[5])],
                                   [float(b[3]), float(b[5])], rtol=1e-3)


def _narrow_lm():
    """2 layers, 8 query / 2 kv heads of 16: on a 16-wide 'model' axis
    the heads do not split whole (the regrouping of the attention
    path)."""
    return dataclasses.replace(
        smoke_config("qwen3-1.7b"), n_heads=8, n_kv_heads=2, head_dim=16,
        d_model=128, d_ff=256, vocab_size=1024)


def test_narrow_cells_count_on_the_production_meshes():
    """On the 256- and 512-rank meshes (fake groups, meta, one after the
    other): the narrow LM's train step and the MoE smoke config's (the
    EP route) count without error, with all-gathers, all-to-alls for EP,
    per-rank FLOPs below an eighth of the one-card count, and the
    3-layer count equal to the 1- and 2-layer extrapolation in FLOPs and
    collective bytes."""
    for mesh_name, cfg in itertools.product(
            ("single", "multi"),
            (_narrow_lm(), smoke_config("qwen2-moe-a2.7b"))):
        with dryrun.production_mesh(mesh_name) as mesh:
            shape = dataclasses.replace(get_shape(cfg, "train_4k"),
                                        global_batch=mesh.size(),
                                        seq_len=64)
            counts = {L: dryrun.count(build_lm(
                dataclasses.replace(cfg, n_layers=L), shape, "meta",
                mesh=mesh)) for L in (1, 2, 3)}
            coll = counts[3].count_collectives()
            assert coll["all-gather"] > 0
            assert (coll["all-to-all"] > 0) == cfg.is_moe
            for get in (lambda p: p.flops(),
                        lambda p: p.collective_bytes()["total"]):
                ext = dryrun._extrapolate(get(counts[1]), get(counts[2]), 3)
                assert ext == pytest.approx(get(counts[3]), rel=1e-9)
            one_card = dryrun.count(build_lm(
                dataclasses.replace(cfg, n_layers=3), shape, "meta"))
            assert counts[3].flops() < one_card.flops() / 8
    assert not dist.is_initialized()
