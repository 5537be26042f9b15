"""The attention backward's plain versions and meta branch, and the
sharded ``max`` aggregator, against the JAX package on the CPU.

- ``flash_attention_bwd_ref`` (the backward kernel's formulas in fp32)
  against ``jax.vjp`` of ``repro.models.attention.causal_attention`` at
  G 1, 2 and 5, D 64 and 128, ragged S and a chunked reference;
  ``flash_attention_lse_ref`` against ``jax.nn.logsumexp`` of the
  reference's scores. Tolerance: 1e-5 of each gradient's (or the lse's)
  largest magnitude, fp32 sums taken in other orders;
- on meta: ``FlashAttention``'s backward records
  ``kernel_costs.flash_attention_bwd`` once and makes no (S, S) tensor,
  and a Qwen3 smoke train step's counted peak falls below the plain
  recompute's; the cost formulas; the backward wrapper refuses CPU
  tensors (its kernel runs on the card only);
- GraphSAGE's ``max`` over sharded edges (``gnn.EdgeMax``) on 4
  simulated ranks of a (2, 2) mesh, each a fake process group of its
  own holding its real edges, with ``all_reduce_over`` simulated (the
  chain of collectives run to its fixed point, one pass a collective):
  the maxima equal JAX's ``segment_max`` bit for bit, -inf for an empty
  segment, and the features' gradient summed over the ranks equals the
  unsharded port's and JAX's, a maximum tied across two ranks included;
  the full-graph logits against JAX's; and on an in-process gloo group
  of one rank, the real collectives against the unsharded port.

No ``jax.jit`` of the test's own; one thread, and the module's threads
held to one core (JAX's eager compiles would otherwise spread over the
cores that the parallel suite's timing-sensitive property tests use).
"""
import dataclasses
import itertools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import gnn as jgnn
from repro_torch.analysis import kernel_costs as KC
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counter import ProgramCounter
from repro_torch.configs import get_shape, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import backward as flash_bwd
from repro_torch.kernels.flash_attention.ops import FlashAttention, attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_lse_ref)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.workloads import build_lm
from repro_torch.models import gnn
from repro_torch.models.attention import causal_attention

torch.set_num_threads(1)
N_RANKS = 4
MESH = (2, 2)


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


def _qkv(B, S, H, K, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                      (B, S, H, D))]


# (B, S, H, K, D, reference chunk): G 1 / 2 / 5, D 64 / 128, S 17 and
# 23 (ragged against the kernels' 64-key tiles), and S 32 in chunks of 8
# (the reference's triangular block schedule)
BWD_CASES = [(2, 17, 4, 4, 64, 1024), (1, 32, 4, 2, 128, 8),
             (2, 23, 10, 2, 64, 1024)]


@pytest.mark.parametrize("B,S,H,K,D,chunk", BWD_CASES)
def test_bwd_ref_matches_jax_vjp(B, S, H, K, D, chunk):
    """dq, dk, dv of the plain backward (from the plain forward's output
    and log-sum-exp) against ``jax.vjp`` of the reference attention on
    the same numpy inputs and output gradient, each within 1e-5 of its
    largest magnitude."""
    q, k, v, do = _qkv(B, S, H, K, D, seed=S + H)
    _, vjp = jax.vjp(lambda a, b, c: jattn.causal_attention(
        a, b, c, chunk=chunk), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = causal_attention(tq, tk, tv)
    got = flash_attention_bwd_ref(tq, tk, tv, o,
                                  flash_attention_lse_ref(tq, tk), tdo)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("B,S,H,K,D", [(2, 23, 10, 2, 64),
                                       (1, 65, 16, 8, 128)])
def test_lse_ref_matches_jax_logsumexp(B, S, H, K, D):
    """The plain log-sum-exp, (B, H, S), against ``jax.nn.logsumexp``
    of the reference's scaled, causally masked scores (q head h reads kv
    head h // G), within 1e-5 of its largest magnitude."""
    q, k, _, _ = _qkv(B, S, H, K, D, seed=7)
    G = H // K
    s = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), G, axis=2)) * D ** -0.5
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k))
    assert got.shape == (B, H, S) and got.dtype == torch.float32
    _close(got.numpy(), want)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_meta_backward_records_its_cost_and_makes_no_square():
    """``attention`` under autograd on meta tensors (B 1, S 1024, H 4,
    Kv 2, D 64, bf16): the forward's and the backward's meta branches
    each record once with their formulas (the forward with its
    log-sum-exp), the gradients have the inputs' shapes and dtypes, and
    no op makes a tensor of S x S elements or more (the plain
    recompute's scores are (B, Kv, G, S, S))."""
    B, S, H, K, D = 1, 1024, 4, 2, 64

    def leaf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16,
                           device="meta").requires_grad_(True)
    q, k, v = leaf(B, S, H, D), leaf(B, S, K, D), leaf(B, S, K, D)
    pc, seen = ProgramCounter(), _Shapes()
    with pc, seen:
        out = attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    for name, cost in (
            ("flash_attention", KC.flash_attention(B, S, H, K, D, lse=True)),
            ("flash_attention_bwd", KC.flash_attention_bwd(B, S, H, K, D))):
        assert pc.kernels[name] == {"calls": 1, "flops": cost.flops,
                                    "bytes": cost.bytes,
                                    "dtype": "bfloat16"}, name
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
    assert max(math.prod(s) for s in seen.shapes) < S * S


def _plain_backward(ctx, grad):
    """The backward this Function had before its kernel: the plain
    attention recomputed on the saved inputs and differentiated."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors[:3])
        return torch.autograd.grad(causal_attention(q, k, v), (q, k, v),
                                   grad)


def test_meta_train_step_peak_falls_below_the_plain_recompute(monkeypatch):
    """A Qwen3 smoke train step (head dim 64, B 2 x S 512, remat) counted
    on meta: the backward's meta branch records once a layer, no other
    kernel's backward runs, and the counted peak is below the same
    step's with the plain recompute in the backward (its fp32 (B, Kv,
    G, S, S) scores and softmax), by at least one such score tensor."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), head_dim=64)
    shape = dataclasses.replace(get_shape(cfg, "train_4k"), seq_len=512)
    B, S = 2, shape.seq_len

    def peak():
        wl = build_lm(cfg, shape, device="meta", batch=B)
        pc = dryrun.count(wl)
        return pc, rl.memory_summary(pc)["peak_bytes_est"]
    pc, kernel_peak = peak()
    assert pc.kernels["flash_attention_bwd"]["calls"] == cfg.n_layers
    assert pc.kernels["flash_attention"]["calls"] == 2 * cfg.n_layers
    monkeypatch.setattr(FlashAttention, "backward",
                        staticmethod(_plain_backward))
    pc_plain, plain_peak = peak()
    assert "flash_attention_bwd" not in pc_plain.kernels
    scores = B * cfg.n_heads * S * S * 4
    assert kernel_peak + scores <= plain_peak, (kernel_peak, plain_peak)


def test_cost_formulas_and_the_cpu_refusal():
    """``flash_attention_bwd`` at the train shape (B 2, S 4096, H 16, Kv
    8, D 128, bf16): 10 D operations a causal pair, q, o, dO, dq and k,
    v, dk, dv moved once and the lse read, bound by operations at
    0.3475 ms (PERF.md section 6, row 8); ``flash_attention_fwd_bwd`` is
    the forward with its lse plus the backward. The backward wrapper
    refuses CPU tensors and counts no launch."""
    B, S, H, K, D = 2, 4096, 16, 8, 128
    pairs = S * (S + 1) // 2
    bwd = KC.flash_attention_bwd(B, S, H, K, D)
    assert bwd.flops == 10 * B * H * D * pairs
    assert bwd.bytes == 2 * 4 * B * S * D * (H + K) + 4 * B * H * S
    ms, by = bwd.bound()
    assert by == "operations" and abs(ms - 0.3475) <= 0.5e-4
    fwd = KC.flash_attention(B, S, H, K, D, lse=True)
    both = KC.flash_attention_fwd_bwd(B, S, H, K, D)
    assert both == KC.Cost(fwd.flops + bwd.flops, fwd.bytes + bwd.bytes,
                           "bfloat16")
    assert fwd.bytes == KC.flash_attention(B, S, H, K, D).bytes \
        + 4 * B * H * S
    t = torch.zeros((1, 8, 2, 64))
    before = flash_bwd.launches
    with pytest.raises(ValueError, match="want q's CUDA device"):
        flash_bwd.flash_attention_bwd(t, t, t, t, torch.zeros((1, 2, 8)), t)
    assert flash_bwd.launches == before


# ---------------------------------------------------------------------------
# GraphSAGE's max over sharded edges
# ---------------------------------------------------------------------------

def _fake_rank(rank: int):
    """Rank ``rank`` of a fake process group of 4 and its (2, 2) mesh:
    a DTensor placed there holds this rank's real block; no collective
    carries data."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=N_RANKS)
    return init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))


def _on_four_ranks(monkeypatch, run, n_collectives: int):
    """``run(rank, mesh)`` on each of the 4 ranks, ``n_collectives + 1``
    times, with ``gnn.all_reduce_over`` simulated: pass p gives the i-th
    call the reduction over the ranks of what they handed to their i-th
    call in pass p - 1 (pass 0: its own tensor), so after one pass a
    link of the chain every call has its true result. Returns the last
    pass's results by rank."""
    sent = None
    for _ in range(n_collectives + 1):
        now, out = [[] for _ in range(N_RANKS)], []
        for r in range(N_RANKS):
            calls = itertools.count()

            def reduce(t, mesh, op, r=r, calls=calls, prev=sent):
                i = next(calls)
                now[r].append(t.detach().clone())
                if prev is None:
                    return t.clone()
                parts = torch.stack([prev[x][i] for x in range(N_RANKS)])
                return parts.amax(0) if op == "max" else parts.sum(0)
            monkeypatch.setattr(gnn, "all_reduce_over", reduce)
            mesh = _fake_rank(r)
            try:
                out.append(run(r, mesh))
            finally:
                dist.destroy_process_group()
        sent = now
    return out


def _max_case():
    """12 nodes, 6 features with integer values (ties everywhere), 32
    edges (8 a rank); node 5 receives no edge; segment 3's maximum, 5 in
    every feature, comes from edge 0 (rank 0) and edge 20 (rank 2)."""
    rng = np.random.default_rng(3)
    n, F, E = 12, 6, 32
    feats = rng.integers(-2, 3, (n, F)).astype(np.float32)
    feats[1] = feats[2] = 5.0
    src = rng.choice([x for x in range(n) if x not in (1, 2)], E)
    dst = rng.choice([x for x in range(n) if x != 5], E)
    src[[0, 20]], dst[[0, 20]] = (1, 2), 3
    w = rng.standard_normal((n, F)).astype(np.float32)
    return n, feats, src.astype(np.int64), dst.astype(np.int64), w


def _masked_loss(out, w):
    return torch.where(torch.isfinite(out), out * w, 0.0).sum()


def test_sharded_max_on_four_ranks_matches_jax_and_unsharded(monkeypatch):
    """``_aggregate`` with the max over edges sharded over both axes of
    the (2, 2) mesh: on every rank the maxima equal JAX's
    ``segment_max`` bit for bit (-inf at the empty segment 5), and the
    features' gradient of sum(out * w) over the finite outputs, summed
    over the ranks (each rank's share is Partial), equals the unsharded
    port's (autograd of ``amax``) and JAX's ``jax.grad`` within 1e-6 of
    its largest magnitude; segment 3's tie across ranks 0 and 2 gives
    each of its two edges half of the gradient."""
    n, feats, src, dst, w = _max_case()
    cfg = dataclasses.replace(smoke_config("graphsage-reddit"),
                              aggregator="max")
    edge_axes = shd.NamedSharding
    tw = torch.from_numpy(w)

    def run(r, mesh):
        leaf = torch.from_numpy(feats).requires_grad_(True)
        f = DTensor.from_local(leaf, mesh, [Replicate()] * 2,
                               run_check=False)
        s, d = (shd.distribute(torch.from_numpy(t), edge_axes(
            mesh, shd.P(("data", "model")))) for t in (src, dst))
        assert s.to_local().shape == (8,)
        out = gnn._aggregate(cfg, f, s, d, n)
        assert isinstance(out, DTensor) and out.placements == (
            Replicate(), Replicate())
        o = out.to_local()
        _masked_loss(o, tw).backward()
        return o.detach(), leaf.grad
    res = _on_four_ranks(monkeypatch, run, n_collectives=2)

    want = np.asarray(jax.ops.segment_max(jnp.asarray(feats)[src], dst,
                                          num_segments=n))
    assert np.isneginf(want[5]).all() and (want[3] == 5.0).all()
    for o, _ in res:
        np.testing.assert_array_equal(o.numpy(), want)
    grad = sum(g for _, g in res)

    leaf = torch.from_numpy(feats).requires_grad_(True)
    plain = gnn._aggregate(cfg, leaf, torch.from_numpy(src),
                           torch.from_numpy(dst), n)
    _masked_loss(plain, tw).backward()
    _close(grad.numpy(), leaf.grad.numpy(), rel=1e-6)

    def jax_loss(x):
        o = jax.ops.segment_max(x[src], dst, num_segments=n)
        return jnp.where(jnp.isfinite(o), o * w, 0.0).sum()
    jgrad = jax.grad(jax_loss)(jnp.asarray(feats))
    _close(grad.numpy(), np.asarray(jgrad), rel=1e-6)
    # the cross-rank tie: rows 1 and 2 feed only segment 3's tied max
    assert (src == 1).sum() == (src == 2).sum() == 1
    np.testing.assert_allclose(grad[1].numpy(), w[3] / 2, rtol=1e-6)
    np.testing.assert_allclose(grad[2].numpy(), w[3] / 2, rtol=1e-6)


def test_sharded_max_full_graph_on_four_ranks_matches_jax(monkeypatch):
    """``full_graph_forward`` with the max aggregator on 4 simulated
    ranks, JAX's smoke weights replicated: 40 nodes, 92 edges (a fifth
    masked, routed to the trash segment) sharded 23 a rank; every
    rank's logits equal JAX's ``full_graph_forward`` on the same edges
    within 1e-5 of the largest finite logit, NaN at the same places (the
    nodes with no valid in-edge, whose -inf maxima the layer turns into
    NaN in both)."""
    jcfg = dataclasses.replace(jax_smoke_config("graphsage-reddit"),
                               aggregator="max")
    cfg = dataclasses.replace(smoke_config("graphsage-reddit"),
                              aggregator="max")
    tree = jax.tree.map(np.asarray, jgnn.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    n, E = 40, 92
    feats = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    edges = rng.integers(0, n, (E, 2)).astype(np.int32)
    mask = rng.random(E) < 0.8
    want = np.asarray(jgnn.full_graph_forward(
        jcfg, tree, jnp.asarray(feats), jnp.asarray(edges),
        jnp.asarray(mask)))
    assert np.isnan(want).any() and not np.isnan(want).all()

    def run(r, mesh):
        p = gnn.params_from_numpy(cfg, tree, "cpu")
        p = {"layers": [{k: shd.distribute(t, shd.NamedSharding(mesh,
                                                                 shd.P()))
                         for k, t in layer.items()}
                        for layer in p["layers"]],
             "head": shd.distribute(p["head"],
                                    shd.NamedSharding(mesh, shd.P()))}
        eax = shd.NamedSharding(mesh, shd.P(("data", "model")))
        with torch.no_grad():
            out = gnn.full_graph_forward(
                cfg, p, shd.distribute(torch.from_numpy(feats),
                                       shd.NamedSharding(mesh, shd.P())),
                shd.distribute(torch.from_numpy(edges), eax),
                shd.distribute(torch.from_numpy(mask), eax))
        return out.to_local()
    res = _on_four_ranks(monkeypatch, run, n_collectives=2 * cfg.n_layers)
    finite = np.abs(want[np.isfinite(want)]).max()
    for got in res:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * finite, equal_nan=True)


def test_sharded_max_on_a_one_rank_gloo_mesh_matches_unsharded():
    """The same aggregation through the real collectives: an in-process
    gloo group of one rank and its smoke mesh (1, 1); the maxima and the
    features' gradient equal the unsharded port's bit for bit (one rank
    adds its edges in the unsharded order)."""
    n, feats, src, dst, w = _max_case()
    cfg = dataclasses.replace(smoke_config("graphsage-reddit"),
                              aggregator="max")
    tw = torch.from_numpy(w)
    leaf = torch.from_numpy(feats).requires_grad_(True)
    want = gnn._aggregate(cfg, leaf, torch.from_numpy(src),
                          torch.from_numpy(dst), n)
    _masked_loss(want, tw).backward()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh(1)
        leaf2 = torch.from_numpy(feats).requires_grad_(True)
        f = DTensor.from_local(leaf2, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        s, d = (shd.distribute(torch.from_numpy(t), shd.NamedSharding(
            mesh, shd.P(("data", "model")))) for t in (src, dst))
        out = gnn._aggregate(cfg, f, s, d, n)
        _masked_loss(out.to_local(), tw).backward()
    finally:
        dist.destroy_process_group()
    assert torch.equal(out.to_local().detach(), want.detach())
    assert torch.equal(leaf2.grad, leaf.grad)
