"""Port parity: the recsys slice (SASRec, MIND, BST and Wide&Deep
serving and retrieval, the embedding bag, its kernel's plain version and
its backward) against the JAX package on the CPU. Inputs are made with
numpy from a seed and handed to both.

Comparisons:
- the plain bag against the JAX Pallas kernel in interpret mode and its
  jnp oracle on every BAG case of ``test_kernel_conformance.py``, at that
  family's tolerances (1e-6 fp32, 2e-2 bf16);
- the fixed-shape and ragged bags of ``models/recsys.py`` at 1e-6 (the
  port's mean weighs each id by 1/count and sums; the JAX package sums
  and divides, so the two differ by ulps);
- ``recsys_batches`` array-equal to the JAX generator;
- Wide&Deep scores and user vectors within 1e-5 with the JAX parameters
  carried over by ``params_from_numpy``; retrieval ids identical except
  where the JAX scores of the k-th and (k+1)-th candidates lie within
  1e-6 of each other (counted and reported; there are none here);
- SASRec, MIND and BST at smoke size (SASRec 2 blocks, BST 1, 128
  items): scores and user vectors within rtol 1e-5 and atol 1e-5,
  ``retrieval`` and ``retrieval_sharded`` (1 and 2 CPU shards) ids
  identical except where the JAX k-th and (k+1)-th scores lie within
  1e-5 (counted and reported), MIND's ties to the lowest position;
- the bag's backward (``embedding_bag_backward`` and autograd through
  the model's bag) against ``jax.grad`` of the jnp bag within 1e-6;
- ``build_recsys`` at every kind and shape (batches cut to 64 rows)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.configs import smoke_config as jax_smoke_config
from repro.data.recsys_data import recsys_batches as jax_recsys_batches
from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag_ops
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref
from repro.launch.workloads import _recsys_batch as jax_recsys_batch
from repro.launch.workloads import _recsys_flops as jax_recsys_flops
from repro.models import recsys as JR
from repro_torch.configs import (RECSYS_SHAPES, get_arch, get_shape,
                                 smoke_config)
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.launch.workloads import (SERVE_SLATE, _recsys_flops,
                                          build_recsys, build_workload)
from repro_torch.models import recsys as PR
from repro_torch.tree import flatten_with_path, leaves

torch.set_num_threads(1)
RECSYS_ARCHS = ("sasrec", "mind", "bst", "wide-deep")
TOL = 1e-5

# (V, d, B, m): the BAG cases (interpret-mode Pallas) and edge cases
# (public dispatch) of test_kernel_conformance.py
BAG_CASES = [(64, 32, 4, 3), (512, 128, 16, 8), (100, 16, 1, 1),
             (37, 24, 5, 7)]
BAG_EDGES = [(16, 8, 0, 3), (1, 8, 2, 2)]


def _bag_inputs(case, seed):
    V, d, B, m = case
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, m)).astype(np.int32) if B * m else \
        np.zeros((B, m), np.int32)
    w = rng.uniform(size=(B, m)).astype(np.float32)
    return table, ids, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case,interpret", [(c, True) for c in BAG_CASES]
    + [(c, False) for c in BAG_EDGES])
def test_plain_bag_matches_jax_kernel_and_oracle(case, interpret, dtype):
    table, ids, w = _bag_inputs(case, seed=sum(case))
    # both frameworks round the fp32 table to bf16 to nearest even
    jt = jnp.asarray(table).astype(dtype)
    pt = torch.from_numpy(table).to(getattr(torch, dtype))
    pi, pw = torch.from_numpy(ids), torch.from_numpy(w)
    got = embedding_bag(pt, pi, pw)
    assert got.dtype == torch.float32 and got.shape == (case[2], case[1])
    assert torch.equal(got, embedding_bag_ref(pt, pi, pw))
    want_kernel = jax_bag_ops(jt, jnp.asarray(ids), jnp.asarray(w),
                              force="interpret" if interpret else None)
    want_ref = jax_bag_ref(jt, jnp.asarray(ids), jnp.asarray(w))
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)


def test_bag_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper raises on a CPU tensor (nothing is built); only
    the ops dispatch sends CPU tensors to the plain version."""
    table, ids, w = (torch.from_numpy(a) for a in _bag_inputs(
        (16, 8, 3, 2), 0))
    with pytest.raises(ValueError, match="CUDA"):
        bag_kernel.embedding_bag(table, ids, w)


def _fixed_inputs(mask_kind, seed=3):
    rng = np.random.default_rng(seed)
    V, d, B, F, m = 50, 8, 6, 3, 4
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, F, m)).astype(np.int32)
    mask = rng.random((B, F, m)) < 0.7
    if mask_kind == "all-masked bag":
        mask[0, 1] = False
        mask[4, 2] = False
    return table, ids, None if mask_kind == "none" else mask


@pytest.mark.parametrize("mask_kind", ["mask", "none", "all-masked bag"])
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_fixed_bag_matches_jax(mode, mask_kind):
    table, ids, mask = _fixed_inputs(mask_kind)
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            None if mask is None else jnp.asarray(mask),
                            mode=mode)
    got = PR.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           None if mask is None else torch.from_numpy(mask),
                           mode=mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if mask_kind == "all-masked bag":
        assert not got[0, 1].any() and not got[4, 2].any()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_ragged_bag_matches_jax(mode):
    rng = np.random.default_rng(5)
    V, d, T, n_bags = 40, 8, 30, 9
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, V, T).astype(np.int32)
    seg = np.sort(rng.integers(0, n_bags, T)).astype(np.int32)
    seg[seg == 4] = 5                       # bag 4 stays empty
    want = JR.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(seg), n_bags, mode=mode)
    got = PR.embedding_bag_ragged(torch.from_numpy(table),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(seg), n_bags, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_batches_and_configs_match_jax(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_arch(arch)) \
        == dataclasses.asdict(jax_get_arch(arch))
    ours, theirs = recsys_batches(cfg, 7, seed=11), \
        jax_recsys_batches(jcfg, 7, seed=11)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_flops_match_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for shape in RECSYS_SHAPES:
        jshape = jax_get_shape(jcfg, shape.name)
        assert _recsys_flops(cfg, shape) == jax_recsys_flops(jcfg, jshape)


@pytest.fixture(scope="module")
def wide_deep():
    """Smoke Wide&Deep: JAX parameters (with a random wide table in
    place of the zero init, so the sum-mode bag counts) carried to the
    port, and one batch of 16 rows with the n_items = 128 items as
    retrieval candidates."""
    jcfg = jax_smoke_config("wide-deep")
    cfg = smoke_config("wide-deep")
    tree = jax.tree.map(np.asarray, JR.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    tree["wide"] = (0.1 * rng.standard_normal(tree["wide"].shape)) \
        .astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = PR.params_from_numpy(cfg, tree, "cpu")
    batch = next(recsys_batches(cfg, 16, seed=4))
    del batch["label"]
    batch["cand_ids"] = (1 + rng.permutation(cfg.n_items)).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jcfg, jparams, cfg, params, jbatch, \
        PR.batch_from_numpy(batch, "cpu")


def test_wide_deep_scores_and_user_repr_match_jax(wide_deep):
    jcfg, jparams, cfg, params, jbatch, batch = wide_deep
    want = np.asarray(JR.serve_scores(jcfg, jparams, jbatch))
    got = PR.serve_scores(cfg, params, batch)
    assert got.shape == want.shape == (16, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    want_u = np.asarray(JR.user_repr(jcfg, jparams, jbatch))
    got_u = PR.user_repr(cfg, params, batch)
    assert got_u.shape == want_u.shape == (16, cfg.embed_dim)
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=TOL, atol=TOL)


def test_wide_deep_retrieval_matches_jax(wide_deep, capsys):
    jcfg, jparams, cfg, params, jbatch, batch = wide_deep
    k = 5
    jv, ji = (np.asarray(x) for x in JR.retrieval(jcfg, jparams, jbatch,
                                                  k=k))
    v, i = PR.retrieval(cfg, params, batch, k=k)
    assert v.shape == (16, k) and i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), jv, rtol=TOL, atol=TOL)
    # the JAX scores of every candidate, to find k-th/(k+1)-th near-ties
    u = np.asarray(JR.user_repr(jcfg, jparams, jbatch))
    cand = np.asarray(jparams["item_emb"])[np.asarray(jbatch["cand_ids"])]
    full = -np.sort(-(u @ cand.T), axis=1)
    near = np.abs(full[:, k - 1] - full[:, k]) <= 1e-6
    differ = (i.numpy() != ji).any(1)
    with capsys.disabled():
        print(f"\n[recsys retrieval] {int(near.sum())} of 16 rows with a "
              f"k-th/(k+1)-th near-tie; {int(differ.sum())} rows differ")
    assert not (differ & ~near).any()


def test_build_recsys_serve_p99_on_cpu():
    cfg = smoke_config("wide-deep")
    wl = build_recsys(cfg, get_shape(cfg, "serve_p99"), device="cpu")
    scores = wl.fn(*wl.args)
    assert scores.shape == (512, 1) and bool(scores.isfinite().all())
    assert wl.model_flops == _recsys_flops(cfg, get_shape(cfg, "serve_p99"))
    nxt = next(wl.batches)
    assert set(nxt) == {"sparse_ids", "sparse_mask"}
    assert not torch.equal(nxt["sparse_ids"], wl.args[1]["sparse_ids"])


@pytest.mark.parametrize("call", [
    lambda: build_workload("qwen3-1.7b", "long_500k", device="cpu"),
    lambda: build_workload("graphsage-reddit", "train_batch",
                           device="cpu"),
    lambda: build_workload("no-such-arch", "train_4k", device="cpu"),
])
def test_unported_paths_raise(call):
    """Every (arch, shape) cell of the JAX registry builds now (the LM
    and GNN cells in ``test_torch_lm_train.py`` and
    ``test_torch_gnn.py``); a cell the registry lacks (the JAX package
    skips ``long_500k`` too) raises, naming what is available."""
    with pytest.raises(KeyError, match="available"):
        call()


# ---------------------------------------------------------------------------
# SASRec, MIND and BST
# ---------------------------------------------------------------------------

SEQ_ARCHS = ("sasrec", "mind", "bst")
N_CANDS = {"sasrec": 5, "mind": 5, "bst": 3}     # BST: 3 > its slate of 1


def _partitioned_candidates(rows, n_per, seed):
    """Candidate ids in two blocks, block s from the rows of shard s of a
    two-shard item table (row 0, the pad, left out): a list that
    ``retrieval_sharded`` takes at 1 and at 2 shards."""
    rng = np.random.default_rng(seed)
    half = rows // 2
    return np.concatenate([1 + rng.permutation(half - 1)[:n_per],
                           half + rng.permutation(half)[:n_per]]) \
        .astype(np.int32)


def numpy_params(cfg, seed):
    """Random weights of ``cfg`` as a tree of numpy arrays (the port's
    init with a seeded generator; JAX's eager init costs seconds a
    kind), handed to both packages."""
    return jax.tree.map(lambda t: t.numpy(), PR.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's parameter tree has the JAX tree's leaf paths, shapes
    and dtypes (``jax.eval_shape``: traced, nothing computed)."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    assert cfg.kind in PR.PORTED_KINDS and len(PR.PORTED_KINDS) == 4
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: JR.init_params(jcfg, k), jax.random.PRNGKey(0)))[0]
    got = flatten_with_path(PR.init_params(cfg, device="cpu"))
    assert [("/".join(p), tuple(t.shape), str(t.dtype).split(".")[1])
            for p, t in got] == \
        [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in p), tuple(t.shape), str(t.dtype))
         for p, t in want]


@pytest.fixture(scope="module", params=SEQ_ARCHS)
def seq_model(request):
    """A smoke config's weights (numpy, from a seed) in both packages,
    the port's through ``params_from_numpy``, and one batch
    of 8 rows with ``cands`` (8, N_CANDS) and 128 range-partitioned
    retrieval candidates."""
    arch = request.param
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    tree = numpy_params(cfg, seed=1)
    params = PR.params_from_numpy(cfg, tree, "cpu")
    batch = {"seq": next(recsys_batches(cfg, 8, seed=6))["seq"]}
    rng = np.random.default_rng(7)
    batch["seq"][0, :3] = 0                       # padded history
    batch["cands"] = rng.integers(1, cfg.n_items + 1,
                                  (8, N_CANDS[arch])).astype(np.int32)
    batch["cand_ids"] = _partitioned_candidates(
        tree["item_emb"].shape[0], 64, seed=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return arch, jcfg, jax.tree.map(jnp.asarray, tree), cfg, params, \
        jbatch, PR.batch_from_numpy(batch, "cpu")


def test_seq_kind_scores_and_user_repr_match_jax(seq_model):
    arch, jcfg, jparams, cfg, params, jbatch, batch = seq_model
    want = np.asarray(JR.serve_scores(jcfg, jparams, jbatch))
    got = PR.serve_scores(cfg, params, batch)
    assert got.shape == want.shape == (8, N_CANDS[arch])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    want_u = np.asarray(JR.user_repr(jcfg, jparams, jbatch))
    got_u = PR.user_repr(cfg, params, batch)
    assert got_u.shape == want_u.shape
    assert got_u.dim() == (3 if arch == "mind" else 2)
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=TOL, atol=TOL)


def _near_ties(jcfg, jparams, jbatch, k):
    """Rows whose JAX k-th and (k+1)-th candidate scores lie within
    1e-5 (a retrieval id there may differ by rounding)."""
    u = np.asarray(JR.user_repr(jcfg, jparams, jbatch))
    cand = np.asarray(jparams["item_emb"])[np.asarray(jbatch["cand_ids"])]
    full = np.einsum("b...d,nd->b...n", u, cand)
    if full.ndim == 3:
        full = full.max(1)
    full = -np.sort(-full, axis=1)
    return np.abs(full[:, k - 1] - full[:, k]) <= 1e-5


def _check_retrieval(name, got, want, near, capsys):
    v, i = got
    jv, ji = (np.asarray(x) for x in want)
    assert v.shape == i.shape == jv.shape and i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), jv, rtol=TOL, atol=TOL)
    differ = (i.numpy() != ji).any(1)
    with capsys.disabled():
        print(f"\n[{name}] {int(near.sum())} of {len(near)} rows with a "
              f"k-th/(k+1)-th near-tie; {int(differ.sum())} rows differ")
    assert not (differ & ~near).any()


def test_seq_kind_retrieval_matches_jax(seq_model, capsys):
    arch, jcfg, jparams, cfg, params, jbatch, batch = seq_model
    k = 10
    want = JR.retrieval(jcfg, jparams, jbatch, k=k)
    _check_retrieval(f"{arch} retrieval",
                     PR.retrieval(cfg, params, batch, k=k), want,
                     _near_ties(jcfg, jparams, jbatch, k), capsys)


@pytest.mark.parametrize("shards", [1, 2])
def test_seq_kind_retrieval_sharded_matches_jax(seq_model, shards, capsys):
    """The port's ``retrieval_sharded`` on ``shards`` CPU shards against
    JAX's ``retrieval`` over the same range-partitioned candidates."""
    arch, jcfg, jparams, cfg, params, jbatch, batch = seq_model
    k = 10
    want = JR.retrieval(jcfg, jparams, jbatch, k=k)
    got = PR.retrieval_sharded(cfg, params, batch,
                               make_shard_mesh(shards, device="cpu"), k=k)
    _check_retrieval(f"{arch} retrieval_sharded S={shards}", got, want,
                     _near_ties(jcfg, jparams, jbatch, k), capsys)


def test_mind_retrieval_ties_go_to_the_lowest_position():
    """Duplicated candidates score alike; the top-k keeps them in
    candidate-list order, as ``jax.lax.top_k`` does."""
    jcfg, cfg = jax_smoke_config("mind"), smoke_config("mind")
    tree = numpy_params(cfg, seed=2)
    params = PR.params_from_numpy(cfg, tree, "cpu")
    seq = next(recsys_batches(cfg, 8, seed=3))["seq"]
    rng = np.random.default_rng(4)
    base = (1 + rng.permutation(cfg.n_items)[:12]).astype(np.int32)
    cand_ids = np.concatenate([base, base[::-1], base]).astype(np.int32)
    batch = {"seq": seq, "cand_ids": cand_ids}
    k = 9
    jv, ji = JR.retrieval(jcfg, jax.tree.map(jnp.asarray, tree),
                          {n: jnp.asarray(v) for n, v in batch.items()},
                          k=k)
    v, i = PR.retrieval(cfg, params, PR.batch_from_numpy(batch, "cpu"), k=k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL,
                               atol=TOL)
    # each id of the top-k appears three times among the candidates;
    # the ties are exact, so the three copies come in position order
    u = PR.user_repr(cfg, params, PR.batch_from_numpy(batch, "cpu"))
    cand = params["item_emb"][torch.from_numpy(cand_ids).long()]
    scores = torch.einsum("bkd,cd->bkc", u, cand).amax(1)
    for row in range(8):
        top = scores[row].argsort(descending=True, stable=True)[:k]
        assert torch.equal(i[row], torch.from_numpy(cand_ids)[top])
        assert len(set(i[row].tolist())) == 3


# ---------------------------------------------------------------------------
# the bag's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["mask", "none", "all-masked bag"])
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_bag_backward_matches_jax_grad(mode, mask_kind):
    """The table's gradient of sum(bag * G): ``embedding_bag_backward``
    (the CUDA bag's backward, on the CPU) and autograd through the
    model's bag against ``jax.grad`` of the jnp bag."""
    table, ids, mask = _fixed_inputs(mask_kind)
    G = np.random.default_rng(11).standard_normal(
        ids.shape[:-1] + (table.shape[1],)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax.grad(lambda t: jnp.sum(JR.embedding_bag(
        t, jnp.asarray(ids), jm, mode=mode) * G))(jnp.asarray(table)))
    pids = torch.from_numpy(ids)
    pmask = None if mask is None else torch.from_numpy(mask)
    m = ids.shape[-1]
    w = PR.bag_weights(pids, pmask, mode).reshape(-1, m)
    got = embedding_bag_backward(torch.from_numpy(G).reshape(-1, G.shape[-1]),
                                 pids.reshape(-1, m), w, table.shape[0])
    assert got.shape == table.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(table).requires_grad_(True)
    torch.sum(PR.embedding_bag(t, pids, pmask, mode=mode)
              * torch.from_numpy(G)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bag_refuses_weights_that_need_a_gradient():
    table, ids, w = (torch.from_numpy(a) for a in _bag_inputs(
        (16, 8, 3, 2), 0))
    with pytest.raises(ValueError, match="require grad"):
        embedding_bag(table, ids, w.requires_grad_(True))


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_name", [s.name for s in RECSYS_SHAPES])
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_build_recsys_every_kind_and_shape_on_cpu(arch, shape_name):
    """Every recsys cell builds and runs on the CPU (smoke config, 64
    rows a batch): the JAX ``_recsys_batch`` keys, ``cands`` in
    [1, n_items], train steps that change every parameter leaf."""
    cfg = smoke_config(arch)
    shape = dataclasses.replace(get_shape(cfg, shape_name),
                                global_batch=min(64, get_shape(
                                    cfg, shape_name).global_batch))
    wl = build_recsys(cfg, shape, device="cpu", seed=3)
    assert wl.model_flops == _recsys_flops(cfg, shape)
    batch = wl.args[-1]
    jkeys = set(jax_recsys_batch(jax_smoke_config(arch), shape.kind, 4, 16))
    assert set(batch) == jkeys
    nxt = next(wl.batches)
    assert set(nxt) == jkeys
    if "cands" in batch:
        c = batch["cands"]
        assert c.shape == (64, SERVE_SLATE[cfg.kind]) and \
            c.dtype == torch.int32
        assert int(c.min()) >= 1 and int(c.max()) <= cfg.n_items
        assert not torch.equal(c, nxt["cands"])
    out = wl.fn(*wl.args)
    if shape.kind == "train":
        params, opt_state, metrics = out
        assert bool(metrics["loss"].isfinite()) \
            and bool(metrics["grad_norm"].isfinite())
        assert int(opt_state["step"]) == 1
        assert all(not torch.equal(a, b) for a, b in
                   zip(leaves(wl.args[0]), leaves(params)))
    elif shape.kind == "serve":
        assert out.shape == (64, SERVE_SLATE[cfg.kind])
        assert bool(out.isfinite().all())
    else:
        v, i = out
        assert v.shape == i.shape == (1, 100)
        assert bool((i >= 1).all() and (i <= cfg.n_items).all())

