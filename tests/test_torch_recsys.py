"""Port parity: the recsys slice (Wide&Deep serving and retrieval, the
embedding bag and its kernel's plain version) against the JAX package on
the CPU. Inputs are made with numpy from a seed and handed to both.

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
  1e-6 of each other (counted and reported; there are none here)."""
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
from repro.launch.workloads import _recsys_flops as jax_recsys_flops
from repro.models import recsys as JR
from repro_torch.configs import (RECSYS_SHAPES, get_arch, get_shape,
                                 smoke_config)
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.launch.workloads import (_recsys_flops, build_recsys,
                                          build_workload)
from repro_torch.models import recsys as PR

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
    lambda: PR.init_params(smoke_config("sasrec"), device="cpu"),
    lambda: PR.init_params(smoke_config("mind"), device="cpu"),
    lambda: PR.init_params(smoke_config("bst"), device="cpu"),
    lambda: PR.serve_scores(smoke_config("bst"), {}, {}),
    lambda: PR.train_loss(smoke_config("wide-deep"), {}, {}),
    lambda: build_workload("wide-deep", "train_batch", device="cpu"),
    lambda: build_workload("sasrec", "serve_p99", device="cpu"),
    lambda: build_workload("qwen3-1.7b", "prefill_32k", device="cpu"),
    lambda: build_workload("graphsage-reddit", "full_graph_sm",
                           device="cpu"),
])
def test_unported_paths_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call()
