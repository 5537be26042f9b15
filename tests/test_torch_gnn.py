"""Port parity: GraphSAGE (``models/gnn.py``, ``data/graph_data.py``, the
GNN configs and ``build_gnn``) against the JAX package on the CPU.

Weights are JAX's ``init_params`` carried across by
``params_from_numpy``; graphs and batches come from the numpy generator,
whose port copy is held bit for bit. The JAX functions run eagerly (no
``jax.jit``), with every thread of this process held to one core while
this file runs (as ``test_torch_moe.py`` does).

Tolerances: forward logits within 1e-5 (absolute, logits are O(1));
a loss within rtol 1e-5; a gradient leaf within 1e-4 * max|g_ref| +
1e-7 (the segment sums add in another order); after an AdamW step,
params within 1e-2 * lr absolute. The max aggregator's empty segments
must give JAX's ``-inf``, so an isolated node's logits are NaN in both
packages at the same places.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.data import graph_data as JD
from repro.launch.mesh import make_smoke_mesh
from repro.launch.workloads import build_gnn as jax_build_gnn
from repro.models import gnn as JG
from repro.training import optimizer as JO
from repro_torch import configs as PCFG
from repro_torch.data import graph_data as PD
from repro_torch.launch.workloads import ADAMW, build_gnn
from repro_torch.models import gnn as PG
from repro_torch.training import optimizer as PO
from repro_torch.tree import flatten_with_path, tree_map

torch.set_num_threads(1)
ARCH = "graphsage-reddit"
LR = PO.AdamWConfig().lr


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


@pytest.fixture(scope="module")
def model():
    """The smoke config (d_hidden 16, d_feat 8, 5 classes) in both
    packages and JAX's weights as numpy."""
    jcfg, cfg = JCFG.smoke_config(ARCH), PCFG.smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, JG.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def _with(cfgs, aggregator):
    return tuple(dataclasses.replace(c, aggregator=aggregator) for c in cfgs)


def _jax_named(tree) -> dict:
    """Leaves by path; ``jax.ShapeDtypeStruct`` leaves stay as they are."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path):
            v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v)
            for path, v in flat}


def _sig(named: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in named.items()}


def _port_named(tree) -> dict:
    return {"/".join(p): v.detach().numpy()
            for p, v in flatten_with_path(tree)}


def _close_grads(got, want):
    got, want = _port_named(got), _jax_named(want)
    assert got.keys() == want.keys()
    for name, g in want.items():
        tol = 1e-4 * float(np.abs(g).max()) + 1e-7
        err = float(np.abs(got[name] - g).max())
        assert err <= tol, (name, err, tol)


def _loss_and_grads(jfn, pfn, tree, cfg, batch):
    """(JAX loss, JAX grads, port loss, port grads) of ``fn(cfg, params,
    batch)`` on the same weights and batch."""
    jcfg, pcfg = cfg
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: jfn(jcfg, p, jb))(
        jax.tree.map(jnp.asarray, tree))
    pb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    pl, pg = PO.value_and_grad(lambda p, b: pfn(pcfg, p, b))(
        PG.params_from_numpy(pcfg, tree, "cpu"), pb)
    return jl, jg, pl, pg


def _graph(seed=3, n=24, isolated=None):
    """A synthetic graph of ``n`` nodes (5 classes, d_feat 8) with every
    node given one more in-edge, one edge doubled (a tied max), and,
    when ``isolated`` is a node, every in-edge of that node removed.
    Returns (feats, edges int32, edge_mask with a fifth of the edges
    masked but never a node's added edge, labels)."""
    g = PD.synthetic_graph(n, 3, 8, 5, seed)
    rng = np.random.default_rng(seed)
    cover = np.stack([rng.integers(0, n, n), np.arange(n)], 1)
    edges = np.concatenate([g.edges, g.edges[:1], cover]).astype(np.int32)
    mask = np.concatenate([rng.random(len(g.edges) + 1) < 0.8,
                           np.ones(n, bool)])
    if isolated is not None:
        keep = edges[:, 1] != isolated
        edges, mask = edges[keep], mask[keep]
    return g.feats, edges, mask, g.labels


# --- data and configs --------------------------------------------------------

def test_graph_data_matches_reference_bit_for_bit():
    for args in ((50, 4, 8, 5, 0), (300, 7, 16, 41, 5)):
        a, b = JD.synthetic_graph(*args), PD.synthetic_graph(*args)
        for f in ("edges", "feats", "labels", "indptr", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (args, f)
        sa = JD.NeighborSampler(a, (4, 3), 2).batches(16, 9)
        sb = PD.NeighborSampler(b, (4, 3), 2).batches(16, 9)
        for _ in range(2):
            ba, bb = next(sa), next(sb)
            assert ba.keys() == bb.keys()
            for k in ba:
                assert ba[k].dtype == bb[k].dtype \
                    and np.array_equal(ba[k], bb[k]), k
    ma, mb = JD.batched_molecules(6, 9, 14, 8, 5, 4), \
        PD.batched_molecules(6, 9, 14, 8, 5, 4)
    for k in ma:
        assert ma[k].dtype == mb[k].dtype and np.array_equal(ma[k], mb[k])


def test_config_copies_and_registry_match_jax():
    assert dataclasses.asdict(PCFG.GRAPHSAGE_REDDIT) == \
        dataclasses.asdict(JCFG.GRAPHSAGE_REDDIT)
    assert dataclasses.asdict(PCFG.smoke_config(ARCH)) == \
        dataclasses.asdict(JCFG.smoke_config(ARCH))
    assert PCFG.smoke_config_for(ARCH, "cuda") == PCFG.smoke_config(ARCH)
    assert [dataclasses.asdict(s) for s in PCFG.GNN_SHAPES] == \
        [dataclasses.asdict(s) for s in JCFG.GNN_SHAPES]
    assert list(PCFG.ARCHS) == list(JCFG.ARCHS)
    assert list(PCFG.all_cells()) == list(JCFG.all_cells())


def test_init_params_tree_matches_jax_eval_shape():
    cfg = PCFG.smoke_config(ARCH)
    for d_feat in (None, 13):
        want = jax.eval_shape(lambda: JG.init_params(
            JCFG.smoke_config(ARCH), jax.random.PRNGKey(0), d_feat=d_feat))
        got = PG.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             d_feat=d_feat)
        assert _sig(_port_named(got)) == _sig(_jax_named(want))


# --- the three regimes -----------------------------------------------------

@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_full_graph_forward_loss_and_gradients_match_jax(model, aggregator):
    """``full_graph_forward`` with and without ``edge_mask`` on a graph
    with an isolated node (max: NaN at the same places as JAX, from
    JAX's ``-inf`` empty segment), then the loss (a label mask with
    holes) and every gradient leaf on a graph without one (max: one
    doubled edge, whose tied gradient both packages split)."""
    jcfg, cfg, tree = model
    jcfg, cfg = _with((jcfg, cfg), aggregator)
    params = PG.params_from_numpy(cfg, tree, "cpu")
    feats, edges, mask, _ = _graph(isolated=5)
    for m in (None, mask):
        want = np.asarray(JG.full_graph_forward(
            jcfg, tree, jnp.asarray(feats), jnp.asarray(edges),
            None if m is None else jnp.asarray(m)))
        got = PG.full_graph_forward(
            cfg, params, torch.from_numpy(feats), torch.from_numpy(edges),
            None if m is None else torch.from_numpy(m)).numpy()
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert nan.any() == (aggregator == "max")
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=1e-5)
    feats, edges, mask, labels = _graph()
    batch = {"feats": feats, "edges": edges, "edge_mask": mask,
             "labels": labels, "label_mask": np.arange(len(labels)) % 3 > 0}
    for b in (batch, {k: batch[k] for k in ("feats", "edges", "labels")}):
        jl, jg, pl, pg = _loss_and_grads(JG.full_graph_loss,
                                         PG.full_graph_loss, tree,
                                         (jcfg, cfg), b)
        assert np.isfinite(float(jl))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        _close_grads(pg, jg)


def test_minibatch_forward_loss_and_gradients_match_jax(model):
    jcfg, cfg, tree = model
    g = PD.synthetic_graph(200, 5, 8, 5, 1)
    b = next(PD.NeighborSampler(g, (4, 3), 1).batches(12, 2))
    levels = [b[f"feat_l{i}"] for i in range(3)]
    want = np.asarray(JG.minibatch_forward(jcfg, tree, [jnp.asarray(x)
                                                        for x in levels]))
    got = PG.minibatch_forward(cfg, PG.params_from_numpy(cfg, tree, "cpu"),
                               [torch.from_numpy(x) for x in levels])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    jl, jg, pl, pg = _loss_and_grads(JG.minibatch_loss, PG.minibatch_loss,
                                     tree, (jcfg, cfg), b)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _close_grads(pg, jg)


def test_batched_graphs_forward_loss_and_gradients_match_jax(model):
    """One pass over G * (N + 1) offset segments against the reference's
    ``jax.vmap`` of one graph's pass (the aggregator is the mean in
    both, whatever the config says)."""
    jcfg, cfg, tree = model
    b = PD.batched_molecules(5, 7, 12, 8, 5, 3)
    b["edge_mask"][1] = False                     # a graph with no edges
    for agg in ("mean", "max"):
        jc, pc = _with((jcfg, cfg), agg)
        want = np.asarray(JG.batched_graphs_forward(
            jc, tree, *(jnp.asarray(b[k])
                        for k in ("feats", "edges", "edge_mask"))))
        got = PG.batched_graphs_forward(
            pc, PG.params_from_numpy(pc, tree, "cpu"),
            *(torch.from_numpy(b[k]) for k in ("feats", "edges",
                                               "edge_mask")))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    jl, jg, pl, pg = _loss_and_grads(JG.batched_graphs_loss,
                                     PG.batched_graphs_loss, tree,
                                     (jcfg, cfg), b)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _close_grads(pg, jg)


def test_train_step_matches_jax(model):
    """One ``make_train_step`` step on the masked full graph: loss and
    grad_norm, then params and the fp32 master after AdamW."""
    jcfg, cfg, tree = model
    feats, edges, mask, labels = _graph(seed=8)
    b = {"feats": feats, "edges": edges, "edge_mask": mask,
         "labels": labels, "label_mask": np.ones(len(labels), bool)}
    jstep = JO.make_train_step(lambda p, x: JG.full_graph_loss(jcfg, p, x),
                               JO.AdamWConfig())
    jp = jax.tree.map(jnp.asarray, tree)
    jp1, js1, jm = jstep(jp, JO.init(jp, JO.AdamWConfig()),
                         {k: jnp.asarray(v) for k, v in b.items()})
    step = PO.make_train_step(lambda p, x: PG.full_graph_loss(cfg, p, x),
                              ADAMW)
    pp = PG.params_from_numpy(cfg, tree, "cpu")
    pp1, ps1, pm = step(pp, PO.init(pp, ADAMW),
                        {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
    for got, want in ((pp1, jp1), (ps1["master"], js1["master"])):
        got, want = _port_named(got), _jax_named(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-2 * LR, err_msg=k)


def test_gradients_hold_under_edge_order_and_in_float64():
    """The premise of holding the card to the CPU (``test_torch_gpu.py``:
    its segment sums add by atomics, in another order): at the smoke
    width, the masked ``full_graph_sm`` and ``molecule`` steps of
    ``build_gnn`` give gradient leaves within 1e-5 x max |g| + 1e-8 (a
    tenth of the card test's tolerance) of the same step with the edges
    in a permuted order and of the step in float64; the losses within
    rtol 1e-6."""
    cfg = PCFG.smoke_config(ARCH)
    gen = torch.Generator().manual_seed(7)
    for name in ("full_graph_sm", "molecule"):
        wl = build_gnn(cfg, PCFG.get_shape(cfg, name), device="cpu", seed=1)
        params, _, batch = wl.args
        loss = {"full_graph_sm": PG.full_graph_loss,
                "molecule": PG.batched_graphs_loss}[name]
        vg = PO.value_and_grad(lambda p, b: loss(cfg, p, b))
        perm = torch.randperm(batch["edges"].shape[-2], generator=gen)
        permuted = dict(batch, edges=batch["edges"][..., perm, :],
                        edge_mask=batch["edge_mask"][..., perm])
        as64 = {k: v.double() if v.is_floating_point() else v
                for k, v in batch.items()}
        l32, g32 = vg(params, batch)
        for other_params, other_batch in (
                (params, permuted),
                (tree_map(torch.Tensor.double, params), as64)):
            lo, go = vg(other_params, other_batch)
            np.testing.assert_allclose(float(l32), float(lo), rtol=1e-6)
            for (k, a), (_, b) in zip(flatten_with_path(g32),
                                      flatten_with_path(go)):
                err = float((a.double() - b.double()).abs().max())
                tol = 1e-5 * float(b.abs().max()) + 1e-8
                assert err <= tol, (name, k, err, tol)


# --- workloads --------------------------------------------------------------

def _reduced(name):
    shape = JCFG.get_shape(JCFG.get_arch(ARCH), name)
    if name == "minibatch_lg":
        return dataclasses.replace(shape, n_nodes=300, n_edges=2400,
                                   batch_nodes=16, d_feat=24)
    if name == "ogb_products":
        return dataclasses.replace(shape, n_nodes=500, n_edges=3999)
    return shape


@pytest.mark.parametrize("name", ["full_graph_sm", "molecule",
                                  "minibatch_lg", "ogb_products"])
def test_build_gnn_matches_jax_abstract_args(model, name):
    """``build_gnn`` at the smoke config (``minibatch_lg`` and
    ``ogb_products`` cut in nodes and edges): the parameter tree, the
    batch's keys, shapes and dtypes and ``model_flops`` equal to the JAX
    builder's abstract args on a one-device mesh; one step runs (loss and
    grad_norm finite, every parameter leaf changed), and a second batch
    comes from the stream."""
    jcfg, cfg, _ = model
    jshape = _reduced(name)
    shape = PCFG.base.ShapeSpec(**dataclasses.asdict(jshape))
    jwl = jax_build_gnn(jcfg, jshape, make_smoke_mesh(1))
    wl = build_gnn(cfg, shape, device="cpu", seed=4)
    assert wl.model_flops == jwl.model_flops
    jparams, _, jbatch = jwl.args
    params, opt_state, batch = wl.args
    assert _sig(_port_named(params)) == _sig(_jax_named(jparams))
    assert _sig(batch) == _sig(jbatch)
    if "edge_mask" in batch and name != "molecule":
        assert bool(batch["edge_mask"].all())
    new_p, new_s, m = wl.fn(*wl.args)
    assert np.isfinite(float(m["loss"])) \
        and np.isfinite(float(m["grad_norm"]))
    assert int(new_s["step"]) == 1
    for (k, a), (_, b) in zip(flatten_with_path(params),
                              flatten_with_path(new_p)):
        assert not torch.equal(a, b), k
    assert _sig(next(wl.batches)) == _sig(batch)
