"""The port's DTensor family (``repro_torch.distributed.sharding``,
``act_sharding``, the production and smoke meshes) against the JAX
package's ``repro.distributed.sharding`` on the CPU: every spec leaf of
every family equals the reference's, the specs turn into the right
placements on 2x2 and 2x2x2 meshes, the constraints pin as the
reference's, and the mesh functions use the caller's group or raise
(the counted production meshes are in ``test_torch_dryrun.py``). Meshes
live on "fake" process groups in this process (no peers, no network),
each torn down by its fixture. No JAX compile, no subprocess."""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import sharding as jshd
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.act_sharding import (constrain_act,
                                                  constrain_seq,
                                                  constrain_tp_last,
                                                  use_dp_axes)
from repro_torch.launch.mesh import (dp_axes, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)


@pytest.fixture
def group(request):
    """A fake process group of ``request.param`` ranks, torn down after
    the test."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=request.param)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


def _jax_specs(tree) -> dict:
    """{"a/b/0/c": spec entries} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    return {"/".join(path): tuple(spec.entries)
            for path, spec in flatten_with_path(tree)}


_ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
          "glm4-9b", "wide-deep", "sasrec", "mind", "bst",
          "graphsage-reddit")


@pytest.mark.parametrize("arch", _ARCHS)
def test_param_specs_equal_the_reference(arch):
    """Each parameter leaf's spec equals the reference's spec for the
    same leaf (the LM's per-layer rules on the stacked L axis, the
    tables of >= 4096 rows over 'model', GNN weights replicated); the
    recsys tables are widened past 4096 rows so that both rules act."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    if arch in ("wide-deep", "sasrec", "mind", "bst"):
        jcfg = dataclasses.replace(jcfg, n_items=5000, sparse_vocab=256)
        cfg = dataclasses.replace(cfg, n_items=5000, sparse_vocab=256)
        abstract = jax.eval_shape(
            lambda k: jrecsys.init_params(jcfg, k), jax.random.PRNGKey(0))
        want = jshd.recsys_param_specs(jcfg, abstract)
        got = shd.recsys_param_specs(
            cfg, recsys.init_params(cfg, torch.Generator(), "meta"))
        assert ("model", None) in _port_specs(got).values()
    elif arch == "graphsage-reddit":
        abstract = jax.eval_shape(
            lambda k: jgnn.init_params(jcfg, k), jax.random.PRNGKey(0))
        want = jshd.gnn_param_specs(jcfg, abstract)
        got = shd.gnn_param_specs(
            cfg, gnn.init_params(cfg, torch.Generator(), "meta"))
    else:
        want, got = jshd.lm_param_specs(jcfg), shd.lm_param_specs(cfg)
        assert set(_port_specs(got)) == {
            "/".join(p) for p, _ in flatten_with_path(
                tr.init_params(cfg, torch.Generator(), "meta"))}
    assert _port_specs(got) == _jax_specs(want)


@pytest.mark.parametrize("group", [4, 8], indirect=True)
def test_batch_and_cache_specs_and_their_placements(group):
    """On a 2x2 ("data", "model") and a 2x2x2 ("pod", "data", "model")
    mesh: the LM batch / cache / prefill-output, GNN and recsys batch
    specs equal the reference's on a mesh of the same axis names, and
    the placements are Shard on each named mesh axis, ("pod", "data")
    sharding one dim on both in mesh order."""
    mesh = make_smoke_mesh(4) if group == 4 else \
        init_device_mesh("cpu", (2, 2, 2),
                         mesh_dim_names=("pod", "data", "model"))
    names = mesh.mesh_dim_names
    jmesh = jax.make_mesh((1,) * len(names), names)
    assert dp_axes(mesh) == tuple(n for n in names if n != "model")
    rcfg, jrcfg = smoke_config("wide-deep"), jax_smoke_config("wide-deep")
    pairs = [(shd.lm_batch_spec(mesh), jshd.lm_batch_spec(jmesh)),
             (shd.lm_cache_spec(mesh), jshd.lm_cache_spec(jmesh)),
             (list(shd.lm_prefill_out_spec(mesh)),
              list(jshd.lm_prefill_out_spec(jmesh)))]
    for kind in ("full_graph", "minibatch", "batched_graphs"):
        pairs.append((shd.gnn_batch_spec(mesh, kind),
                      jshd.gnn_batch_spec(jmesh, kind)))
    for kind in ("train", "serve", "retrieval"):
        pairs.append((shd.recsys_batch_spec(mesh, rcfg, kind),
                      jshd.recsys_batch_spec(jmesh, jrcfg, kind)))
    for got, want in pairs:
        assert _port_specs(got) == _jax_specs(want)
    dp = dp_axes(mesh)
    pl = shd.placements(mesh, shd.lm_cache_spec(mesh)["k"])
    assert pl == [Shard(1)] * len(dp) + [Shard(2)]
    assert shd.placements(mesh, shd.P(None, "data")) == \
        [Replicate()] * (len(names) - 2) + [Shard(1), Replicate()]
    assert shd.placements(mesh, shd.P(names, None)) == [Shard(0)] * len(
        names)
    for bad in (shd.P("data", "data"), shd.P("nope"),
                shd.P(("model", "data"))):
        with pytest.raises(ValueError):
            shd.placements(mesh, bad)
    # distribute: each rank keeps its chunk of the global value
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = shd.distribute(x, shd.NamedSharding(mesh, shd.P(dp, "model")))
    assert d.shape == x.shape and torch.equal(
        d.to_local(), x[:8 // (group // 2), :3])


@pytest.mark.parametrize("group", [4], indirect=True)
def test_constraints_redistribute_as_the_reference_pins(group):
    """Each constraint is a no-op outside ``use_dp_axes`` and on a plain
    tensor, and inside it redistributes to the reference's spec: batch
    on the DP axes, the last axis or the sequence on 'model'."""
    mesh = make_smoke_mesh(4)
    x = shd.distribute(torch.zeros(4, 8, 6),
                       shd.NamedSharding(mesh, shd.P()))
    assert constrain_act(x) is x
    with use_dp_axes(dp_axes(mesh), mesh=mesh):
        assert list(constrain_act(x).placements) == [Shard(0), Replicate()]
        assert list(constrain_tp_last(x).placements) == [Shard(0), Shard(2)]
        assert list(constrain_seq(x).placements) == [Shard(0), Shard(1)]
        plain = torch.zeros(3)
        assert constrain_act(plain) is plain


def test_meshes_need_the_callers_group():
    """No group: the mesh functions raise and start none."""
    assert not dist.is_initialized()
    for make in (make_production_mesh, make_smoke_mesh):
        with pytest.raises(RuntimeError, match="init_process_group"):
            make()
    assert not dist.is_initialized()


@pytest.mark.parametrize("group", [4], indirect=True)
def test_meshes_refuse_a_group_of_another_size(group):
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    assert make_smoke_mesh().shape == (2, 2)
    with pytest.raises(ValueError, match="3 ranks"):
        make_smoke_mesh(3)
