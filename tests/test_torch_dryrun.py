"""The port's dry run on the meta device (``launch/workloads`` on meta,
``launch/dryrun``, ``launch/cache_workload.run``) against the JAX
package's formulas on the CPU: meta builds allocate nothing off the
meta device, ``model_flops`` equals the reference's for every cell,
counted matmul FLOPs equal an analytic count, the 1- and 2-layer
extrapolation equals the full count, and the counted peak of a step on
meta equals the same step's live bytes traced on CPU tensors. No JAX
compile (``jax.eval_shape`` only), no subprocess. (Narrow cells
counted on the 256- and 512-rank meshes: ``test_torch_mesh_values.py``,
which runs on one core.)"""
import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.launch.mesh import make_smoke_mesh
from repro.launch.workloads import _lm_flops as jax_lm_flops
from repro.launch.workloads import _recsys_flops as jax_recsys_flops
from repro.launch.workloads import build_gnn as jax_build_gnn
from repro_torch.analysis import kernel_costs as KC
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counter import ProgramCounter
from repro_torch.configs import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                 all_cells, get_arch, get_shape,
                                 smoke_config)
from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.kernels.simsearch.ref import simsearch_ref
from repro_torch.launch import cache_workload, dryrun
from repro_torch.launch.workloads import (build_gnn, build_lm,
                                          build_recsys, build_workload)
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves

torch.set_num_threads(1)


class _Made(TorchDispatchMode):
    """Records (device, bytes) of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((t.device.type,
                                  t.untyped_storage().nbytes()))
        return out


def _meta_builds(kind):
    if kind == "full":
        yield lambda: build_workload("qwen3-1.7b", "decode_32k",
                                     device="meta")
        return
    if kind in ("lm", "moe"):
        cfg = smoke_config("qwen3-1.7b" if kind == "lm"
                           else "qwen2-moe-a2.7b")
        for s in LM_SHAPES:
            yield lambda s=s: build_lm(cfg, s, device="meta", batch=2)
    elif kind == "gnn":
        cfg = smoke_config("graphsage-reddit")
        for s in GNN_SHAPES:
            yield lambda s=s: build_gnn(cfg, s, device="meta")
    else:
        for arch in ("sasrec", "mind", "bst", "wide-deep"):
            cfg = smoke_config(arch)
            for s in RECSYS_SHAPES:
                yield lambda cfg=cfg, s=s: build_recsys(cfg, s,
                                                        device="meta")


@pytest.mark.parametrize("kind", ["lm", "moe", "gnn", "recsys", "full"])
def test_meta_build_allocates_nothing(kind):
    """Every builder on meta (a dense LM's and the MoE's smoke configs at
    each LM shape, GraphSAGE at each GNN shape at its published size,
    each recsys kind at each shape, and full-width Qwen3-1.7B at
    decode_32k): no op makes a tensor with bytes off the meta device,
    and every argument is a meta tensor."""
    for build in _meta_builds(kind):
        seen = _Made()
        with seen:
            wl = build()
        assert not [m for m in seen.made if m[0] != "meta" and m[1]], \
            (wl.name, seen.made)
        assert all(t.device.type == "meta" for t in leaves(wl.args)), \
            wl.name
        nxt, first = next(wl.batches), wl.args[-1]
        assert [(t.shape, t.dtype) for t in leaves(nxt)] == \
            [(t.shape, t.dtype) for t in leaves(first)]


def test_model_flops_equal_the_references_for_every_cell():
    """``Workload.model_flops`` on meta equals the JAX builder's formula
    for all 35 cells: ``_lm_flops``, ``_recsys_flops`` and the GNN
    formulas (read from ``build_gnn`` on a one-device mesh, abstract
    shapes only)."""
    mesh = make_smoke_mesh(1)
    n = 0
    for arch, shape in all_cells():
        cfg, jcfg = get_arch(arch), jax_get_arch(arch)
        jshape = jax_get_shape(jcfg, shape)
        if isinstance(cfg, LMConfig):
            got = build_workload(arch, shape, device="meta", batch=1)
            want = jax_lm_flops(jcfg, dataclasses.replace(
                jshape, global_batch=1))
        elif isinstance(cfg, GNNConfig):
            got = build_workload(arch, shape, device="meta")
            want = jax_build_gnn(jcfg, jshape, mesh).model_flops
        else:
            got = build_workload(arch, shape, device="meta")
            want = jax_recsys_flops(jcfg, jshape)
        assert got.model_flops == want, (arch, shape)
        n += 1
    assert n == 35


def test_counted_matmul_flops_equal_an_analytic_count():
    """A smoke Qwen3 forward on meta: the counter's matmul FLOPs are the
    projections' and the SwiGLU's, 2 B S (d H h + 2 d Kv h + H h d + 3 d
    d_ff) a layer, and the flash kernel's meta branch reports its causal
    formula once a layer."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), head_dim=64)
    B, S = 3, 40
    params = tr.init_params(cfg, torch.Generator(), "meta")
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    pc = ProgramCounter()
    with torch.no_grad():
        pc.run(lambda p, t: tr.forward(cfg, p, t), params, tokens)
    d, H, Kv, h, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    per_layer = 2 * B * S * (d * H * h + 2 * d * Kv * h + H * h * d
                             + 3 * d * f)
    assert pc.matmul_flops == cfg.n_layers * per_layer
    flash = KC.flash_attention(B, S, H, Kv, h, 2).flops
    assert pc.kernels["flash_attention"] == {
        "calls": cfg.n_layers, "flops": cfg.n_layers * flash,
        "bytes": cfg.n_layers * KC.flash_attention(B, S, H, Kv, h, 2).bytes,
        "dtype": "bfloat16"}
    assert pc.flops() == pc.matmul_flops + cfg.n_layers * flash


def test_extrapolation_equals_the_full_count(tmp_path):
    """An MoE cell at full width: the 1- and 2-layer variants'
    extrapolation ``fixed + L * per_layer`` equals the full count to
    1e-9 relative (the counter sees every layer)."""
    rec = dryrun.run_cell("qwen2-moe-a2.7b", "prefill_32k",
                          out_dir=tmp_path)
    assert rec["ok"], rec.get("error")
    ext = rec["extrapolation"]
    assert ext["flops_rel_err"] <= 1e-9
    assert abs(ext["flops"] - rec["roofline"]["hlo_flops"]) \
        <= 1e-9 * rec["roofline"]["hlo_flops"]
    assert rec["kernels"]["flash_attention"]["calls"] == 24


_SMALL_GNN = {
    "full_graph_sm": dict(n_nodes=60, n_edges=300, d_feat=12),
    "minibatch_lg": dict(n_nodes=80, n_edges=400, batch_nodes=6,
                         fanout=(3, 2), d_feat=10),
    "molecule": dict(n_nodes=7, n_edges=12, global_batch=5, d_feat=6),
}


@pytest.mark.parametrize("name", list(_SMALL_GNN))
def test_meta_peak_equals_the_cpu_trace(name):
    """A smoke GraphSAGE step, each GNN kind at a small shape: the
    counter's memory sizes and peak on meta equal the same step's traced
    on CPU tensors (no kernel on this path, so the ops are the same)."""
    cfg = smoke_config("graphsage-reddit")
    shape = dataclasses.replace(get_shape(cfg, name), **_SMALL_GNN[name])
    mems = {}
    for dev in ("meta", "cpu"):
        wl = build_gnn(cfg, shape, device=dev, seed=2)
        pc = ProgramCounter()
        pc.run(wl.fn, *wl.args)
        mems[dev] = (rl.memory_summary(pc), pc.matmul_flops)
    assert mems["meta"] == mems["cpu"]
    assert mems["meta"][0]["peak_bytes_est"] > \
        mems["meta"][0]["argument_size_in_bytes"]


def test_run_cell_writes_a_record(tmp_path):
    """``run_cell`` end to end on a full-width cell: the JSON record with
    the reference's keys and ``ok`` true; on the 256-rank mesh (from
    ``run_cell``) and the 512-rank one (from ``main``) the same cell's
    ``pod`` records, per rank, with collectives and the mesh size as
    ``chips``, and the process left without a group."""
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", out_dir=tmp_path)
    disk = json.loads((tmp_path / "qwen3-1.7b__decode_32k__card.json")
                      .read_text())
    assert disk["ok"] and rec["ok"], rec.get("error")
    for key in ("memory", "bytes_per_device", "collectives",
                "collective_bytes", "roofline", "wall_s"):
        assert key in disk
    assert disk["collective_bytes"] == {"total": 0}
    assert disk["roofline"]["bound"] == "memory"
    assert disk["kernels"]["decode_attention"]["calls"] == 28
    pod = dryrun.run_cell("qwen3-1.7b", "decode_32k", mesh="single",
                          out_dir=tmp_path)
    assert pod["ok"], pod.get("error")
    assert pod["mesh"] == "pod16x16" and pod["roofline"]["chips"] == 256
    assert pod["collectives"]["all-gather"] > 0
    assert pod["kernels"]["decode_attention"]["calls"] == 28
    assert pod["memory"]["peak_bytes_est"] < \
        rec["memory"]["peak_bytes_est"] / 16
    dryrun.main(["--mesh", "multi", "--arch", "wide-deep", "--shape",
                 "serve_p99", "--out", str(tmp_path)])
    multi = json.loads((tmp_path / "wide-deep__serve_p99__pod2x16x16.json")
                       .read_text())
    assert multi["ok"] and multi["roofline"]["chips"] == 512
    assert not dist.is_initialized()


def test_cache_workload_run_on_cpu_matches_the_plain_top_k(tmp_path):
    """``run`` at a small size on the CPU, two shards: a TF32 roofline
    at the simsearch formula's FLOPs a shard, and ids equal to the plain
    version's on the same inputs; ``multi_pod=True`` counts on the
    512-rank mesh instead: rank 0's FLOPs are the simsearch formula on
    its S / 16 rows, and the merge's all-gathers move its (B, k) scores
    and ids."""
    B, S, d, k = 40, 3001, 64, 4
    rec = cache_workload.run(B=B, S=S, d=d, k=k, shards=2, device="cpu",
                             out_dir=tmp_path)
    corpus, q = cache_workload.lookup_inputs(B, S, d, cache_workload.SEED,
                                             "cpu")
    assert torch.equal(rec["ids"], simsearch_ref(q, corpus, k)[1])
    r = rec["roofline"]
    assert r["compute_dtype"] == "tfloat32" and rec["card_ms"] is None
    assert r["hlo_flops"] == KC.simsearch(B, 1501, d, k).flops \
        + KC.simsearch(B, 1500, d, k).flops
    assert json.loads(next(tmp_path.glob("krites-cache-lookup__*.json"))
                      .read_text())["ok"]
    pod = cache_workload.run(B=B, S=S, d=d, k=k, multi_pod=True,
                             device="cpu", out_dir=tmp_path)
    assert pod["flops"] == KC.simsearch(B, -(-S // 16), d, k).flops
    assert pod["roofline"]["chips"] == 512 and pod["mesh"] == "pod2x16x16"
    assert pod["collectives"]["all-gather"] == 2
    assert pod["collective_bytes"]["total"] == 2 * B * k * 4
    assert (tmp_path / f"krites-cache-lookup__B{B}xS{S}__pod2x16x16.json"
            ).exists()
    assert not dist.is_initialized()
