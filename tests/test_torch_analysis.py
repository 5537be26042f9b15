"""The port's analysis tooling (``repro_torch.analysis``) against the JAX
package's on the CPU: the roofline and memory summary against
``repro.analysis.roofline`` (which imports no JAX), the traced-program
counter's collectives against ``repro.analysis.hlo_parse`` on the same
collectives, the kernels' cost formulas against the bounds
``PERF.md`` section 6 worked out by hand, and each kernel's meta
branch against its plain version. No JAX compile, no subprocess."""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import hlo_parse as jax_hlo
from repro.analysis import roofline as jax_rl
from repro_torch.analysis import kernel_costs as KC
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counter import ProgramCounter
from repro_torch.configs import get_arch
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.fused_serve.ops import fused_serve_probe
from repro_torch.kernels.ivf_scan.ops import ivf_scan
from repro_torch.kernels.simsearch.ops import cosine_topk
from repro_torch.models import recsys

torch.set_num_threads(1)

REF_PEAKS = dict(peak_flops={"bfloat16": jax_rl.PEAK_FLOPS},
                 hbm_bw=jax_rl.HBM_BW, link_bw=jax_rl.ICI_BW)


def test_roofline_matches_the_reference_field_for_field():
    """``Roofline.finalize`` with the reference's peaks gives the
    reference's every field on a grid of counts, chips and model FLOPs,
    each term taking the bound somewhere on it."""
    grid = itertools.product((0.0, 3e9, 7.5e14), (0.0, 2e6, 9e11),
                             (0.0, 1e6, 4e10), (0.0, 1e12, 3e15), (1, 4))
    bounds = set()
    for flops, byts, coll, model, chips in grid:
        args = dict(name="c", chips=chips, hlo_flops=flops, hlo_bytes=byts,
                    coll_bytes=coll, model_flops=model)
        want = jax_rl.Roofline(**args).finalize().to_dict()
        got = rl.Roofline(**args, compute_dtype="bfloat16",
                          **REF_PEAKS).finalize().to_dict()
        assert {k: got[k] for k in want} == want
        bounds.add(want["bound"])
    assert bounds == {"compute", "memory", "collective"}
    # the defaults are the H100's peaks
    r = rl.Roofline(name="c", chips=1, hlo_flops=67e12, hlo_bytes=3.35e12,
                    coll_bytes=450e9, model_flops=0.0,
                    compute_dtype="float32").finalize()
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
    assert rl.Roofline(name="c", chips=1, hlo_flops=989e12, hlo_bytes=0.0,
                       coll_bytes=0.0, model_flops=989e12).finalize() \
        .step_s == 1.0
    assert rl.bound(3.35e9, 0.0, "float32") == (1.0, "bytes")
    assert rl.bound(0.0, 989e9, "bfloat16") == (1.0, "operations")
    assert rl.bound(0.0, 494.5e9, "tfloat32") == (1.0, "operations")


def test_memory_summary_has_the_references_keys_and_values():
    sizes = {"argument_size_in_bytes": 1000.0, "output_size_in_bytes": 300.0,
             "temp_size_in_bytes": 70.0, "alias_size_in_bytes": 200.0}
    want = jax_rl.memory_summary(SimpleNamespace(
        memory_analysis=lambda: SimpleNamespace(**sizes)))
    got = rl.memory_summary(SimpleNamespace(memory=lambda: sizes))
    assert got == want
    assert set(got) == set(sizes) | {"peak_bytes_est"}
    assert got["peak_bytes_est"] == 1000 + 70 + 100


_HLO = """
HloModule collectives
ENTRY %main {
  %p0 = f32[8,16]{1,0} parameter(0)
  %p1 = bf16[1024]{0} parameter(1)
  %p2 = f32[64]{0} parameter(2)
  %p3 = f32[4,8]{1,0} parameter(3)
  %ag = f32[32,16]{1,0} all-gather(f32[8,16]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %p1), replica_groups={{0,1,2,3}}, to_apply=%sum
  %rs = f32[16]{0} reduce-scatter(f32[64]{0} %p2), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%sum
  ROOT %a2a = f32[4,8]{1,0} all-to-all(f32[4,8]{1,0} %p3), replica_groups={{0,1,2,3}}, dimensions={0}
}
"""


@pytest.fixture
def fake_group():
    """A fake process group of 4 ranks in this process (no peers, no
    network), torn down after the test."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_collectives_match_hlo_parse(fake_group, device):
    """The same four collectives as the HLO snippet, issued as
    functional collectives through a fake 4-rank group under the
    counter: operand bytes by kind and counts equal hlo_parse's."""
    def ones(shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=device)
    with ProgramCounter() as pc:
        outs = [funcol.all_gather_tensor(ones((8, 16)), 0, fake_group),
                funcol.all_reduce(ones((1024,), torch.bfloat16), "sum",
                                  fake_group),
                funcol.reduce_scatter_tensor(ones((64,)), "sum", 0,
                                             fake_group),
                funcol.all_to_all_single(ones((4, 8)), None, None,
                                         fake_group)]
        shapes = [tuple(funcol.wait_tensor(o).shape) for o in outs]
    assert shapes == [(32, 16), (1024,), (16,), (4, 8)]
    assert pc.collective_bytes() == jax_hlo.collective_bytes(_HLO)
    assert pc.count_collectives() == jax_hlo.count_collectives(_HLO)
    assert pc.collective_bytes()["total"] == 512 + 2048 + 256 + 128


def test_dtensor_program_is_counted_per_rank():
    """A (1024, 2048) @ (2048, 6144) product of meta DTensors, both
    sharded (data, model) on a 4x4 mesh of a fake 16-rank group, then
    redistributed to batch rows: the counter sees rank 0's local
    product, 2 * 1024 * 2048 * 6144 / 16 FLOPs, and the collectives
    torch's own ``CommDebugMode`` sees, kind by kind, with the operand
    bytes of rank 0's shards; counted twice, the same (DTensor's cached
    and uncached shape propagation are passed over alike). The
    redistribute moves a Shard over 'model' to another dim: one
    all-to-all on cards, which the counter counts as such on this
    cpu-typed mesh too, so ``CommDebugMode`` runs inside a counter to
    see the same program (alone it sees DTensor's gloo fallback, an
    all-gather in the all-to-all's place)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))

        def dt(*local):
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, [Shard(0), Shard(1)],
                                      run_check=False)
        a, b = dt(256, 512), dt(512, 1536)
        assert a.shape == (1024, 2048) and b.shape == (2048, 6144)

        def prog(a, b):
            return (a @ b).redistribute(mesh, [Shard(0), Replicate()])
        counts = []
        for _ in range(2):
            pc = ProgramCounter()
            out = pc.run(prog, a, b)
            counts.append((pc.flops(), pc.count_collectives(),
                           pc.collective_bytes()))
        with ProgramCounter(), CommDebugMode() as comm:
            prog(a, b)
        with CommDebugMode() as alone:
            prog(a, b)
    finally:
        dist.destroy_process_group()
    assert counts[0] == counts[1]
    flops, kinds, byts = counts[0]
    assert flops == 2 * 1024 * 2048 * 6144 / 16 == 1_610_612_736
    names = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all"}
    want = {c: 0 for c in kinds}
    for op, n in comm.get_comm_counts().items():
        want[names[str(op).split(".")[-1]]] += n
    assert kinds == want and sum(want.values()) > 0
    assert kinds["all-to-all"] == 1
    assert sum(alone.get_comm_counts().values()) == sum(want.values())
    assert out.to_local().shape == (256, 6144)
    assert byts["total"] > 0


@pytest.mark.parametrize("shard_dim", [0, 1])
def test_dtensor_shard_to_shard_counts_as_one_all_to_all(shard_dim):
    """A (1024, 1024) fp32 meta DTensor moved from rows to columns over
    'model' (and back) on a 4x4 cpu-typed mesh of a fake 16-rank group:
    DTensor runs its fallback (an all-gather and a chunk, gloo having no
    all-to-all), and the counter counts what the exchange is on cards:
    one all-to-all of rank 0's 1 MiB shard, no all-gather, and a peak of
    the 1 MiB output alone, not the 4 MiB gathered buffer."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        local = (256, 1024) if shard_dim == 0 else (1024, 256)
        x = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                               [Replicate(), Shard(shard_dim)],
                               run_check=False)
        pc = ProgramCounter()
        out = pc.run(lambda t: t.redistribute(
            mesh, [Replicate(), Shard(1 - shard_dim)]), x)
    finally:
        dist.destroy_process_group()
    assert out.to_local().shape == local[::-1]
    assert pc.count_collectives() == {
        "all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
        "all-to-all": 1, "collective-permute": 0}
    assert pc.collective_bytes() == {"all-to-all": 2**20, "total": 2**20}
    assert pc.peak_bytes == 2**20
    import torch.distributed.tensor.placement_types as pt
    assert pt.shard_dim_alltoall.__module__ != __name__ and \
        pt.shard_dim_alltoall.__qualname__ == "shard_dim_alltoall"


def _wd_global_ids(B: int, seed: int) -> torch.Tensor:
    cfg = get_arch("wide-deep")
    b = next(recsys_batches(cfg, B, seed))
    return recsys._wd_field_ids(cfg, torch.from_numpy(b["sparse_ids"])) \
        .reshape(-1, cfg.multi_hot)


def test_kernel_costs_reproduce_the_hand_bounds():
    """Each formula at a row's shapes of PERF.md section 6 gives the
    bound worked out there by hand (ms, 4 decimals: within 1 % or half
    the last digit), and the same bound_by. The bag's distinct rows come
    from the same seeded Wide&Deep batches as on the card."""
    H, Kv, D = 16, 8, 128
    V = recsys._table_rows(40 * 100_000)
    p99 = np.mean([int(torch.unique(_wd_global_ids(512, 1 + s)).numel())
                   for s in range(16)])
    train = int(torch.unique(_wd_global_ids(65536, 0)).numel())
    rows = [
        (KC.simsearch(32, 4_194_304, 64), 0.3205, "bytes"),
        (KC.simsearch(4096, 4_194_304, 64, 4), 4.4470, "operations"),
        (KC.flash_attention(8, 64, H, Kv, D), 0.0019, "bytes"),
        (KC.flash_attention(1, 1000, H, Kv, D), 0.0041, "operations"),
        (KC.flash_attention(8, 64, 16, 16, D), 0.0025, "bytes"),
        (KC.flash_attention(2, 4096, H, Kv, D), 0.1390, "operations"),
        (KC.flash_attention_fwd_bwd(2, 4096, H, Kv, D), 0.4865,
         "operations"),
        (KC.flash_attention(1, 32768, H, Kv, D), 4.4471, "operations"),
        (KC.decode_attention(8, H, Kv, D, sum(
            (1, 37, 64, 100, 255, 256, 400, 512))), 0.0020, "bytes"),
        (KC.decode_attention(8, H, Kv, D, 8 * 52), 0.0005, "bytes"),
        (KC.decode_attention(8, 16, 16, D, 8 * 52), 0.0010, "bytes"),
        (KC.decode_attention(8, H, Kv, D, 8 * 32768), 0.3205, "bytes"),
        (KC.embedding_bag(512 * 40, 4, 32, p99), 0.0041, "bytes"),
        (KC.embedding_bag(512 * 40, 4, 1, p99), 0.0003, "bytes"),
        (KC.embedding_bag(65536 * 40, 4, 32, train), 0.2669, "bytes"),
        (KC.embedding_bag(65536 * 40, 4, 1, train), 0.0326, "bytes"),
        (KC.embedding_bag_backward(65536 * 40, 4, 32, V), 0.2781, "bytes"),
        (KC.embedding_bag_backward(65536 * 40, 4, 1, V), 0.0329, "bytes"),
    ]
    for cost, hand, by in rows:
        ms, got_by = cost.bound()
        assert got_by == by, (cost, hand)
        assert abs(ms - hand) <= max(0.01 * hand, 0.5e-4), (cost, ms, hand)


class _Devices(TorchDispatchMode):
    """Records the device of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


def _kernel_calls(g):
    """(name, fn, args on the CPU) of each kernel's public entry."""
    def randn(*s):
        return torch.randn(s, generator=g)

    def ids(hi, *s):
        return torch.randint(0, hi, s, generator=g, dtype=torch.int32)
    K, cap, d = 6, 8, 16
    row_ids = torch.arange(K * cap, dtype=torch.int32).reshape(K, cap)
    ivf = (randn(5, d), randn(K, d), torch.randint(
        -127, 128, (K, cap, d), generator=g, dtype=torch.int8),
        torch.rand((K, cap), generator=g), row_ids)
    table = randn(40, 8)
    return {
        "simsearch": (lambda q, c: cosine_topk(q, c, 4),
                      (randn(5, 16), randn(300, 16))),
        "flash_attention": (attention, (randn(2, 9, 4, 16),
                                        randn(2, 9, 2, 16),
                                        randn(2, 9, 2, 16))),
        "decode_attention": (decode_attention, (
            randn(2, 4, 16), randn(2, 12, 2, 16), randn(2, 12, 2, 16),
            torch.tensor([3, 12], dtype=torch.int32))),
        "ivf_scan": (lambda *a: ivf_scan(*a, nprobe=3, n_candidates=5),
                     ivf),
        "fused_serve": (lambda *a: fused_serve_probe(
            *a, nprobe=3, n_candidates=5, n_dyn_candidates=4, dyn_tile=8),
            (*ivf, randn(20, d), torch.rand(20, generator=g) < 0.5)),
        "embedding_bag": (embedding_bag, (table, ids(40, 6, 3),
                                          torch.rand((6, 3), generator=g))),
        "embedding_bag_backward": (
            lambda t, i, w: torch.autograd.grad(
                embedding_bag(t, i, w).sum(), t)[0],
            (table.requires_grad_(True), ids(40, 6, 3),
             torch.rand((6, 3), generator=g))),
    }


@pytest.mark.parametrize("name", list(_kernel_calls(torch.Generator())))
def test_meta_branch_gives_the_plain_shapes_and_allocates_nothing(name):
    """On meta tensors each kernel's entry takes its meta branch: the
    outputs have the plain version's shapes and dtypes (run on the CPU),
    no op makes a tensor off the meta device, and the counter records
    the kernel once with its formula's FLOPs."""
    fn, cpu_args = _kernel_calls(torch.Generator().manual_seed(3))[name]
    want = fn(*cpu_args)
    meta_args = [a.detach().to("meta").requires_grad_(a.requires_grad)
                 for a in cpu_args]
    seen = _Devices()
    with ProgramCounter() as pc, seen:
        got = fn(*meta_args)
    flat_w = want if isinstance(want, tuple) else (want,)
    flat_g = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype) for t in flat_g] == \
        [(t.shape, t.dtype) for t in flat_w]
    assert all(t.device.type == "meta" for t in flat_g)
    assert seen.devices == {"meta"}
    assert pc.kernels[name]["calls"] == 1 and pc.kernels[name]["flops"] > 0
