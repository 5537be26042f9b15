"""Dry run of every (arch, shape) cell on one H100, on the meta device
(port of ``repro/launch/dryrun.py``).

Each cell's workload is built on ``meta`` (``launch/workloads``: full
global batch, no data, nothing allocated) and one call of it is traced
by ``analysis.counter.ProgramCounter``: matmul FLOPs, the hand-written
kernels' costs from their meta branches, collectives and live bytes.
From those, ``analysis.roofline`` gives the three-term bound of a step
on one card. LM cells also count their 1- and 2-layer variants: the
record keeps the full count beside the reference's extrapolation
``fixed + L * per_layer``, and the two must agree (the port's layers are
a Python loop, so the counter sees every one).

Bytes are modelled as the reference models them: LM cells move their
arguments, outputs and twice the remat residuals (each saved and read
back); other cells their arguments, outputs and temporaries.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.dryrun    # all 35 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both

``--mesh`` picks the program: ``card`` (default) one H100; ``single``
and ``multi`` the reference's production meshes, 16x16 ``("data",
"model")`` (256 ranks) and 2x16x16 ``("pod", "data", "model")`` (512
ranks); ``both`` the two. A mesh cell is the sharded program
(``build_workload(mesh=)``, DTensors) counted on rank 0 under a
``"fake"`` process group started for the run (one process holds one
group, so the meshes run one after the other and a process that already
has a group is refused): per-rank FLOPs, bytes and peak, and the
collectives DTensor and the port issue. Its roofline has ``chips`` the
mesh size and the collective term the counted bytes over one NVLink
direction, a lower bound where a 16-wide 'model' axis spans two 8-card
servers.

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``,
``<mesh>`` being ``card``, ``pod16x16`` or ``pod2x16x16`` (``--out``
moves them). Runs on a host without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counter import ProgramCounter
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import LMConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.workloads import Workload, build_workload

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = ("card", "single", "multi", "both")
# --mesh name -> (record suffix, ranks)
MESH_NAMES = {"card": ("card", 1), "single": ("pod16x16", 256),
              "multi": ("pod2x16x16", 512)}
EXTRAP_RTOL = 1e-9      # full count against fixed + L * per_layer


def count(wl: Workload) -> ProgramCounter:
    """Trace one call of ``wl`` (built on meta) and return the counter."""
    pc = ProgramCounter()
    pc.run(wl.fn, *wl.args)
    return pc


def modelled_bytes(wl: Workload, mem: dict) -> float:
    """The reference's HBM traffic model of one call: LM cells (a remat
    carry) args + outputs + 2 x residuals, others args + outputs +
    temporaries."""
    args = mem["argument_size_in_bytes"]
    outs = mem["output_size_in_bytes"]
    if wl.n_loop_layers:
        return args + outs + 2.0 * wl.residual_bytes_per_layer \
            * wl.n_loop_layers
    return args + outs + mem["temp_size_in_bytes"]


def roofline(wl: Workload, pc: ProgramCounter,
             chips: int = 1) -> rl.Roofline:
    """The workload's three-term roofline from its traced call (per
    rank on a mesh of ``chips`` ranks)."""
    return rl.Roofline(
        name=wl.name, chips=chips, hlo_flops=pc.flops(),
        hlo_bytes=modelled_bytes(wl, rl.memory_summary(pc)),
        coll_bytes=float(pc.collective_bytes()["total"]),
        model_flops=wl.model_flops,
        compute_dtype=wl.compute_dtype).finalize()


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` process group of ``world`` ranks, this process rank 0,
    for the length of the block: collectives return at once and move no
    data, so a DTensor program of ``world`` ranks runs on one host (on
    meta tensors) to be counted. Refused when the process already has a
    group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "this process already has a process group; a counted mesh "
            "needs its own fake one (run it in a process of its own)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def production_mesh(mesh: str):
    """The production mesh ``mesh`` ('single' or 'multi') on a fake group
    started for the block (:func:`fake_group`)."""
    with fake_group(MESH_NAMES[mesh][1]):
        yield make_production_mesh(multi_pod=mesh == "multi")


def _extrapolate(one: float, two: float, L: int) -> float:
    """The reference's cost(L) = fixed + L * per_layer from the 1- and
    2-layer counts."""
    per_layer = max(two - one, 0.0)
    return max(one - per_layer, 0.0) + L * per_layer


def run_cell(arch: str, shape: str, mesh: str = "card",
             out_dir: Path = RESULTS, save_ops: bool = False,
             device_mesh=None) -> dict:
    """Count the full cell on meta (and an LM's 1- and 2-layer variants),
    write its record to ``out_dir/<arch>__<shape>__<suffix>.json`` and
    return it. ``mesh`` is 'card', 'single' or 'multi'; a mesh cell is
    counted on ``device_mesh`` when given (the production mesh over a
    fake group), else on one built for the call (:func:`production_mesh`).
    A failure is recorded (``ok`` false, ``error``) rather than
    raised."""
    if mesh not in MESH_NAMES:
        raise ValueError(f"mesh {mesh!r}: one of {tuple(MESH_NAMES)}")
    if mesh != "card" and device_mesh is None:
        with production_mesh(mesh) as dm:
            return run_cell(arch, shape, mesh, out_dir, save_ops, dm)
    suffix, chips = MESH_NAMES[mesh]
    cell = f"{arch}__{shape}__{suffix}"
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": suffix, "chips": chips,
           "ok": False}

    def build(**kw):
        return build_workload(arch, shape, device="meta",
                              mesh=device_mesh, **kw)
    try:
        wl = build()
        pc = count(wl)
        t_count = time.time() - t0
        mem = rl.memory_summary(pc)
        flops = pc.flops()
        coll_kinds = pc.collective_bytes()
        if isinstance(get_arch(arch), LMConfig):
            L = get_arch(arch).n_layers
            one, two = (count(build(n_layers_override=n)) for n in (1, 2))
            ext = {"flops": _extrapolate(one.flops(), two.flops(), L),
                   "collective_bytes": _extrapolate(
                       one.collective_bytes()["total"],
                       two.collective_bytes()["total"], L)}
            err = abs(ext["flops"] - flops) / max(flops, 1.0)
            ext["flops_rel_err"] = err
            if err > EXTRAP_RTOL or ext["collective_bytes"] != \
                    coll_kinds["total"]:
                raise ValueError(f"full count {flops!r} against the 1- and "
                                 f"2-layer extrapolation {ext}")
            t1 = one.memory()["temp_size_in_bytes"]
            t2 = two.memory()["temp_size_in_bytes"]
            mem["transient_per_layer_est"] = float(max(t2 - t1, 0))
            mem["residual_bytes"] = wl.residual_bytes_per_layer \
                * wl.n_loop_layers
            rec["extrapolation"] = ext
        roof = roofline(wl, pc, chips)
        rec.update({
            "ok": True,
            "count_s": round(t_count, 2),
            "compute_dtype": wl.compute_dtype,
            "matmul_flops": pc.matmul_flops,
            "kernels": pc.kernels,
            "memory": mem,
            "bytes_per_device": mem["peak_bytes_est"],
            "collectives": pc.count_collectives(),
            "collective_bytes": coll_kinds,
            "roofline": roof.to_dict(),
        })
        coll = "" if mesh == "card" else \
            f" coll={coll_kinds['total'] / 2**20:.1f}MiB"
        print(f"[OK] {cell}: count={t_count:.1f}s bound={roof.bound} "
              f"step={roof.step_s * 1e3:.2f}ms "
              f"frac={roof.roofline_frac:.3f} "
              f"mem/dev={mem['peak_bytes_est'] / 2**30:.2f}GiB{coll}")
        if save_ops:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{cell}.ops.json").write_text(
                json.dumps(pc.op_table(), indent=1))
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {cell}: {rec['error'].splitlines()[0][:200]}")
    rec["wall_s"] = round(time.time() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="dry run of the registry's cells on one H100, on the "
                    "meta device")
    ap.add_argument("--arch", nargs="+", default=None,
                    help="arch ids (default: all)")
    ap.add_argument("--shape", nargs="+", default=None,
                    help="shape names (default: all for the arch)")
    ap.add_argument("--mesh", choices=MESHES, default="card",
                    help="card: one H100; single / multi: the 256- / "
                         "512-rank production mesh, counted per rank "
                         "under a fake process group; both: the two")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--save-ops", action="store_true",
                    help="also write each cell's per-op table")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose JSON already reports ok")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    cells = [(a, s) for a, s in all_cells()
             if (not args.arch or a in args.arch)
             and (not args.shape or s in args.shape)]
    if not cells:
        ap.error(f"no cell matches --arch {args.arch} --shape {args.shape}")
    n_ok = n_fail = n_skip = 0
    t0 = time.time()
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    for m in meshes:
        with (contextlib.nullcontext() if m == "card"
              else production_mesh(m)) as dm:
            for a, s in cells:
                jpath = out_dir / f"{a}__{s}__{MESH_NAMES[m][0]}.json"
                if args.skip_done and jpath.exists():
                    try:
                        if json.loads(jpath.read_text()).get("ok"):
                            n_skip += 1
                            continue
                    except (OSError, ValueError):
                        pass
                rec = run_cell(a, s, m, out_dir, save_ops=args.save_ops,
                               device_mesh=dm)
                n_ok += bool(rec.get("ok"))
                n_fail += not rec.get("ok")
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"in {time.time() - t0:.1f}s -> {out_dir}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
