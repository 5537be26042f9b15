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

Records land in ``results/dryrun_torch/<arch>__<shape>__card.json``
(``--out`` moves them). Runs on a host without a card.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counter import ProgramCounter
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import LMConfig
from repro_torch.launch.workloads import Workload, build_workload

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = ("card", "single", "multi")
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


def roofline(wl: Workload, pc: ProgramCounter) -> rl.Roofline:
    """The workload's three-term roofline from its traced call."""
    return rl.Roofline(
        name=wl.name, chips=1, hlo_flops=pc.flops(),
        hlo_bytes=modelled_bytes(wl, rl.memory_summary(pc)),
        coll_bytes=float(pc.collective_bytes()["total"]),
        model_flops=wl.model_flops,
        compute_dtype=wl.compute_dtype).finalize()


def _check_mesh(mesh: str) -> None:
    if mesh != "card":
        raise NotImplementedError(
            f"mesh {mesh!r}: the 256- and 512-rank meshes are the DTensor "
            "family, ROADMAP.md section 1 item 4(b), not ported yet; "
            "--mesh card is one H100")


def _extrapolate(one: float, two: float, L: int) -> float:
    """The reference's cost(L) = fixed + L * per_layer from the 1- and
    2-layer counts."""
    per_layer = max(two - one, 0.0)
    return max(one - per_layer, 0.0) + L * per_layer


def run_cell(arch: str, shape: str, mesh: str = "card",
             out_dir: Path = RESULTS, save_ops: bool = False) -> dict:
    """Count the full cell on meta (and an LM's 1- and 2-layer variants),
    write its record to ``out_dir/<arch>__<shape>__<mesh>.json`` and
    return it. A failure is recorded (``ok`` false, ``error``) rather
    than raised; a mesh other than ``card`` raises."""
    _check_mesh(mesh)
    cell = f"{arch}__{shape}__{mesh}"
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "ok": False}
    try:
        wl = build_workload(arch, shape, device="meta")
        pc = count(wl)
        t_count = time.time() - t0
        mem = rl.memory_summary(pc)
        flops = pc.flops()
        coll_kinds = pc.collective_bytes()
        if isinstance(get_arch(arch), LMConfig):
            L = get_arch(arch).n_layers
            one, two = (count(build_workload(arch, shape, device="meta",
                                             n_layers_override=n))
                        for n in (1, 2))
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
        roof = roofline(wl, pc)
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
        print(f"[OK] {cell}: count={t_count:.1f}s bound={roof.bound} "
              f"step={roof.step_s * 1e3:.2f}ms "
              f"frac={roof.roofline_frac:.3f} "
              f"mem/dev={mem['peak_bytes_est'] / 2**30:.2f}GiB")
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
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="shape name (default: all for the arch)")
    ap.add_argument("--mesh", choices=MESHES, default="card",
                    help="card: one H100; single / multi (256 / 512 "
                         "ranks) are ROADMAP.md section 1 item 4(b)")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--save-ops", action="store_true",
                    help="also write each cell's per-op table")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose JSON already reports ok")
    args = ap.parse_args(argv)
    try:
        _check_mesh(args.mesh)
    except NotImplementedError as e:
        ap.error(str(e))

    out_dir = Path(args.out)
    cells = [(a, s) for a, s in all_cells()
             if (not args.arch or a == args.arch)
             and (not args.shape or s == args.shape)]
    if not cells:
        ap.error(f"no cell matches --arch {args.arch} --shape {args.shape}")
    n_ok = n_fail = n_skip = 0
    for a, s in cells:
        jpath = out_dir / f"{a}__{s}__{args.mesh}.json"
        if args.skip_done and jpath.exists():
            try:
                if json.loads(jpath.read_text()).get("ok"):
                    n_skip += 1
                    continue
            except (OSError, ValueError):
                pass
        rec = run_cell(a, s, args.mesh, out_dir, save_ops=args.save_ops)
        n_ok += bool(rec.get("ok"))
        n_fail += not rec.get("ok")
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"-> {out_dir}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
