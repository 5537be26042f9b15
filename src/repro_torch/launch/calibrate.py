"""Calibration entry point (port of ``scripts/calibrate.py``): tune or
pin t*, run baseline against Krites and print the operating-point table;
with ``--sweep``, trace the hit-rate/error Pareto frontier over a dense
tau_static x tau_dynamic grid in one ``simulate_sweep``.

    PYTHONPATH=src python -m repro_torch.launch.calibrate [workloads...] [--fixed]
    PYTHONPATH=src python -m repro_torch.launch.calibrate --sweep [--baseline] [workloads...]
    ... [--device cpu]

``--fixed`` pins t* to the benchmark's operating points (``TSTAR``:
lmarena_like 0.88, search_like 0.86) instead of tuning it. Baseline and
Krites share their judge latency, so they run as one two-config sweep
(the blocked core). ``--sweep`` centers its 8 x 8 grid on the
workload's operating point, or tunes one for a workload without one;
``--baseline`` sweeps Algorithm 1 instead of Krites.

Runs on ``cuda`` unless ``--device cpu`` is given. Outputs land in
``results/torch_table1_full.json`` and
``results/torch_sweep_<wl>[_baseline].json``, beside (never over) the
JAX script's files; each run records its wall time, microseconds per
simulated request per config, and on the card its peak device memory
(above what the process held when the run started).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.core.simulate import (simulate_sweep, summarize_sweep,
                                       sweep_from_configs, sweep_grid)
from repro_torch.core.tiers import CacheConfig
from repro_torch.data.synth_traces import (WORKLOADS, build_benchmark,
                                           tune_threshold)
from repro_torch.device import get_device

# the benchmark's pinned operating points (benchmarks/common.py TSTAR)
TSTAR = {"lmarena_like": 0.88, "search_like": 0.86}
GRID_CENTERS = dict(TSTAR)
RESULTS = pathlib.Path("results")


def _timed(dev, fn):
    """Run ``fn`` (which ends in a host copy of its result, so the card
    is done); return (result, wall seconds, peak device bytes above what
    was allocated when it started, or None off the card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    out = fn()
    wall = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - held
            if dev.type == "cuda" else None)
    return out, wall, peak


def _cost(wall, n_requests, n_configs, peak) -> dict:
    return {"wall_s": wall,
            "us_per_request_config": 1e6 * wall / (n_requests * n_configs),
            "peak_device_bytes": peak}


def run(name, capacity=8192, judge_latency=64, tstar=None, device=None):
    """Baseline and Krites at t* on the whole eval stream of workload
    ``name``. Returns ({policy: summary row}, t*, cost)."""
    dev = get_device(device)
    b = build_benchmark(WORKLOADS[name])
    if tstar is None:
        t0 = time.monotonic()
        tstar = tune_threshold(b, sample=20000, capacity=capacity,
                               device=dev)
        print(f"[{name}] tuned t*={tstar:.2f} ({time.monotonic()-t0:.0f}s),"
              f" static tier={b.static_emb.shape[0]}")
    cfg = CacheConfig(tau_static=tstar, tau_dynamic=tstar,
                      capacity=capacity, judge_latency=judge_latency)
    sweep = sweep_from_configs([cfg, cfg], [False, True])
    rows, wall, peak = _timed(dev, lambda: summarize_sweep(simulate_sweep(
        b.static_emb, b.static_cls, b.eval_emb, b.eval_cls, sweep,
        device=dev)))
    cost = _cost(wall, len(b.eval_cls), 2, peak)
    out = dict(zip(("baseline", "krites"), rows))
    for pol, r in out.items():
        print(f"[{name}] {pol:9s}", {k: (round(v, 4) if isinstance(v, float)
                                        else v) for k, v in r.items()})
    so = [out[p]["static_origin_rate"] for p in ("baseline", "krites")]
    print(f"[{name}] static-origin: {so[0]:.3f} -> {so[1]:.3f}  "
          f"(+{100 * (so[1] / max(so[0], 1e-9) - 1):.0f}%)  t*={tstar}; "
          f"{len(b.eval_cls)} requests x 2 configs in {wall:.1f}s on {dev}")
    return out, tstar, cost


def pareto(rows):
    """Non-dominated subset: maximal hit rate per error level."""
    order = sorted(range(len(rows)),
                   key=lambda i: (rows[i]["error_rate"],
                                  -rows[i]["total_hit_rate"]))
    front, best_hit = [], -1.0
    for i in order:
        if rows[i]["total_hit_rate"] > best_hit:
            best_hit = rows[i]["total_hit_rate"]
            front.append(i)
    return front


def run_sweep(name, capacity=8192, judge_latency=64, side=8, krites=True,
              sample=20000, center=None, device=None):
    """Dense threshold grid -> per-config metrics + Pareto frontier, one
    sweep for the whole grid, on a prefix sample of the eval stream. The
    grid centers on the workload's operating point (``GRID_CENTERS``),
    or on ``tune_threshold``'s t* for a workload without one.
    ``krites=False`` sweeps the baseline policy (Alg. 1)."""
    dev = get_device(device)
    b = build_benchmark(WORKLOADS[name])
    t = center if center is not None else GRID_CENTERS.get(name)
    if t is None:
        t0 = time.monotonic()
        t = float(tune_threshold(b, sample=sample, capacity=capacity,
                                 device=dev))
        print(f"[{name}] grid center from tune_threshold: t*={t:.2f} "
              f"({time.monotonic()-t0:.0f}s)")
    taus = np.round(np.linspace(t - 0.08, t + 0.08, side), 4)
    base = CacheConfig(tau_static=t, tau_dynamic=t, capacity=capacity,
                       judge_latency=judge_latency)
    sweep = sweep_grid(base, krites=krites, tau_static=taus,
                       tau_dynamic=taus)
    rows, wall, peak = _timed(dev, lambda: summarize_sweep(simulate_sweep(
        b.static_emb, b.static_cls, b.eval_emb[:sample],
        b.eval_cls[:sample], sweep, device=dev)))
    grid = [(float(ts), float(td)) for ts in taus for td in taus]
    for (ts, td), r in zip(grid, rows):
        r["tau_static"], r["tau_dynamic"] = ts, td
    front = pareto(rows)
    cost = _cost(wall, len(b.eval_cls[:sample]), len(rows), peak)
    print(f"[{name}] swept {len(rows)} configs "
          f"({'krites' if krites else 'baseline'}) in {wall:.1f}s on {dev} "
          f"({cost['us_per_request_config']:.2f} us per request per config)")
    for i in front:
        r = rows[i]
        print(f"  pareto: tau_s={r['tau_static']:.3f} "
              f"tau_d={r['tau_dynamic']:.3f} hit={r['total_hit_rate']:.4f} "
              f"err={r['error_rate']:.4f} "
              f"static_origin={r['static_origin_rate']:.4f}")
    return {"workload": name, "capacity": capacity, "device": str(dev),
            **cost, "krites": bool(krites), "grid_center": float(t),
            "configs": rows, "pareto": front,
            "pareto_points": [
                {k: rows[i][k] for k in ("tau_static", "tau_dynamic",
                                         "total_hit_rate", "error_rate",
                                         "static_origin_rate")}
                for i in front]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workloads", nargs="*", metavar="WORKLOAD",
                    help=f"any of {', '.join(WORKLOADS)} (default: both)")
    ap.add_argument("--fixed", action="store_true",
                    help="pin t* to the benchmark's operating points")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep the tau_static x tau_dynamic grid instead")
    ap.add_argument("--baseline", action="store_true",
                    help="with --sweep: sweep Algorithm 1, not Krites")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.workloads) - set(WORKLOADS))
    if unknown:
        ap.error(f"unknown workload(s) {unknown}; known: {list(WORKLOADS)}")
    dev = get_device(args.device)
    names = args.workloads or list(TSTAR)
    RESULTS.mkdir(exist_ok=True)
    out = {}
    if args.sweep:
        for n in names:
            out[n] = run_sweep(n, krites=not args.baseline, device=dev)
            p = RESULTS / f"torch_sweep_{n}{'_baseline' if args.baseline else ''}.json"
            p.write_text(json.dumps(out[n], indent=1))
            print(f"wrote {p}")
        return out
    for n in names:
        res, t, cost = run(n, tstar=TSTAR.get(n) if args.fixed else None,
                           device=dev)
        out[n] = {"tstar": t, "device": str(dev), **cost, **res}
    p = RESULTS / "torch_table1_full.json"
    p.write_text(json.dumps(out, indent=1))
    print(f"wrote {p}")
    return out


if __name__ == "__main__":
    main()
