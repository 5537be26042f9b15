"""Time ``topk_lowest_index`` (``kernels/simsearch/ref.py``) on the card
at the shapes the serve and retrieval paths give it, in turns with the
tie repair it replaced: ``torch.topk``, then a host read of whether any
row has a tie that could change the choice or the order, and a stable
descending sort of those rows.

    PYTHONPATH=src python -m repro_torch.launch.time_topk

Each shape runs on two inputs made on the card from seed 0: fp32
standard normal scores (no ties), and the same rounded to multiples of
1/16 (ties in every row: the repair's worst case). Both versions must
give the same values and indices. Each round times ``CALLS`` calls of
each version in turn by CUDA events, as launched (the repair's host
read included); the line gives the median of ``ROUNDS`` rounds after a
warm-up round, ms a call.
The last line is one JSON object of the medians.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.device import get_device
from repro_torch.kernels.simsearch.ref import topk_lowest_index

# (label, rows, columns, k): IVF ``select_clusters`` at the serve batch
# (B 32 over 8,192 centroids, nprobe 8), recsys retrieval (one user over
# 1,000,000 candidates, top 100), the sharded lookup's merge of four
# shards' top 4 at B 4096
SHAPES = (("select_clusters B32xK8192 k8", 32, 8192, 8),
          ("retrieval 1x1000000 k100", 1, 1_000_000, 100),
          ("sharded merge B4096x16 k4", 4096, 16, 4))
ROUNDS = 9
CALLS = 20


def topk_tie_repair(sims: torch.Tensor, k: int):
    """The earlier ``topk_lowest_index`` for k > 1, kept only to be
    timed against: ``torch.topk``, then the rows where a tie could change
    the choice or the order (a repeated value among the k, or more than k
    values at or above the k-th) redone by a stable descending sort,
    after reading back whether there is any."""
    flat = sims.reshape(-1, sims.shape[-1])
    vals, idx = torch.topk(flat, k, dim=-1)
    ties = ((flat >= vals[:, -1:]).sum(-1) > k) \
        | (vals[:, 1:] == vals[:, :-1]).any(-1)
    if bool(ties.any()):
        rows = ties.nonzero()[:, 0]
        v, i = torch.sort(flat[rows], dim=-1, descending=True, stable=True)
        vals[rows] = v[:, :k]
        idx[rows] = i[:, :k]
    shape = (*sims.shape[:-1], k)
    return vals.reshape(shape), idx.to(torch.int32).reshape(shape)


def _turns_ms(fns: dict, sims, k) -> dict:
    """{name: median ms a call}: one warm-up round, then ``ROUNDS``
    rounds, each timing ``CALLS`` calls of every function in turn."""
    times = {n: [] for n in fns}
    for r in range(ROUNDS + 1):
        for name, fn in fns.items():
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(CALLS):
                fn(sims, k)
            t1.record()
            t1.synchronize()
            if r:
                times[name].append(t0.elapsed_time(t1) / CALLS)
    return {n: sorted(t)[len(t) // 2] for n, t in times.items()}


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    dev = get_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, rows, cols, k in SHAPES:
        normal = torch.randn((rows, cols), generator=gen, device=dev)
        for data, sims in (("normal", normal),
                           ("ties", torch.round(normal * 16) / 16)):
            want, got = topk_tie_repair(sims, k), topk_lowest_index(sims, k)
            if not (torch.equal(want[0], got[0])
                    and torch.equal(want[1], got[1])):
                raise AssertionError(f"{label} {data}: the two differ")
            res = _turns_ms({"tie_repair": topk_tie_repair,
                             "int64_keys": topk_lowest_index}, sims, k)
            out[f"{label} {data}"] = res
            print(f"[topk] {label} {data}: int64 keys "
                  f"{res['int64_keys']:.4f} ms, earlier tie repair "
                  f"{res['tie_repair']:.4f} ms (median of {ROUNDS} rounds "
                  f"of {CALLS} calls, CUDA events as launched; same "
                  f"values and indices)")
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "topk_ms": out}))
    return out


if __name__ == "__main__":
    main()
