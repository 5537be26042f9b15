"""Recsys retrieval with the shared simsearch substrate (the PyTorch twin
of ``examples/recsys_retrieval.py``).

The same fused cosine top-k that serves the cache's static lookup
scores a SASRec user tower against the item embedding table. On the
card ``cosine_topk`` runs the CUDA simsearch kernel, held here against
the plain PyTorch oracle ``simsearch_ref`` (the reference holds its
Pallas kernel, in interpret mode, against its jnp oracle); on the CPU
it is the plain version itself.

    PYTHONPATH=src python -m repro_torch.examples.recsys_retrieval [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import smoke_config
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.device import batch_from_numpy, get_device
from repro_torch.kernels.simsearch.ops import cosine_topk
from repro_torch.kernels.simsearch.ref import simsearch_ref
from repro_torch.models import recsys


def main(argv=None, *, batch: int = 4, k: int = 10) -> dict:
    """Top-``k`` items for ``batch`` users; returns {"ids", "oracle_ids",
    "kernel": whether the CUDA kernel ran}. Raises if the ids differ
    from the oracle's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)

    cfg = smoke_config("sasrec")
    gen = torch.Generator(device=device).manual_seed(0)
    params = recsys.init_params(cfg, gen, device)
    b = batch_from_numpy(next(recsys_batches(cfg, batch=batch)), device)

    # user tower
    u = recsys.sasrec_user_repr(cfg, params, b)          # (B, d)
    print("user repr:", tuple(u.shape))

    # candidate corpus = item embedding table (the retrieval_cand cell
    # uses 1M rows; here the smoke table)
    cands = params["item_emb"]
    t0 = time.time()
    vals, idx = cosine_topk(u, cands, k=k)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"top-{k} via index: {tuple(idx.shape)} in {time.time()-t0:.3f}s")

    # cross-check against the oracle
    v_ref, i_ref = simsearch_ref(u.to(torch.float32),
                                 cands.to(torch.float32), k)
    kernel = device.type == "cuda"
    what = "CUDA simsearch kernel" if kernel else "plain simsearch (CPU)"
    if not torch.equal(idx, i_ref):
        raise AssertionError(f"{what} != oracle")
    print(f"{what} == oracle (simsearch_ref): OK")
    print("\ntop items for user 0:", idx[0].tolist())
    return {"ids": idx.cpu(), "oracle_ids": i_ref.cpu(), "kernel": kernel}


if __name__ == "__main__":
    main()
