"""Train a small LM for a few hundred steps with the production loop:
AdamW, LR schedule, checkpoint/restart (the PyTorch twin of
``examples/train_lm.py``). On the card its attention is the flash
kernel under autograd (fp32, head dim 64).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import QWEN3_1_7B
from repro_torch.data.lm_data import synthetic_lm_batches
from repro_torch.device import batch_from_numpy, get_device
from repro_torch.models import transformer as tr
from repro_torch.training.train_loop import TrainConfig, train
from repro_torch.tree import leaves


def main(argv=None) -> dict:
    """Returns {"first", "last"}: the first and last logged losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)

    # ~4M-param member of the qwen3 family (same code path as the 1.7B)
    cfg = dataclasses.replace(
        QWEN3_1_7B, name="qwen3-mini", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=512,
        dtype="float32", attn_chunk=64)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tr.init_params(cfg, gen, device)
    n = sum(x.numel() for x in leaves(params))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    data = (batch_from_numpy(b, device) for b in
            synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq))

    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainConfig(n_steps=args.steps, ckpt_dir=ckpt,
                           ckpt_every=50, log_every=10, lr=1e-3,
                           warmup_steps=20)
        params, _, hist = train(
            lambda p, b: tr.train_loss(cfg, p, b, vocab_chunk_seq=32),
            params, data, tcfg)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first - 0.3 else 'WARN: flat'})")
    return {"first": first, "last": last}


if __name__ == "__main__":
    main()
