"""LM training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 50 --batch 8 --seq 128 [--ckpt DIR] [--smoke] \
        [--device cpu]

Trains ``--arch`` (its smoke config with ``--smoke``) on
``synthetic_lm_batches`` with AdamW (``training/optimizer.py``),
printing ``step N loss L gnorm G`` at step 1 and every 5 steps, saving
{"params", "opt"} through ``distributed/checkpoint.save`` every 20 steps
when ``--ckpt`` is given, and ``done`` at the end. Runs on the card
unless ``--device cpu`` is given, and raises on a host without one. The
reference's ``--devices`` (forced XLA host devices for a mesh) is not
taken: meshes are ROADMAP.md queue 4.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, smoke_config_for
from repro_torch.data.lm_data import synthetic_lm_batches
from repro_torch.device import get_device
from repro_torch.distributed import checkpoint as ck
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt


def main(argv=None) -> list:
    """Returns the printed (step, loss, grad_norm) rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    cfg = smoke_config_for(args.arch, dev) if args.smoke \
        else get_arch(args.arch)
    print(f"device {dev} | arch {cfg.name}")

    adamw = opt.AdamWConfig()
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt_state = opt.init(params, adamw)
    step = opt.make_train_step(
        lambda p, b: tr.train_loss(cfg, p, b,
                                   vocab_chunk_seq=min(args.seq, 512)),
        adamw)
    data = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq)
    rows = []
    for i in range(args.steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        params, opt_state, m = step(params, opt_state, b)
        if (i + 1) % 5 == 0 or i == 0:
            rows.append((i + 1, float(m["loss"]), float(m["grad_norm"])))
            print(f"step {i+1:4d} loss {rows[-1][1]:.4f} "
                  f"gnorm {rows[-1][2]:.2f}")
        if args.ckpt and (i + 1) % 20 == 0:
            ck.save(args.ckpt, i + 1, {"params": params, "opt": opt_state})
    print("done")
    return rows


if __name__ == "__main__":
    main()
