"""LM training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 50 --batch 8 --seq 128 [--ckpt DIR] [--smoke] \
        [--device cpu] [--devices N]

Trains ``--arch`` (its smoke config with ``--smoke``) on
``synthetic_lm_batches`` with AdamW (``training/optimizer.py``),
printing ``step N loss L gnorm G`` at step 1 and every 5 steps, saving
{"params", "opt"} through ``distributed/checkpoint.save`` every 20 steps
when ``--ckpt`` is given, and ``done`` at the end. Runs on the card
unless ``--device cpu`` is given, and raises on a host without one.

``--devices N`` trains on ``launch/mesh.make_smoke_mesh(N)`` (``("data",
"model")``, model 2 when N is even) with the LM specs
(``distributed/sharding.py``), the reference's ``--devices``: N ranks
started by ``torch.multiprocessing``, each on its own card with NCCL, or
on the CPU with gloo under ``--device cpu``, joined through a
``FileStore`` in a temporary directory (nothing listens on a port).
Rank 0 prints ``mesh {...} | arch ...`` and the step lines. More ranks
than cards raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch, smoke_config_for
from repro_torch.data.lm_data import synthetic_lm_batches
from repro_torch.device import get_device
from repro_torch.distributed import checkpoint as ck
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--devices", type=int, default=0,
                    help="train on a smoke mesh of N ranks (one process "
                         "each; NCCL on cards, gloo with --device cpu)")
    return ap


def _train(args, dev: torch.device, mesh=None) -> list:
    """The training loop; on ``mesh`` the params, AdamW state and each
    batch are DTensors and the step runs under ``use_dp_axes``. Returns
    the printed (step, loss, grad_norm) rows."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import use_dp_axes
    from repro_torch.launch.mesh import dp_axes
    cfg = smoke_config_for(args.arch, dev) if args.smoke \
        else get_arch(args.arch)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    if rank0:
        where = f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}" \
            if mesh is not None else f"device {dev}"
        print(f"{where} | arch {cfg.name}", flush=True)

    adamw = opt.AdamWConfig()
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    dp = ()
    if mesh is not None:
        dp = dp_axes(mesh)
        params = shd.distribute_tree(params, mesh, shd.lm_param_specs(cfg))
    opt_state = opt.init(params, adamw)
    step = opt.make_train_step(
        lambda p, b: tr.train_loss(cfg, p, b,
                                   vocab_chunk_seq=min(args.seq, 512)),
        adamw)
    data = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq)
    rows = []
    for i in range(args.steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        if mesh is not None:
            b = shd.distribute_tree(b, mesh, shd.lm_batch_spec(mesh))
        with use_dp_axes(dp, mesh=mesh):
            params, opt_state, m = step(params, opt_state, b)
        if (i + 1) % 5 == 0 or i == 0:
            loss, gn = (_full(m[k]) for k in ("loss", "grad_norm"))
            rows.append((i + 1, float(loss), float(gn)))
            if rank0:
                print(f"step {i+1:4d} loss {rows[-1][1]:.4f} "
                      f"gnorm {rows[-1][2]:.2f}", flush=True)
        if args.ckpt and (i + 1) % 20 == 0:
            tree = {"params": params, "opt": opt_state}
            if mesh is not None:          # every rank gathers; rank 0 writes
                from repro_torch.tree import tree_map
                tree = tree_map(_full, tree)
            if rank0:
                ck.save(args.ckpt, i + 1, tree)
    if rank0:
        print("done", flush=True)
    return rows


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rank(rank: int, world: int, args, store_path: str, queue) -> None:
    """One rank of ``--devices``: its group, its card (or the CPU), the
    smoke mesh, the loop; rank 0 puts its rows on ``queue``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        rows = _train(args, dev, make_smoke_mesh(world))
        if rank == 0:
            queue.put(rows)
    finally:
        dist.destroy_process_group()


def train_on_devices(args) -> list:
    """``--devices N``: N ranks, one process each, through a FileStore in
    a temporary directory. Returns rank 0's rows."""
    import torch.multiprocessing as mp
    n = args.devices
    if args.device != "cpu":
        get_device("cuda")                        # raises without a card
        if n > torch.cuda.device_count():
            raise ValueError(f"--devices {n}: more ranks than the "
                             f"{torch.cuda.device_count()} card(s) here")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, (n, args, os.path.join(tmp, "store"),
                                   queue), nprocs=n, start_method="spawn")
        return queue.get()


def main(argv=None) -> list:
    """Returns the printed (step, loss, grad_norm) rows."""
    args = _parser().parse_args(argv)
    if args.devices:
        return train_on_devices(args)
    return _train(args, get_device(args.device))


if __name__ == "__main__":
    main()
