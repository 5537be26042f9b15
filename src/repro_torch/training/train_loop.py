"""Training loop: microbatched gradients, the LR schedule, AdamW,
periodic checkpoints and resume (port of
``repro/training/train_loop.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed.overlap import accumulate_microbatches
from repro_torch.training import optimizer as opt_lib
from repro_torch.tree import tree_map


@dataclass
class TrainConfig:
    n_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = ""
    log_every: int = 10
    n_microbatches: int = 1
    warmup_steps: int = 10
    lr: float = 3e-4
    lr_min_ratio: float = 0.1


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32, at ``step`` (the number of
    steps taken before this one)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.n_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def make_step(loss_fn: Callable, tcfg: TrainConfig,
              adamw: opt_lib.AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics) with
    microbatched gradient accumulation and the scheduled LR. As in the
    reference, AdamW runs at lr = 1 and the scheduled lr then
    interpolates: ``old + (new - old) * lr`` for the params and the
    master (which rounds otherwise than ``lr * update``)."""
    if tcfg.n_microbatches > 1:
        grad_fn = accumulate_microbatches(loss_fn, tcfg.n_microbatches)
    else:
        grad_fn = opt_lib.value_and_grad(loss_fn)
    unit = dataclasses.replace(adamw, lr=1.0)

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        lr = lr_schedule(tcfg, opt_state["step"])
        new_p, new_s, gnorm = opt_lib.update(grads, opt_state, params, unit)
        with torch.no_grad():
            def lerp(old, new):
                return old + (new - old) * lr
            new_p = tree_map(lerp, params, new_p)
            new_s["master"] = tree_map(lerp, opt_state["master"],
                                       new_s["master"])
        return new_p, new_s, {"loss": loss, "grad_norm": gnorm, "lr": lr}
    return step


def train(loss_fn: Callable,
          params: Any,
          data_iter: Iterator,
          tcfg: TrainConfig,
          adamw: Optional[opt_lib.AdamWConfig] = None,
          jit: bool = True) -> tuple:
    """The training loop on one device. Resumes from the newest
    checkpoint under ``tcfg.ckpt_dir`` when there is one (the data
    iterator is the caller's: it is not advanced past the steps already
    taken), saves
    every ``ckpt_every`` steps and at the end, keeping the newest three.
    ``jit`` is taken for the reference's signature and has no effect:
    the port runs eagerly. Returns (params, opt_state, history)."""
    del jit
    adamw = adamw or opt_lib.AdamWConfig()
    opt_state = opt_lib.init(params, adamw)
    step_fn = make_step(loss_fn, tcfg, adamw)

    start = 0
    if tcfg.ckpt_dir:
        last = ckpt_lib.latest_step(tcfg.ckpt_dir)
        if last is not None:
            state = ckpt_lib.restore(
                tcfg.ckpt_dir, last, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = last

    history = []
    t0 = time.time()
    for i in range(start, tcfg.n_steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % tcfg.log_every == 0 or i == start:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=i + 1, wall_s=round(time.time() - t0, 2))
            history.append(m)
            print(f"step {i+1:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
        if tcfg.ckpt_dir and ((i + 1) % tcfg.ckpt_every == 0
                              or i + 1 == tcfg.n_steps):
            ckpt_lib.save(tcfg.ckpt_dir, i + 1,
                          {"params": params, "opt": opt_state})
            ckpt_lib.prune(tcfg.ckpt_dir)
    return params, opt_state, history
