"""AdamW with fp32 master weights (port of
``repro/training/optimizer.py``).

Optimizer state mirrors the parameter tree (nested dicts and lists of
tensors):

    state = {"mu": moments_dtype, "nu": moments_dtype, "master": fp32,
             "step": int32 scalar}

Params may live in bf16; updates are computed against the fp32 master
and cast back. Params may be DTensors (``distributed/sharding.py``):
the state is then placed as the params, the step replicated. Updates are out of place: :func:`update` returns new
tensors and leaves its arguments as they were, as the reference's pure
functions do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from repro_torch.distributed.act_sharding import local_of, replicated
from repro_torch.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # store moments in bf16 to halve optimizer memory (master stays fp32)
    moments_dtype: str = "float32"


def init(params: Any, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.moments_dtype)

    def zeros(p):            # a DTensor parameter gets a DTensor placed alike
        return torch.zeros_like(p, dtype=mdt)
    p0 = leaves(params)[0]
    step = replicated(torch.zeros((), dtype=torch.int32,
                                  device=local_of(p0).device), p0)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params),
            "step": step}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in fp32, the leaves
    summed one after another in the reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves(tree)))


@torch.no_grad()
def update(grads: Any, state: dict, params: Any, cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    mdt = getattr(torch, cfg.moments_dtype)

    def upd(g, mu, nu, master, p):
        g = g.to(torch.float32) * scale
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g * g
        mhat = mu32 / c1
        vhat = nu32 / c2
        new_master = master - cfg.lr * (
            mhat / (torch.sqrt(vhat) + cfg.eps)
            + cfg.weight_decay * master)
        return (mu32.to(mdt), nu32.to(mdt), new_master,
                new_master.to(p.dtype))

    out = [upd(*a) for a in zip(*(leaves(t) for t in (
        grads, state["mu"], state["nu"], state["master"], params)))]
    mu, nu, master, new_p = (unflatten(params, [o[i] for o in out])
                             for i in range(4))
    return new_p, {"mu": mu, "nu": nu, "master": master, "step": step}, \
        gnorm


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` for a loss over a parameter tree:
    ``fn(params, batch) -> (loss, grads)``, the gradient of every leaf
    by ``torch.autograd`` (a leaf the loss does not use gets zeros, as
    in JAX), the loss detached."""
    def fn(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, flat), batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)
    return fn


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """loss_fn(params, batch) -> scalar. Returns
    ``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``."""
    grad_fn = value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        new_p, new_s, gnorm = update(grads, opt_state, params, opt_cfg)
        return new_p, new_s, {"loss": loss, "grad_norm": gnorm}
    return step
