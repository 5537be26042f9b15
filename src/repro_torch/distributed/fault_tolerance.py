"""Fault tolerance for long-running jobs (port of
``repro/distributed/fault_tolerance.py``).

- HeartbeatMonitor: workers post heartbeats; a missed deadline marks the
  worker dead and fires a callback (the launcher's restart path).
- run_with_restarts: drives a step function under a checkpoint schedule;
  on failure, restores the latest checkpoint and replays. Exactly-once
  side effects are the caller's concern; training state is idempotent.
- elastic_remesh: move a restored state onto other devices (the
  one-controller counterpart of re-``device_put``-ing with new
  shardings).
- StragglerPolicy: deadline-based re-dispatch for data-pipeline /
  judge-pool work items (first completion wins; tasks are idempotent).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.tree import tree_map


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 10.0,
                 on_dead: Optional[Callable[[str], None]] = None):
        self.deadline = deadline_s
        self.on_dead = on_dead
        self._beats: Dict[str, float] = {}
        self._dead: set = set()
        self._lock = threading.Lock()

    def beat(self, worker: str):
        with self._lock:
            self._beats[worker] = time.monotonic()
            self._dead.discard(worker)

    def check(self) -> list:
        """Returns newly-dead workers."""
        now = time.monotonic()
        newly = []
        with self._lock:
            for w, t in self._beats.items():
                if w not in self._dead and now - t > self.deadline:
                    self._dead.add(w)
                    newly.append(w)
        for w in newly:
            if self.on_dead:
                self.on_dead(w)
        return newly

    @property
    def dead(self) -> set:
        with self._lock:
            return set(self._dead)


@dataclass
class RestartReport:
    steps_run: int = 0
    failures: int = 0
    restarts: int = 0
    restored_steps: list = field(default_factory=list)


def run_with_restarts(step_fn: Callable[[int, object], object],
                      init_state: object,
                      n_steps: int,
                      ckpt_dir: str,
                      ckpt_every: int = 10,
                      max_restarts: int = 5,
                      state_shardings=None) -> tuple:
    """Run ``state = step_fn(i, state)`` for n_steps with checkpointing;
    on any exception, restore the latest checkpoint and continue.

    ``step_fn`` must return a new state and leave its input as it was
    (as the reference's immutable arrays are): ``init_state`` is resumed
    from when no checkpoint exists yet, and an in-place update would
    have changed it. Only a Python-level exception is a recoverable
    failure here: a CUDA launch fault leaves the process's CUDA context
    unusable, and its recovery is a new process restoring from
    ``ckpt_dir``, which this function also does at its start.
    ``state_shardings`` is a tree of devices for ``checkpoint.restore``.

    Returns (final_state, RestartReport).
    """
    report = RestartReport()
    state = init_state
    start = 0
    last = ckpt_lib.latest_step(ckpt_dir)
    if last is not None:
        state = ckpt_lib.restore(ckpt_dir, last, state,
                                 shardings=state_shardings)
        start = last
        report.restored_steps.append(last)

    i = start
    restarts = 0
    while i < n_steps:
        try:
            state = step_fn(i, state)
            i += 1
            report.steps_run += 1
            if i % ckpt_every == 0 or i == n_steps:
                ckpt_lib.save(ckpt_dir, i, state)
                ckpt_lib.prune(ckpt_dir)
        except Exception:  # noqa: BLE001 — node failure: restart path
            report.failures += 1
            restarts += 1
            if restarts > max_restarts:
                raise
            last = ckpt_lib.latest_step(ckpt_dir)
            if last is None:
                state, i = init_state, 0
            else:
                state = ckpt_lib.restore(ckpt_dir, last, state,
                                         shardings=state_shardings)
                i = last
            report.restarts += 1
            report.restored_steps.append(i)
    return state, report


def elastic_remesh(tree, new_devices):
    """Place each leaf of a state tree on the device at the same place
    in ``new_devices`` (a tree of ``torch.device``s shaped as ``tree``),
    e.g. after restoring a checkpoint onto another set of cards; a numpy
    leaf becomes a tensor there."""
    return tree_map(lambda x, d: torch.as_tensor(x).to(torch.device(d)),
                    tree, new_devices)


class StragglerPolicy:
    """Deadline-based speculative re-dispatch for idempotent work items."""

    def __init__(self, deadline_s: float):
        self.deadline = deadline_s
        self._started: Dict[object, float] = {}
        self.redispatched = 0

    def started(self, key):
        self._started[key] = time.monotonic()

    def finished(self, key):
        self._started.pop(key, None)

    def stragglers(self) -> list:
        now = time.monotonic()
        out = [k for k, t in self._started.items()
               if now - t > self.deadline]
        for k in out:
            self._started[k] = now
            self.redispatched += 1
        return out
