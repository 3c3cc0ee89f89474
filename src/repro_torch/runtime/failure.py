"""Fault tolerance runtime: watchdog, straggler detection, failure recovery,
elastic re-meshing (the reference's ``runtime/failure.py``, which imports no
JAX; the port keeps its own copy).

On a real multi-host deployment each host runs the watchdog around its own
train loop; a single process stands in for the hosts here, but the logic —
EMA step timing, deviation flags, checkpoint-restart, re-mesh on shrunken
device sets — is the code path the tests exercise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple


@dataclasses.dataclass
class StepTimer:
    """Per-worker EMA of step durations; flags stragglers (> factor x median
    of peers) — the mitigation hook decides whether to drop/replace."""

    ema_alpha: float = 0.2
    straggler_factor: float = 2.0
    times: Dict[str, float] = dataclasses.field(default_factory=dict)

    def record(self, worker: str, seconds: float) -> None:
        prev = self.times.get(worker)
        self.times[worker] = (seconds if prev is None
                              else prev * (1 - self.ema_alpha)
                              + seconds * self.ema_alpha)

    def stragglers(self) -> List[str]:
        if len(self.times) < 2:
            return []
        vals = sorted(self.times.values())
        med = vals[len(vals) // 2]
        return [w for w, t in self.times.items()
                if t > self.straggler_factor * med]


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at: Tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.failures = 0

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected failure at step {step}")


def largest_valid_mesh(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Elastic re-mesh policy: after losing devices, keep TP size (weights
    layout) and shrink the data axis to the largest multiple that fits."""
    if n_devices < model_parallel:
        raise ValueError("fewer devices than the model-parallel degree")
    data = n_devices // model_parallel
    # power-of-two data axis keeps batch divisibility simple
    data = 2 ** int(math.log2(data))
    return (data, model_parallel)


def run_with_recovery(train_loop: Callable[[int], int],
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      total_steps: int,
                      checkpoint_every: int,
                      max_restarts: int = 8) -> Dict[str, int]:
    """Drive a (resumable) train loop to completion through failures.

    train_loop(start_step) runs until failure or completion and returns the
    last completed step. restore_fn() -> step to resume from.
    """
    restarts = 0
    step = restore_fn()
    while step < total_steps:
        try:
            step = train_loop(step)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore_fn()
    return {"final_step": step, "restarts": restarts}
