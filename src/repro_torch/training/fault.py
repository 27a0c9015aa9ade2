"""Fault tolerance: resumable train loop, failure injection, straggler watch.

A port of the JAX package's ``training/fault.py``.  ``resilient_loop`` is
the production loop skeleton: checkpoint every ``ckpt_every`` steps
(async), catch step failures, restore the latest valid checkpoint and
continue — the same restart path a preempted job takes.
``FailureInjector`` deterministically raises inside chosen steps so the
recovery path is tested, not assumed.

``StragglerMonitor`` keeps an EWMA of step wall-time and flags steps that
exceed ``threshold``x the moving average — the hook where a deployment
triggers its mitigation.  On one host we log and count; the policy hook is
injectable.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from repro_torch.training.checkpoint import CheckpointManager


class FailureInjector:
    """Raises RuntimeError at the given (0-based) global steps, once each."""

    def __init__(self, fail_at: List[int]):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, alpha: float = 0.2,
                 action: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.stragglers: List[int] = []
        self.action = action

    def record(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.stragglers.append(step)
            if self.action:
                self.action(step, dt, self.ewma)
        # stragglers don't poison the EWMA
        if self.ewma is None:
            self.ewma = dt
        elif not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def resilient_loop(train_step: Callable, state, batches, ckpt: CheckpointManager,
                   ckpt_every: int = 10, injector: Optional[FailureInjector] = None,
                   monitor: Optional[StragglerMonitor] = None,
                   max_restarts: int = 10) -> Dict:
    """Run train_step over ``batches`` (a list) with checkpoint/restart.

    Returns {"state": final_state, "metrics": last, "restarts": n,
    "completed": steps_run}.  A step's time ends in a sync on its loss.
    """
    restarts = 0
    metrics = None
    step = 0
    n = len(batches)
    ckpt.save(0, state)
    while step < n:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.time()
            state, metrics = train_step(state, batches[step])
            float(metrics["loss"])
            if monitor is not None:
                monitor.record(step, time.time() - t0)
            step += 1
            if step % ckpt_every == 0:
                ckpt.save_async(step, state)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait()
            state, restored_step = ckpt.restore(state)
            step = restored_step
    ckpt.wait()
    ckpt.save(step, state)
    return {"state": state, "metrics": metrics, "restarts": restarts,
            "completed": step}
