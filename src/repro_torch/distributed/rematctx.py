"""Remat (activation-checkpoint) policy context.

The model's layer loop consults the active policy when it wraps each
layer's body, so ``TrainConfig.remat`` reaches the layer without threading
a keyword through the forward's signature.  A port of the JAX package's
``distributed/rematctx.py`` on ``torch.utils.checkpoint`` (non-reentrant):
"full" saves nothing of the layer, "dots" saves only the matrix products'
outputs (JAX's ``checkpoint_dots``), "none" saves everything.
``recomputing()`` is true while the backward recomputes a layer, so
telemetry taken in the forward (``models/moe.count_drops``) counts a call
once.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("none", "dots", "full")


class _State(threading.local):
    def __init__(self):
        self.policy = "none"
        self.recomputing = False


_STATE = _State()
_CHECKPOINT_READY = False


def _ready_checkpoint() -> None:
    """``torch.utils.checkpoint``'s first call imports ``torch._dynamo``,
    and that import leaves a reference cycle through its frames: it would
    hold every frame above the call (a train step's compute copies) until
    the garbage collector ran.  Import it here once, and free the cycle at
    once."""
    global _CHECKPOINT_READY
    if not _CHECKPOINT_READY:
        import torch._dynamo  # noqa: F401
        gc.collect()
        _CHECKPOINT_READY = True


@contextlib.contextmanager
def use_remat(policy: str):
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {POLICIES}")
    if policy != "none":
        _ready_checkpoint()
    prev = _STATE.policy
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


def current_remat() -> str:
    return _STATE.policy


def recomputing() -> bool:
    """True while the backward recomputes a remat'ed layer."""
    return _STATE.recomputing


@contextlib.contextmanager
def _recompute(inner=None):
    prev = _STATE.recomputing
    _STATE.recomputing = True
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        _STATE.recomputing = prev


def _dot_ops():
    aten = torch.ops.aten
    return {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.matmul.default}


def _save_dots(dots, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in dots
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn):
    """Wrap a layer body according to the active policy."""
    policy = _STATE.policy
    if policy == "none":
        return fn
    if policy == "dots":
        policy_fn = functools.partial(_save_dots, _dot_ops())

        def context_fn():
            fwd, rec = create_selective_checkpoint_contexts(policy_fn)
            return fwd, _recompute(rec)
    else:                                                           # "full"
        def context_fn():
            return contextlib.nullcontext(), _recompute()
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)
