"""Remat (activation-checkpoint) policy context.

The model's layer loop consults the active policy when it wraps each
layer's body, so ``TrainConfig.remat`` reaches the layer without threading
a keyword through the forward's signature.  A port of the JAX package's
``distributed/rematctx.py`` on ``torch.utils.checkpoint`` (non-reentrant):
"full" saves nothing of the layer, "dots" saves only the matrix products'
outputs (JAX's ``checkpoint_dots``), "none" saves everything.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("none", "dots", "full")


class _State(threading.local):
    def __init__(self):
        self.policy = "none"


_STATE = _State()


@contextlib.contextmanager
def use_remat(policy: str):
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {POLICIES}")
    prev = _STATE.policy
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


def current_remat() -> str:
    return _STATE.policy


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
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_save_dots, _dot_ops()))
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)   # "full"
