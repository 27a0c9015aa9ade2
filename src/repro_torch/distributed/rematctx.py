"""Remat (activation-checkpoint) policy context.

The model's layer loop consults the active policy when it wraps each
layer's body, so ``TrainConfig.remat`` reaches the layer without threading
a keyword through the forward's signature.  A port of the JAX package's
``distributed/rematctx.py`` on ``torch.utils.checkpoint`` (non-reentrant):
"full" saves nothing of the layer, "dots" saves only the matrix products'
outputs (JAX's ``checkpoint_dots``), "none" saves everything.
``recomputing()`` is true while the backward recomputes a layer, so
telemetry taken in the forward (``models/moe.count_drops``) counts a call
once.  ``no_residuals`` runs a function whose products its backward
recomputes under every policy (JAX's ``jax.checkpoint`` around a function
inside a layer): blockwise attention's per-block scores.
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
        self.in_layer = False       # in a remat'ed layer's forward or recompute
        self.unsaved = False        # in ``no_residuals`` inside such a layer


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
def _layer(inner=None, recompute: bool = False):
    """The state of a remat'ed layer's forward, or of its recompute in the
    backward (``recompute``), around ``inner`` (the selective checkpoint's
    context under "dots")."""
    prev = _STATE.in_layer, _STATE.recomputing
    _STATE.in_layer = True
    _STATE.recomputing = recompute or prev[1]
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        _STATE.in_layer, _STATE.recomputing = prev


def _dot_ops():
    aten = torch.ops.aten
    return {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.matmul.default}


def _save_dots(dots, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in dots and not _STATE.unsaved
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
            return _layer(fwd), _layer(rec, recompute=True)
    else:                                                           # "full"
        def context_fn():
            return _layer(), _layer(recompute=True)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def no_residuals(fn, *args):
    """``fn(*args)``, whose backward recomputes every tensor ``fn`` makes:
    the forward leaves it only ``args``.  Inside a remat'ed layer, whose
    checkpoint recomputes ``fn`` already, this only keeps "dots" from
    saving ``fn``'s matrix products (a checkpoint nested in the layer's
    would not: selective checkpointing caches the inner products all the
    same, and ``fn`` would run once more).  Elsewhere ``fn`` runs under a
    checkpoint of its own where a gradient flows to ``args``."""
    if _STATE.in_layer:
        prev = _STATE.unsaved
        _STATE.unsaved = True
        try:
            return fn(*args)
        finally:
            _STATE.unsaved = prev
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        _ready_checkpoint()
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
