"""Run-time flags threaded to the model stacks without signature changes.

A port of the JAX package's ``distributed/flags.py``: three thread-local
contexts and their readers.
  * ``use_scan_unroll``: JAX unrolls its layer scans for the dry run's cost
    analysis.  The port's layer loops are Python loops already, so the flag
    changes nothing here: its meta-device dry run (``launch/dryrun.py``)
    counts every layer as it runs.
  * ``use_local_moe_dispatch(mesh, dp_axes, ep_axis)``: ``models/moe.moe_ffn``
    takes ``moe_ffn_local``, each place routing its own tokens to its own
    experts, on the port's single-controller ``Mesh``.
  * ``use_remat_override``: a remat policy that overrides the
    ``TrainConfig``'s (the dry run's variants).
"""
from __future__ import annotations

import contextlib
import threading


class _State(threading.local):
    def __init__(self):
        self.scan_unroll = False
        self.moe_dispatch = None   # None -> dense; else (mesh, dp_axes, ep_axis)
        self.remat_override = None


_STATE = _State()


@contextlib.contextmanager
def use_scan_unroll(on: bool = True):
    """Unroll the layer scans (the port's loops are unrolled already)."""
    prev = _STATE.scan_unroll
    _STATE.scan_unroll = on
    try:
        yield
    finally:
        _STATE.scan_unroll = prev


def scan_unroll() -> bool:
    return _STATE.scan_unroll


@contextlib.contextmanager
def use_local_moe_dispatch(mesh, dp_axes, ep_axis="model"):
    """Route the MoE FFN through ``moe_ffn_local``: the token -> expert
    scatter stays on each place, and the expert outputs combine with one sum
    over the EP axis."""
    prev = _STATE.moe_dispatch
    _STATE.moe_dispatch = (mesh, tuple(dp_axes) if not isinstance(dp_axes, str)
                           else (dp_axes,), ep_axis)
    try:
        yield
    finally:
        _STATE.moe_dispatch = prev


def moe_dispatch():
    return _STATE.moe_dispatch


@contextlib.contextmanager
def use_remat_override(policy):
    """Override the per-arch TrainConfig remat policy."""
    prev = _STATE.remat_override
    _STATE.remat_override = policy
    try:
        yield
    finally:
        _STATE.remat_override = prev


def remat_override():
    return _STATE.remat_override
