"""FC backend registry (port of ``repro.core.backends``).

    state, feats = compute_features(state, pkts, backend="cuda")

Backends (both emit the identical (n, N_FEATURES) layout and update the
state dict in place):

  * ``serial`` — the per-packet oracle (core/pipeline.py), plain PyTorch.
  * ``cuda``   — the hand-written FC kernel (kernels/feature_update.py,
    ``csrc/fc_full.cu``); aliases ``pallas`` and ``kernel`` so call sites of
    the JAX package port unchanged.  For CPU tensors it runs the plain
    version.

A state whose layout carries its own update (the Count-Min ``sketch``,
``core/sketch.py``) is routed to it before the registry is consulted; the
backend name then only picks the implementation (``cuda`` → the sketch
kernel, ``serial`` → its plain version).  Naming ``sketch`` with a dense
state raises ``ValueError``.

Exact mode only.  The JAX package's ``scan``, ``bucketed`` and ``sharded``
backends are not ported yet (ROADMAP queue 1 items 7 and 10); naming one
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.arith import check_mode
from repro_torch.core.state import state_spec_of

_REGISTRY: Dict[str, Callable] = {}

_ALIASES = {"pallas": "cuda", "kernel": "cuda"}

# JAX-package backends that later slices port
_NOT_PORTED = {
    "scan": "queue 1 item 7 (scan FC backend)",
    "parallel": "queue 1 item 7 (scan FC backend)",
    "bucketed": "queue 1 item 10 (partitioned FC)",
    "sharded": "queue 1 item 10 (partitioned FC)",
}


def register_backend(name: str):
    """Register ``fn(state, pkts) -> (state, feats)`` as ``name``."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(name: str) -> str:
    """Canonical backend name (alias-aware); raises on unknown names."""
    name = _ALIASES.get(name, name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"FC backend {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name]})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown FC backend {name!r}; "
                         f"available: {available_backends()}")
    return name


def default_backend(mode: str = "exact") -> str:
    check_mode(mode)
    return "cuda"


@register_backend("serial")
def _serial(state, pkts):
    from repro_torch.core.pipeline import process_serial
    return process_serial(state, pkts)


@register_backend("cuda")
def _cuda(state, pkts):
    from repro_torch.kernels.feature_update import feature_update_full
    return feature_update_full(state, pkts)


def compute_features(state: Dict, pkts: Dict[str, torch.Tensor],
                     backend: str = "cuda", mode: str = "exact"
                     ) -> Tuple[Dict, torch.Tensor]:
    """Run one packet batch through the selected FC backend.

    ``state``: an ``init_state`` dict, updated IN PLACE (this replaces the
    JAX package's donation contract, DESIGN.md §8: clone the state first if
    a restore point is needed).  ``pkts``: ``to_torch`` packet tensors on
    the state's device.  Returns ``(state, feats (n, N_FEATURES))``.
    """
    spec = state_spec_of(state)
    if backend == "sketch" and spec.compute is None:
        raise ValueError(
            "backend='sketch' needs sketch-backed state; build it with "
            "init_state(n_slots, state_backend='sketch', rows=R); the state "
            f"passed here is {spec.name!r}")
    name = resolve_backend(backend)
    if spec.compute is not None:
        return spec.compute(state, pkts, mode=mode, fc_backend=name)
    check_mode(mode)
    return _REGISTRY[name](state, pkts)


def compute_features_sampled(state: Dict, pkts: Dict[str, torch.Tensor],
                             sample_idx: torch.Tensor, backend: str = "cuda",
                             mode: str = "exact"
                             ) -> Tuple[Dict, torch.Tensor]:
    """One batch through the FC backend, returning only the sampled rows.

    No ported backend or layout has a record-sampled path, so this computes
    the full (n, N_FEATURES) matrix and gathers ``sample_idx`` on the
    device.
    """
    state, feats = compute_features(state, pkts, backend=backend, mode=mode)
    return state, feats[sample_idx]
