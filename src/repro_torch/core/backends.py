"""FC backend registry (port of ``repro.core.backends``).

    state, feats = compute_features(state, pkts, backend="cuda")

Backends (all emit the identical (n, N_FEATURES) layout and update the
state dict in place):

  * ``serial`` — the per-packet oracle (core/pipeline.py), plain PyTorch.
    The only backend that also takes ``mode="switch"`` (shift arithmetic and
    round-robin decay), which is packet-serial by nature.
  * ``cuda``   — the hand-written FC kernel (kernels/feature_update.py,
    ``csrc/fc_full.cu``); aliases ``pallas`` and ``kernel`` so call sites of
    the JAX package port unchanged.  For CPU tensors it runs the plain
    version.  Exact mode only.
  * ``scan``   — segmented scans over a sorted batch (core/parallel.py),
    plain torch ops on either device; alias ``parallel``.  Exact mode only.
    It also has a record-sampled path (``compute_features_sampled``).

A switch-mode request to an exact-only backend raises ``ValueError``
naming ``serial``, as in the JAX package.

A state whose layout carries its own update (the Count-Min ``sketch``,
``core/sketch.py``) is routed to it before the registry is consulted; the
backend name then only picks the implementation (``cuda`` → the sketch
kernel, anything else → its plain version).  Naming ``sketch`` with a dense
state raises ``ValueError``.

The JAX package's ``bucketed`` and ``sharded`` backends are not ported yet
(ROADMAP queue 1 item 10b); naming one raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.arith import check_mode
from repro_torch.core.state import state_spec_of

# name -> (fn(state, pkts, mode) -> (state, feats), supported modes)
_REGISTRY: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}

# name -> fn(state, pkts, sample_idx) -> (state, feats[sample_idx]): backends
# that emit ONLY the sampled feature rows (the state update still covers
# every packet), exact mode
_SAMPLED: Dict[str, Callable] = {}

_ALIASES = {"pallas": "cuda", "kernel": "cuda", "parallel": "scan"}

# JAX-package backends that later slices port
_NOT_PORTED = {
    "bucketed": "queue 1 item 10b (partitioned FC)",
    "sharded": "queue 1 item 10b (partitioned FC)",
}


def register_backend(name: str, modes: Tuple[str, ...] = ("exact",)):
    """Register ``fn(state, pkts, mode) -> (state, feats)`` as ``name``."""
    def deco(fn):
        _REGISTRY[name] = (fn, modes)
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
    """The default for an arithmetic mode: the FC kernel for exact mode,
    the serial oracle for switch mode."""
    check_mode(mode)
    return "cuda" if mode == "exact" else "serial"


def check_backend_mode(name: str, mode: str) -> None:
    """Raise ``ValueError`` unless the (canonical) dense backend ``name``
    supports the arithmetic ``mode``."""
    check_mode(mode)
    modes = _REGISTRY[name][1]
    if mode not in modes:
        raise ValueError(
            f"FC backend {name!r} does not support mode {mode!r} "
            f"(supports {modes}); use backend='serial' for switch mode")


@register_backend("serial", modes=("exact", "switch"))
def _serial(state, pkts, mode):
    from repro_torch.core.pipeline import process_serial
    return process_serial(state, pkts, mode=mode)


@register_backend("cuda")
def _cuda(state, pkts, mode):
    from repro_torch.kernels.feature_update import feature_update_full
    return feature_update_full(state, pkts)


@register_backend("scan")
def _scan(state, pkts, mode):
    from repro_torch.core.parallel import process_parallel
    return process_parallel(state, pkts)


def _scan_sampled(state, pkts, sample_idx):
    from repro_torch.core.parallel import process_parallel_sampled
    return process_parallel_sampled(state, pkts, sample_idx)


def register_sampled_backend(name: str, fn: Callable) -> None:
    """Register a record-sampled FC path for an existing backend:
    ``fn(state, pkts, sample_idx) -> (state, feats (m, N_FEATURES))``."""
    _SAMPLED[resolve_backend(name)] = fn


register_sampled_backend("scan", _scan_sampled)


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
    check_backend_mode(name, mode)
    return _REGISTRY[name][0](state, pkts, mode)


def compute_features_sampled(state: Dict, pkts: Dict[str, torch.Tensor],
                             sample_idx: torch.Tensor, backend: str = "cuda",
                             mode: str = "exact"
                             ) -> Tuple[Dict, torch.Tensor]:
    """One batch through the FC backend, returning only the sampled rows.

    The state is updated as by :func:`compute_features` and the rows equal
    ``compute_features(...)[1][sample_idx]``.  A backend with a
    record-sampled path (``scan``) never materialises the unsampled rows in
    exact mode; everything else computes the full (n, N_FEATURES) matrix and
    gathers ``sample_idx`` on the device.
    """
    fn = _SAMPLED.get(resolve_backend(backend))
    if fn is not None and mode == "exact" and state_spec_of(state).compute is None:
        return fn(state, pkts, sample_idx)
    state, feats = compute_features(state, pkts, backend=backend, mode=mode)
    return state, feats[sample_idx]
