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
  * ``bucketed`` — the scan backend's two-level form (core/bucketed.py):
    each key type's flow-sorted batch cut into ``buckets=S`` equal buckets,
    scanned apart and joined by a combine over the bucket tails.  Exact
    mode only; record-sampled path too.  Bit for bit ``scan`` at S=1.
  * ``sharded`` — hash-partitioned flow tables (core/sharded.py):
    ``shards=S`` shards, each replaying the serial step.  Both modes, bit
    for bit ``serial``.

Options reach the backend as keywords (``compute_features(..., backend=
"bucketed", buckets=8)``).  Each backend declares the options it takes, and
any other raises ``TypeError``, so a misspelt option never measures the
default.  A switch-mode request to an exact-only backend raises
``ValueError`` naming ``serial`` and ``sharded``, as in the JAX package.

A state whose layout carries its own update (the Count-Min ``sketch``,
``core/sketch.py``) is routed to it before the registry is consulted; the
backend name then only picks the implementation (``cuda`` → the sketch
kernel, anything else → its plain version), and it takes the partition
options ``buckets``/``shards`` and ignores them.  Naming ``sketch`` with a
dense state raises ``ValueError``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.arith import check_mode
from repro_torch.core.state import state_spec_of


class _Backend(NamedTuple):
    fn: Callable               # fn(state, pkts, mode, **options) -> (state, feats)
    modes: Tuple[str, ...]     # arithmetic modes it supports
    options: frozenset         # keyword options it takes


_REGISTRY: Dict[str, _Backend] = {}

# name -> fn(state, pkts, sample_idx, **options) -> (state, feats[sample_idx]):
# backends that emit ONLY the sampled feature rows (the state update still
# covers every packet), exact mode
_SAMPLED: Dict[str, Callable] = {}

_ALIASES = {"pallas": "cuda", "kernel": "cuda", "parallel": "scan"}


def register_backend(name: str, modes: Tuple[str, ...] = ("exact",),
                     options: Tuple[str, ...] = ()):
    """Register ``fn(state, pkts, mode, **options) -> (state, feats)`` as
    ``name``; ``options`` names the keyword options it takes."""
    def deco(fn):
        _REGISTRY[name] = _Backend(fn, modes, frozenset(options))
        return fn
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(name: str) -> str:
    """Canonical backend name (alias-aware); raises on unknown names."""
    name = _ALIASES.get(name, name)
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
    modes = _REGISTRY[name].modes
    if mode not in modes:
        raise ValueError(
            f"FC backend {name!r} does not support mode {mode!r} "
            f"(supports {modes}); use backend='serial' or 'sharded' for "
            "switch mode")


def check_backend_options(name: str, kw: Dict) -> None:
    """Raise ``TypeError`` for any option the (canonical) dense backend
    ``name`` does not take."""
    unknown = set(kw) - _REGISTRY[name].options
    if unknown:
        raise TypeError(
            f"FC backend {name!r} got unexpected options {sorted(unknown)}; "
            f"accepted: {sorted(_REGISTRY[name].options)}")


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


@register_backend("bucketed", options=("buckets",))
def _bucketed(state, pkts, mode, buckets: int = 4):
    from repro_torch.core.bucketed import process_bucketed
    return process_bucketed(state, pkts, buckets=buckets, mode=mode)


@register_backend("sharded", modes=("exact", "switch"), options=("shards",))
def _sharded(state, pkts, mode, shards: int = 4):
    from repro_torch.core.sharded import process_sharded
    return process_sharded(state, pkts, shards=shards, mode=mode)


def _scan_sampled(state, pkts, sample_idx):
    from repro_torch.core.parallel import process_parallel_sampled
    return process_parallel_sampled(state, pkts, sample_idx)


def _bucketed_sampled(state, pkts, sample_idx, buckets: int = 4):
    from repro_torch.core.bucketed import process_bucketed_sampled
    return process_bucketed_sampled(state, pkts, sample_idx, buckets=buckets)


def register_sampled_backend(name: str, fn: Callable) -> None:
    """Register a record-sampled FC path for an existing backend:
    ``fn(state, pkts, sample_idx, **options) -> (state, feats (m,
    N_FEATURES))``, taking the backend's options."""
    _SAMPLED[resolve_backend(name)] = fn


register_sampled_backend("scan", _scan_sampled)
register_sampled_backend("bucketed", _bucketed_sampled)


def compute_features(state: Dict, pkts: Dict[str, torch.Tensor],
                     backend: str = "cuda", mode: str = "exact", **kw
                     ) -> Tuple[Dict, torch.Tensor]:
    """Run one packet batch through the selected FC backend.

    ``state``: an ``init_state`` dict, updated IN PLACE (this replaces the
    JAX package's donation contract, DESIGN.md §8: clone the state first if
    a restore point is needed).  ``pkts``: ``to_torch`` packet tensors on
    the state's device.  ``kw``: the backend's options (``buckets=`` for
    ``bucketed``, ``shards=`` for ``sharded``).  Returns ``(state, feats
    (n, N_FEATURES))``.
    """
    spec = state_spec_of(state)
    if backend == "sketch" and spec.compute is None:
        raise ValueError(
            "backend='sketch' needs sketch-backed state; build it with "
            "init_state(n_slots, state_backend='sketch', rows=R); the state "
            f"passed here is {spec.name!r}")
    name = resolve_backend(backend)
    if spec.compute is not None:
        return spec.compute(state, pkts, mode=mode, fc_backend=name, **kw)
    check_backend_mode(name, mode)
    check_backend_options(name, kw)
    return _REGISTRY[name].fn(state, pkts, mode, **kw)


def compute_features_sampled(state: Dict, pkts: Dict[str, torch.Tensor],
                             sample_idx: torch.Tensor, backend: str = "cuda",
                             mode: str = "exact", **kw
                             ) -> Tuple[Dict, torch.Tensor]:
    """One batch through the FC backend, returning only the sampled rows.

    The state is updated as by :func:`compute_features` and the rows equal
    ``compute_features(...)[1][sample_idx]``.  A backend with a
    record-sampled path (``scan``, ``bucketed``) never materialises the
    unsampled rows in exact mode; everything else computes the full (n,
    N_FEATURES) matrix and gathers ``sample_idx`` on the device.
    """
    name = resolve_backend(backend)
    fn = _SAMPLED.get(name)
    if fn is not None and mode == "exact" and state_spec_of(state).compute is None:
        check_backend_options(name, kw)
        return fn(state, pkts, sample_idx, **kw)
    state, feats = compute_features(state, pkts, backend=backend, mode=mode, **kw)
    return state, feats[sample_idx]
