"""Bucketed FC: the scan backend cut into balanced buckets (port of
``repro.core.bucketed``, the ``bucketed`` FC backend).

``core/sharded.py`` partitions the flow tables and replays the serial step
in every shard; this module partitions the packets instead, on top of the
segmented scans of ``core/parallel.py``:

1. **Compaction.**  The batch is stably sorted by flow row, the sort the
   scan backend already pays (two a batch, no more).  Slots are hashes, so
   every stream is a contiguous run.
2. **Bucketing.**  Each key type's sorted run is cut into S equal buckets.
   The buckets are balanced by construction: a heavy-hitter flow cannot
   skew them; at most S-1 streams straddle a cut.
3. **Per-bucket scans.**  Each bucket runs the segmented atom and
   latest-value scans alone (depth O(log n/S)); an exclusive combine over
   the S bucket tails carries the straddling streams, and an elementwise
   fix-up applies it.  The same associative combine, reassociated: bit for
   bit the flat ``scan`` backend at S=1, the JAX package's scan envelope
   against the serial oracle otherwise.
4. **Scatter-back.**  Results return to packet order through the scan
   backend's inverse permutation.

How the port lays the buckets out (both key types of a group in one sorted
array, a ragged batch padded at its tail) is in ``core/parallel._process``.

Placement: unplaced, the bucket axis is a batch dimension of plain torch
ops on one device.  When a mesh is bound and the ``flow_shards`` logical
axis has a rule (``distributed.sharding.flow_mesh``), the buckets' scans
run over that axis (``ShardContext``, ``core/parallel``'s ``shard=``): each
place scans its buckets, the O(S) bucket tails are gathered to every place,
each place runs the tail combine and fixes up its own buckets.  The
placement is resolved at every call (the port has no compile cache), and
the placed run equals the unplaced one bit for bit.

``process_bucketed_sampled`` is the record-sampled twin for the fused
serving step, registered in ``core/backends`` so a ``backend="bucketed"``
service takes the record-sampled path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.parallel import _process
from repro_torch.distributed.sharding import (ShardContext, flow_shards_binding,
                                              resolve_placement, shard_context)


def _check_buckets(buckets: int) -> None:
    if buckets < 1:
        raise ValueError(f"buckets must be >= 1, got {buckets}")


def _resolve_placement(buckets: int):
    """(mesh, binding) placing ``buckets`` buckets over the ambient mesh, or
    (None, None): unplaced when no mesh is bound, the ``flow_shards`` rule
    is unbound, the mesh lacks the bound axes, or ``buckets`` is not a
    multiple of the places (the JAX package's rules)."""
    return resolve_placement(flow_shards_binding(), buckets)


# the ShardContext placing the two-level scans on a mesh, one per (mesh,
# binding), or None when unplaced
_shard_ctx = shard_context


def _placement(buckets: int) -> Optional[ShardContext]:
    return _shard_ctx(*_resolve_placement(buckets))


def process_bucketed(state: Dict, pkts: Dict[str, torch.Tensor],
                     buckets: int = 4, mode: str = "exact"
                     ) -> Tuple[Dict, torch.Tensor]:
    """Bucketed FC: the same I/O as ``process_parallel``, each key type's
    flow-sorted batch cut into ``buckets`` balanced buckets scanned apart;
    ``state`` updated in place.  Exact arithmetic only: for switch mode use
    the ``serial`` or ``sharded`` backend (the packet-serial paths).  Under
    a bound mesh the buckets' scans are placed over it."""
    _check_buckets(buckets)
    if mode != "exact":
        raise ValueError("bucketed backend is exact-mode only")
    return _process(state, pkts, chunks=buckets, shard=_placement(buckets))


def process_bucketed_sampled(state: Dict, pkts: Dict[str, torch.Tensor],
                             sample_idx: torch.Tensor, buckets: int = 4
                             ) -> Tuple[Dict, torch.Tensor]:
    """Record-sampled bucketed FC for the fused serving step: the state
    update covers every packet, feature rows are computed only at
    ``sample_idx`` (equal to ``process_bucketed(...)[1][sample_idx]``),
    placed as :func:`process_bucketed`."""
    _check_buckets(buckets)
    return _process(state, pkts, sample_idx, chunks=buckets,
                    shard=_placement(buckets))
