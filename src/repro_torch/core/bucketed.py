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

Placement is not ported: on one device the bucket axis is a batch
dimension of plain torch ops, as in the JAX package without a mesh.  The
JAX package's ``shard_map`` of the buckets over the ``flow_shards`` mesh
axis waits for a host with more than one card (ROADMAP queue 1 item 10c).

``process_bucketed_sampled`` is the record-sampled twin for the fused
serving step, registered in ``core/backends`` so a ``backend="bucketed"``
service takes the record-sampled path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.parallel import _process


def _check_buckets(buckets: int) -> None:
    if buckets < 1:
        raise ValueError(f"buckets must be >= 1, got {buckets}")


def process_bucketed(state: Dict, pkts: Dict[str, torch.Tensor],
                     buckets: int = 4, mode: str = "exact"
                     ) -> Tuple[Dict, torch.Tensor]:
    """Bucketed FC: the same I/O as ``process_parallel``, each key type's
    flow-sorted batch cut into ``buckets`` balanced buckets scanned apart;
    ``state`` updated in place.  Exact arithmetic only: for switch mode use
    the ``serial`` or ``sharded`` backend (the packet-serial paths)."""
    _check_buckets(buckets)
    if mode != "exact":
        raise ValueError("bucketed backend is exact-mode only")
    return _process(state, pkts, chunks=buckets)


def process_bucketed_sampled(state: Dict, pkts: Dict[str, torch.Tensor],
                             sample_idx: torch.Tensor, buckets: int = 4
                             ) -> Tuple[Dict, torch.Tensor]:
    """Record-sampled bucketed FC for the fused serving step: the state
    update covers every packet, feature rows are computed only at
    ``sample_idx`` (equal to ``process_bucketed(...)[1][sample_idx]``)."""
    _check_buckets(buckets)
    return _process(state, pkts, sample_idx, chunks=buckets)
