"""Feature-record sampling (port of ``repro.core.records``).

Peregrine computes features for every packet and then samples one record
per epoch of ``epoch`` packets for the ML detector (DESIGN.md §5).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def epoch_indices(n_packets: int, epoch: int, offset: int = 0) -> np.ndarray:
    """Indices of packets that close an epoch (every ``epoch``-th packet).

    ``offset`` carries the running packet count across batches so epochs are
    continuous over a streamed trace.
    """
    glob = np.arange(n_packets) + offset + 1
    return np.where(glob % epoch == 0)[0]


def epoch_gather(n_packets: int, epoch: int, offset_mod: int,
                 device=None) -> Tuple[torch.Tensor, int]:
    """Static-shape device twin of :func:`epoch_indices`: the one-lane case
    of :func:`epoch_gather_lanes`.  Returns ``(idx, count)``, ``idx`` a
    fixed-size ``(ceil(n/epoch),)`` int64 tensor of within-batch record
    positions, zero-padded past ``count`` (a host int)."""
    idx, counts = epoch_gather_lanes(n_packets, epoch, [offset_mod], device)
    return idx[0], counts[0]


def epoch_gather_lanes(n_packets: int, epoch: int, offset_mods: Sequence[int],
                       device=None) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Record positions of L lanes of ``n_packets`` each, lane l at running
    packet count residue ``offset_mods[l]`` (modulo ``epoch``), in one set
    of tensor ops.  Returns ``(idx, counts)``: ``idx`` (L, ceil(n/epoch))
    int64 within-lane record positions, zero-padded past ``counts[l]``
    (host ints).  The positions are arithmetic (lane l's first record
    closes at ``(epoch-1-offset_mods[l]) % epoch``, then one every
    ``epoch`` packets), so no ``nonzero`` and no device-to-host sync is
    involved: the lanes' first positions cross to the device without
    waiting for its stream."""
    max_rec = max(1, -(-n_packets // epoch))
    first = [(epoch - 1 - int(m)) % epoch for m in offset_mods]
    counts = tuple(0 if f >= n_packets else (n_packets - 1 - f) // epoch + 1
                   for f in first)
    idx = (torch.tensor(first, dtype=torch.int64).to(device, non_blocking=True)[:, None]
           + epoch * torch.arange(max_rec, dtype=torch.int64, device=device))
    return torch.where(idx < n_packets, idx, torch.zeros_like(idx)), counts
