"""Feature-record sampling (port of ``repro.core.records``).

Peregrine computes features for every packet and then samples one record
per epoch of ``epoch`` packets for the ML detector (DESIGN.md §5).
"""
from __future__ import annotations

from typing import Tuple

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
    """Static-shape device twin of :func:`epoch_indices`.

    ``offset_mod`` is the running packet count modulo ``epoch``.  Returns
    ``(idx, count)``: ``idx`` is a fixed-size ``(ceil(n/epoch),)`` int64
    tensor of within-batch record positions, zero-padded past ``count``.
    The positions are arithmetic (the first record closes at
    ``(epoch-1-offset_mod) % epoch``, then one every ``epoch`` packets), so
    no ``nonzero`` and no device-to-host sync is involved.
    """
    max_rec = max(1, -(-n_packets // epoch))
    first = (epoch - 1 - offset_mod) % epoch
    count = 0 if first >= n_packets else (n_packets - 1 - first) // epoch + 1
    idx = first + epoch * torch.arange(max_rec, dtype=torch.int64,
                                       device=device)
    idx = torch.where(idx < n_packets, idx, torch.zeros_like(idx))
    return idx, count
