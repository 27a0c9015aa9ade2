"""Sharded flow-table FC: the switch's partitioned register array (port of
``repro.core.sharded``, the ``sharded`` FC backend).

Peregrine's data plane scales because flow state is a partitioned register
array: each pipeline stage owns a disjoint slice of the slot space and a
packet is routed to the partition that owns its slot.  Here the flow tables
are hash-partitioned into S shards (shard = slot mod S, local row = slot
div S, plus one scratch row per shard), and every packet steps all S shards
at once: the owning shard updates the packet's row, every other shard its
scratch row, which is dropped when the tables are unsharded.  Each key
type's features come from its owning shard.

Exactness: slots never interact, so a partition that keeps each slot's
packet order is bit for bit the serial oracle, in both arithmetic modes
(the round-robin ``rr`` counters are per-slot state and shard like every
other table).  The step is the serial oracle's (``core/pipeline.py``), on
rows of the sharded tables.  One care keeps the bits on the CPU: PyTorch's
``exp2`` rounds differently in its vectorised body and its scalar tail, so
the same values can differ by width of the call.  Exact mode therefore
evaluates each decay at the owning rows only, a call of the serial step's
width, and gives the scratch rows a decay of 0 with no transcendental.
Switch mode evaluates none.

The shards run as one batch dimension of torch ops on one device.  The JAX
package's placement of the shard axis over a device mesh (the
``flow_shards`` rule) is not ported (ROADMAP queue 1 item 10c).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import arith
from repro_torch.core.pipeline import bi_step, flat_tables, uni_step
from repro_torch.core.state import (BI_KEYS, LAMBDAS, N_BI, N_DECAY, N_UNI,
                                    UNI_KEYS, packet_slots, state_slots)

# table leaves that mean "never seen" at -1 (scratch rows start fresh)
_FRESH_AT_MINUS1 = ("last_t", "sr_last_t")


def shard_tables(state: Dict, shards: int) -> Dict:
    """Global tables -> per-shard slices plus one scratch row per shard.

    Leaf (K, n_slots, ...) -> (S, K, n_slots//S + 1, ...): global slot g
    lives in shard ``g % S`` at local row ``g // S``; local row n_slots//S
    is the scratch row.
    """
    def leaf(x, fill):
        k, ns = x.shape[:2]
        y = x.reshape(k, ns // shards, shards, *x.shape[2:]).movedim(2, 0)
        pad = x.new_full((shards, k, 1) + x.shape[2:], fill)
        return torch.cat([y, pad], 2)

    return {grp: {f: leaf(v, -1 if f in _FRESH_AT_MINUS1 else 0)
                  for f, v in state[grp].items()}
            for grp in ("uni", "bi")}


def unshard_tables(sharded: Dict, shards: int) -> Dict:
    """Inverse of :func:`shard_tables` (scratch rows dropped)."""
    def leaf(y):
        y = y[:, :, :-1]
        return y.movedim(0, 2).reshape(y.shape[1], -1, *y.shape[3:])

    return {grp: {f: leaf(v) for f, v in sharded[grp].items()}
            for grp in ("uni", "bi")}


def _owner_exp2(own: torch.Tensor):
    """``exp2`` evaluated at rows ``own`` only (a call of the serial step's
    width), 0 at every other row."""
    def exp2(y):
        out = torch.zeros_like(y)
        out[own] = torch.exp2(y[own])
        return out
    return exp2


def _routes(slots: torch.Tensor, shards: int, n_local: int):
    """Per-packet rows of the flat sharded tables for one key group.

    ``slots``: (n, K).  Returns ``rows`` (n, S*K), shard-major, each the
    owning shard's local row or the scratch row, and ``own`` (n, K), the
    positions among those S*K rows that belong to the owning shards.
    """
    n, k = slots.shape
    dev = slots.device
    sid = torch.arange(shards, device=dev)
    kt = torch.arange(k, device=dev)
    base = (sid[:, None] * k + kt) * (n_local + 1)               # (S, K)
    owner = slots % shards
    local = torch.where(owner[:, None] == sid[None, :, None],
                        (slots // shards)[:, None], n_local)     # (n, S, K)
    return (base + local).reshape(n, -1), owner * k + kt


def process_sharded(state: Dict, pkts: Dict[str, torch.Tensor],
                    shards: int = 4, mode: str = "exact"
                    ) -> Tuple[Dict, torch.Tensor]:
    """Hash-partitioned FC: the same I/O as ``process_serial``, bit for bit
    its features and state in either ``mode``; ``state`` updated in place.

    Raises ``ValueError`` unless ``shards`` divides the slot count (the
    tables partition the slot space evenly).
    """
    arith.check_mode(mode)
    n_slots = state_slots(state)
    if shards < 1 or n_slots % shards:
        raise ValueError(
            f"n_slots={n_slots} not divisible by shards={shards}; "
            "flow tables partition the slot space evenly")
    n_local = n_slots // shards
    sharded = shard_tables(state, shards)
    tab = flat_tables(sharded)
    rr_u = rr_b = None
    if mode == "switch":
        rr_u, rr_b = sharded["uni"]["rr"].view(-1), sharded["bi"]["rr"].view(-1)
    sl = packet_slots(pkts, n_slots)
    urow, own_u = _routes(torch.stack([sl[k] for k in UNI_KEYS], -1),
                          shards, n_local)
    brow_s, own_b = _routes(torch.stack([sl[k] for k in BI_KEYS], -1),
                            shards, n_local)
    d = sl["dir"][:, None]
    brow_o = brow_s * 2 + d
    brow_p = brow_s * 2 + (1 - d)
    ts = pkts["ts"].to(torch.float32)
    lens = pkts["length"].to(torch.float32)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    n = ts.shape[0]
    f_uni = torch.empty((n, shards * N_UNI, N_DECAY * 3), dtype=torch.float32,
                        device=ts.device)
    f_bi = torch.empty((n, shards * N_BI, N_DECAY * 7), dtype=torch.float32,
                       device=ts.device)
    for i in range(n):
        t, x = ts[i], lens[i]
        f_uni[i] = uni_step(tab, lam, urow[i], t, x, mode, rr_u,
                            _owner_exp2(own_u[i])).view(-1, N_DECAY * 3)
        f_bi[i] = bi_step(tab, lam, brow_o[i], brow_p[i], brow_s[i], t, x,
                          mode, rr_b, _owner_exp2(own_b[i])).view(-1, N_DECAY * 7)
    # each key type's block from its owning shard
    rows = torch.arange(n, device=ts.device)[:, None]
    feats = torch.cat([f_uni[rows, own_u].reshape(n, -1),
                       f_bi[rows, own_b].reshape(n, -1)], -1)
    for grp, tabs in unshard_tables(sharded, shards).items():
        for f, v in tabs.items():
            state[grp][f].copy_(v)
    return state, feats
