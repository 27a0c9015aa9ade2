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
evaluates each packet's decays in one call of the serial step's width and
layout, a (key type, decay) array holding the owning rows' arguments (0
where a key type's owner is on another place), and gives the scratch rows
a decay of 0.  Switch mode evaluates none.

Placement: unplaced, the shards run as one batch dimension of torch ops on
one device.  Under a bound mesh whose ``flow_shards`` rule places S shards
(``core/bucketed._resolve_placement``: S a multiple of the places D), place
i holds shards ``[i*S/D, (i+1)*S/D)`` on its device and steps them for
every packet; each key type's features come back from the place that owns
its slot, and the tables come home when the batch is done.  The unplaced
run is the one-place case, so the two are the same operations.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.core import arith
from repro_torch.core.pipeline import bi_step, flat_tables, uni_step
from repro_torch.core.bucketed import _placement
from repro_torch.core.state import (BI_KEYS, LAMBDAS, N_BI, N_DECAY, N_UNI,
                                    UNI_KEYS, packet_slots, state_device,
                                    state_slots)

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


def _owner_exp2(pos: torch.Tensor, owned: torch.Tensor):
    """``exp2`` of one packet's K (key type, decay) rows, called at the
    serial step's width: ``pos`` (K,) the rows among the place's S_p*K
    step rows (distinct, ``pos[kt] % K == kt``), ``owned`` (K,) whether the
    key type's owner is on this place.  Every other row gets 0."""
    def exp2(y):
        e = torch.exp2(torch.where(owned[:, None], y[pos], 0.0))
        out = torch.zeros_like(y)
        out[pos] = torch.where(owned[:, None], e, 0.0)
        return out
    return exp2


def _routes(slots: torch.Tensor, shards: int, n_local: int, first: int,
            count: int):
    """Per-packet rows of one place's flat sharded tables for one key group.

    ``slots``: (n, K); the place holds shards ``[first, first + count)``.
    Returns ``rows`` (n, count*K), shard-major, each the owning shard's
    local row or the scratch row; ``pos`` (n, K), each key type's position
    among those rows (its owner's, or a scratch row's off the place); and
    ``owned`` (n, K).
    """
    n, k = slots.shape
    dev = slots.device
    sid = torch.arange(count, device=dev)
    kt = torch.arange(k, device=dev)
    base = (sid[:, None] * k + kt) * (n_local + 1)               # (S_p, K)
    owner = slots % shards - first
    owned = (owner >= 0) & (owner < count)
    local = torch.where(owner[:, None] == sid[None, :, None],
                        (slots // shards)[:, None], n_local)     # (n, S_p, K)
    pos = torch.where(owned, owner, 0) * k + kt
    return (base + local).reshape(n, -1), pos, owned


def place_shards(sharded: Dict, ctx) -> List[Dict]:
    """Each place's shards of :func:`shard_tables`' tables, on its device:
    place i holds shards ``[i*S/D, (i+1)*S/D)`` (``ctx`` a
    ``ShardContext`` of D places; ``None`` is one place holding all)."""
    if ctx is None:
        return [sharded]
    per = next(iter(sharded["uni"].values())).shape[0] // ctx.size
    return [{g: {f: ctx.to_place(v[p * per:(p + 1) * per], p)
                 for f, v in tabs.items()} for g, tabs in sharded.items()}
            for p in range(ctx.size)]


def process_sharded(state: Dict, pkts: Dict[str, torch.Tensor],
                    shards: int = 4, mode: str = "exact"
                    ) -> Tuple[Dict, torch.Tensor]:
    """Hash-partitioned FC: the same I/O as ``process_serial``, bit for bit
    its features and state in either ``mode``; ``state`` updated in place.
    Under a bound mesh the shards are placed over it (module docstring).

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
    home = state_device(state)
    ctx = _placement(shards)
    n_places = 1 if ctx is None else ctx.size
    per = shards // n_places

    def to_place(t, p):
        return t if ctx is None else ctx.to_place(t, p)

    sharded = shard_tables(state, shards)
    sl = packet_slots(pkts, n_slots)
    uslots = torch.stack([sl[k] for k in UNI_KEYS], -1)
    bslots = torch.stack([sl[k] for k in BI_KEYS], -1)
    ts = pkts["ts"].to(torch.float32)
    lens = pkts["length"].to(torch.float32)
    n = ts.shape[0]
    places = []
    for p, part in enumerate(place_shards(sharded, ctx)):
        urow, upos, uown = (to_place(t, p) for t in
                            _routes(uslots, shards, n_local, p * per, per))
        brow_s, bpos, bown = (to_place(t, p) for t in
                              _routes(bslots, shards, n_local, p * per, per))
        d = to_place(sl["dir"], p)[:, None]
        dev = urow.device
        places.append({
            "part": part, "tab": flat_tables(part),
            "rr": ((part["uni"]["rr"].view(-1), part["bi"]["rr"].view(-1))
                   if mode == "switch" else (None, None)),
            "urow": urow, "upos": upos, "uown": uown,
            "brow_o": brow_s * 2 + d, "brow_p": brow_s * 2 + (1 - d),
            "brow_s": brow_s, "bpos": bpos, "bown": bown,
            "ts": to_place(ts, p), "lens": to_place(lens, p),
            "lam": torch.tensor(LAMBDAS, dtype=torch.float32, device=dev),
            "f_uni": torch.empty((n, per * N_UNI, N_DECAY * 3),
                                 dtype=torch.float32, device=dev),
            "f_bi": torch.empty((n, per * N_BI, N_DECAY * 7),
                                dtype=torch.float32, device=dev)})
    for i in range(n):
        for q in places:
            t, x = q["ts"][i], q["lens"][i]
            q["f_uni"][i] = uni_step(
                q["tab"], q["lam"], q["urow"][i], t, x, mode, q["rr"][0],
                _owner_exp2(q["upos"][i], q["uown"][i])).view(-1, N_DECAY * 3)
            q["f_bi"][i] = bi_step(
                q["tab"], q["lam"], q["brow_o"][i], q["brow_p"][i],
                q["brow_s"][i], t, x, mode, q["rr"][1],
                _owner_exp2(q["bpos"][i], q["bown"][i])).view(-1, N_DECAY * 7)
    # each key type's block from its owning place
    owner = torch.cat([((uslots % shards) // per).repeat_interleave(N_DECAY * 3, 1),
                       ((bslots % shards) // per).repeat_interleave(N_DECAY * 7, 1)],
                      -1)
    feats = None
    for p, q in enumerate(places):
        rows = torch.arange(n, device=q["ts"].device)[:, None]
        f = torch.cat([q["f_uni"][rows, q["upos"]].reshape(n, -1),
                       q["f_bi"][rows, q["bpos"]].reshape(n, -1)], -1)
        if ctx is not None:
            f = ctx.to_home(f, p, home)
        feats = f if feats is None else torch.where(owner == p, f, feats)
    parts = [q["part"] for q in places]
    tables = {g: {f: (parts[0][g][f] if ctx is None else
                      ctx.join([part[g][f] for part in parts], home))
                  for f in sharded[g]} for g in sharded}
    for grp, tabs in unshard_tables(tables, shards).items():
        for f, v in tabs.items():
            state[grp][f].copy_(v)
    return state, feats
