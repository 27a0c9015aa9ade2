"""Exact-mode feature computation by segmented scans (port of
``repro.core.parallel``, the ``scan`` FC backend).

The switch updates flow state one packet at a time, but the decayed-atom
update ``A_i = delta_i * A_{i-1} + x_i`` is a linear first-order recurrence,
hence associative:

    (s2, a2) o (s1, a1) = (s1 * s2, a1 * s2 + a2)

so a packet batch is processed in O(log n) steps, segmented by flow: sort
by stream id (stable, which keeps time order inside each stream), then scan.
Cross-direction state (the opposite direction's stale statistics, the last
residual for SR) is a segmented latest-value scan.

Plain torch ops on either device, like the JAX module's XLA ops (it calls
no Pallas kernel, so there is no kernel to port):

  * The linear scan is a Hillis-Steele doubling scan with the JAX module's
    combine, over the stacked ``(n, N_DECAY, 3)`` atoms (w, LS, SS) in one
    pass.  It reassociates float32 products, so it matches the serial
    oracle to the JAX package's scan envelope, not bit for bit.
  * The latest-value scan is an index ``cummax`` reset at segment starts:
    no arithmetic, so it is exact.
  * Both key types of a group share one stable sort: the flat row layout
    of ``core/pipeline.py`` (row ``k * n_slots + slot``) makes the key type
    part of the stream id, so a batch pays two sorts (uni, bi).  The
    directional (slot, dir, time) order of the bi streams is derived from
    the channel sort by segmented ranks (``_dir_interleave_perm``), and the
    ``res_last`` store-back reuses it.

``process_parallel_sampled`` emits feature rows only at the sampled
packets (the fused serving step's records); the flow-state update always
covers every packet.  The state is updated in place.

Both scans also run in the JAX module's two-level form (``chunks=S``, the
``bucketed`` backend's, core/bucketed.py): S local scans over equal slices
of the sorted array, an exclusive combine over the S slice tails, and an
elementwise fix-up.  The linear scan reassociates once more (bit for bit
the flat scan at S=1); the latest-value scan stays exact.  ``shard=`` (a
``distributed.sharding.ShardContext``, built by core/bucketed.py from the
ambient mesh) places the two-level form over the mesh, as the JAX module's
``shard_map`` does: each place scans its slices, the slice tails are
gathered to every place in slice order (the one collective, O(S)), every
place runs the same tail combine and fixes up its own slices, and the
slices come home.  Everything before and after the scans (sorts, decays,
gathers, store-backs) runs unsplit on the caller's device, so the CPU's
``exp2``, which rounds by call width, sees the unplaced run's calls; the
scans are elementwise within a slice, so the placed run equals the
unplaced one bit for bit.

Requires ``pkts["ts"]`` sorted ascending (streams are time-ordered).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import arith
from repro_torch.core.pipeline import _stats, flat_tables, packet_rows
from repro_torch.core.state import LAMBDAS, N_DECAY, N_FEATURES, state_slots


# ---------------------------------------------------------------------------
# segmented-scan primitives
# ---------------------------------------------------------------------------
def _expand(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until ``a.ndim == ndim``."""
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def _cut(t: torch.Tensor, chunks: int, fill: float) -> torch.Tensor:
    """(n, ...) -> (chunks, ceil(n/chunks), ...): equal slices, the last
    padded at its tail with ``fill`` (inclusive scans carry nothing
    backwards, so the padding never reaches a real element)."""
    n = t.shape[0]
    pad = -n % chunks
    if pad:
        t = torch.cat([t, t.new_full((pad,) + t.shape[1:], fill)])
    return t.reshape((chunks, (n + pad) // chunks) + t.shape[1:])


def _odd_even(s: torch.Tensor, a: torch.Tensor, dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(s, a)`` along ``dim`` by the combine ``(sl * sr,
    al * sr + ar)``, in ``jax.lax.associative_scan``'s odd-even tree: pairs
    combined, the pairs scanned, then each even element combined with the
    odd prefix before it.  Returns new tensors: ``a`` inclusive and ``s``
    each element's whole prefix product."""
    n = a.shape[dim]
    if n < 2:
        return s, a
    lead = (slice(None),) * dim

    def every2(t, start, stop=None):
        return t[lead + (slice(start, stop, 2),)]

    s_r, a_r = every2(s, 1), every2(a, 1)
    ps, pa = _odd_even(every2(s, 0, n - 1) * s_r,
                       every2(a, 0, n - 1) * s_r + a_r, dim)
    k = (n - 1) // 2                    # even elements past the first
    s_e, a_e = every2(s, 2), every2(a, 2)
    out = []
    for t, odd, even in ((s, ps, ps.narrow(dim, 0, k) * s_e),
                         (a, pa, pa.narrow(dim, 0, k) * s_e + a_e)):
        o = torch.empty_like(t)
        o.narrow(dim, 0, 1).copy_(t.narrow(dim, 0, 1))
        every2(o, 1).copy_(odd)
        every2(o, 2).copy_(even)
        out.append(o)
    return out[0], out[1]


def seg_linear_scan(seg_start: torch.Tensor, delta: torch.Tensor,
                    x: torch.Tensor, chunks: int = 1, shard=None) -> torch.Tensor:
    """Segmented ``A_i = delta_i * A_{i-1} + x_i`` (A resets at segment
    starts), inclusive, as a Hillis-Steele doubling scan.

    ``seg_start``: (n,) bool; ``delta``, ``x``: (n, ...) with ``delta``
    broadcastable to ``x`` (it may be narrower in trailing dims).  Returns
    A with ``x``'s shape.  Each step combines every element with the one
    ``off`` before it by the JAX module's combine, ``(s, a) = (sl * sr,
    al * sr + ar)``.  Its segment flags are folded into the decays: a
    segment start's decay is 0, so a product that spans a start is 0 and
    nothing before the start reaches past it (the flagged combine's
    values, for finite inputs, without the flags).

    ``chunks=S`` runs the JAX module's two-level form: S local scans over
    equal slices (a ragged last slice padded with decay-0, zero-increment
    elements), an exclusive scan of the slice tails ``(prefix product,
    A)``, and the fix-up ``A = carry * prefix product + local A``, where a
    segment start's 0 in the prefix product kills the carry.  The local
    and tail scans take ``jax.lax.associative_scan``'s odd-even tree, the
    JAX module's association, so the two packages' chunked scans differ by
    XLA's rounding of ``exp2`` and of contracted multiply-adds only (SR
    sums cancel in float32, and in another order they drift further from
    JAX's).  ``chunks=1`` is the flat scan.  ``shard`` places the slices
    over a mesh (module docstring), with the same values.
    """
    n = x.shape[0]
    s = torch.where(_expand(seg_start, delta.ndim), 0.0, delta)
    if chunks <= 1:
        a = x.clone()
        off = 1
        while off < n:
            a[off:] += a[:-off] * s[off:]
            if 2 * off < n:
                s[off:] = s[:-off] * s[off:]
            off *= 2
        return a
    cs, cx = _cut(s, chunks, 0.0), _cut(x, chunks, 0.0)
    if shard is None:
        ls, la = _odd_even(cs, cx, 1)
        carry = _excl_carry(ls[:, -1], la[:, -1])
        a = carry[:, None] * ls + la
    else:
        n_local = chunks // shard.size
        local = shard.map(lambda s_, x_: _odd_even(s_, x_, 1),
                          shard.scatter(cs), shard.scatter(cx))
        ts = shard.gather_tails([ls[:, -1] for ls, _ in local])
        ta = shard.gather_tails([la[:, -1] for _, la in local])
        a = shard.join([
            shard.local_chunks(_excl_carry(ts[i], ta[i]), i, n_local)[:, None]
            * ls + la for i, (ls, la) in enumerate(local)], x.device)
    return a.reshape((-1,) + a.shape[2:])[:n]


def _excl_carry(ts: torch.Tensor, ta: torch.Tensor) -> torch.Tensor:
    """Each slice's carry in: the exclusive scan of the slice tails
    ``(prefix product, A)``, 0 into the first."""
    _, ta = _odd_even(ts, ta, 0)                         # inclusive over tails
    return torch.cat([torch.zeros_like(ta[:1]), ta[:-1]])


def _cummax(v: torch.Tensor, chunks: int = 1, shard=None) -> torch.Tensor:
    """Running max along dim 1 of a (K, n) index array, flat or in the
    two-level form (local maxima, an exclusive max over the slice tails,
    the max of the two; placed as :func:`seg_linear_scan`): the same
    values either way."""
    if chunks <= 1:
        return torch.cummax(v, 1).values
    n = v.shape[1]
    cut = _cut(v.T, chunks, -1)                                  # (S, L, K)

    def local(c):                                                # (K, S/D, L)
        return torch.cummax(c.permute(2, 0, 1), 2).values

    def carry_in(tails):                                         # (S, K)
        tails = torch.cummax(tails.T, 1).values                  # (K, S)
        return torch.cat([torch.full_like(tails[:, :1], -1), tails[:, :-1]], 1)

    if shard is None:
        loc = local(cut)
        out = torch.maximum(loc, carry_in(loc[..., -1].T)[..., None])
    else:
        n_local = chunks // shard.size
        locs = shard.map(local, shard.scatter(cut))
        tails = shard.gather_tails([loc[..., -1].T for loc in locs])
        out = shard.join([
            torch.maximum(loc, carry_in(tails[i])[:, i * n_local:(i + 1) * n_local,
                                                  None])
            for i, loc in enumerate(locs)], v.device, dim=1)
    return out.reshape(v.shape[0], -1)[:, :n]


def seg_last_scan(seg_start: torch.Tensor, valid: torch.Tensor,
                  value: torch.Tensor, chunks: int = 1, shard=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented latest valid value (inclusive), per column.

    ``valid``: (n, K) bool; ``value``: (n, K, ...).  Returns ``(found,
    last)``: ``found`` (n, K) is False where column k has no valid element
    yet in the row's segment, and ``last`` the value at the latest valid
    row (zeros where not found).  An index ``cummax`` reset at segment
    starts (along the contiguous dimension, where the card's scan is
    parallel), in ``chunks`` slices as :func:`seg_linear_scan`: values are
    gathered, never combined, so this is exact at any ``chunks`` and
    placement (``shard``).
    """
    n, k = valid.shape
    ar = torch.arange(n, device=valid.device)
    first = _seg_first(seg_start)
    last = _cummax(torch.where(valid.T, ar, -1), chunks, shard).T
    found = last >= first[:, None]
    val = value[last.clamp_min(0), torch.arange(k, device=valid.device)]
    return found, torch.where(_expand(found, val.ndim), val, 0.0)


def _segments(sorted_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment start and end markers of a sorted id array."""
    one = torch.ones(1, dtype=torch.bool, device=sorted_ids.device)
    diff = sorted_ids[1:] != sorted_ids[:-1]
    return torch.cat([one, diff]), torch.cat([diff, one])


def _seg_first(start: torch.Tensor) -> torch.Tensor:
    """Index of the first element of each element's segment."""
    ar = torch.arange(start.shape[0], device=start.device)
    return torch.cummax(torch.where(start, ar, -1), 0).values


def _seg_last(end: torch.Tensor) -> torch.Tensor:
    """Index of the last element of each element's segment."""
    n = end.shape[0]
    ar = torch.arange(n, device=end.device)
    return torch.flip(torch.cummin(torch.flip(torch.where(end, ar, n), (0,)),
                                   0).values, (0,))


def _dir_interleave_perm(start: torch.Tensor, end: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """Derive the (slot, dir, time) permutation from the (slot, time) sort.

    Given segment markers of the channel-sorted order and its direction
    bits ``d``, returns ``gather`` such that ``X[gather]`` is the stable
    sort by the composite key ``slot*2 + dir``: segmented ranks from
    cumulative sums, in O(n), instead of a second sort.
    """
    seg_first, seg_last = _seg_first(start), _seg_last(end)
    d0 = (d == 0).to(seg_first.dtype)
    pref0 = torch.cumsum(d0, 0)                 # inclusive dir-0 count
    excl0 = pref0 - d0
    base0 = excl0[seg_first]
    n0_seg = pref0[seg_last] - base0            # dir-0 population of the segment
    rank0 = excl0 - base0
    d1 = 1 - d0
    excl1 = torch.cumsum(d1, 0) - d1
    rank1 = excl1 - excl1[seg_first]
    pos = seg_first + torch.where(d == 0, rank0, n0_seg + rank1)
    return arith.invert_perm(pos)


def _decay(lam: torch.Tensor, start: torch.Tensor, t: torch.Tensor,
           lt_tab: torch.Tensor) -> torch.Tensor:
    """Per-element decay in stream order: ``dt`` to the previous element of
    the segment, or to the table's ``last_t`` at a segment start (no decay,
    0, for a stream never seen)."""
    t_prev = torch.cat([t[:1], t[:-1]])
    fresh = lt_tab < 0.0
    dt = torch.where(start[:, None],
                     torch.where(fresh, 0.0, t[:, None] - lt_tab),
                     (t - t_prev)[:, None]).clamp_min(0.0)
    return torch.where(start[:, None] & fresh, 0.0, torch.exp2(-lam * dt))


def _store(tab: Dict[str, torch.Tensor], writes) -> None:
    """Apply a store-back: every element writes its segment's last values
    to its row, so rows written more than once get the same values (no
    boolean mask, hence no device-to-host sync)."""
    rows, values = writes
    for name, v in values.items():
        tab[name][rows] = v


# ---------------------------------------------------------------------------
# one directional stream table pass
# ---------------------------------------------------------------------------
def stream_pass(tab: Dict[str, torch.Tensor], stream_ids: torch.Tensor,
                ts: torch.Tensor, lens: torch.Tensor, lam: torch.Tensor,
                order: Optional[torch.Tensor] = None,
                sample: Optional[torch.Tensor] = None, chunks: int = 1,
                shard=None):
    """Decayed-atom update of one table of streams.

    ``tab``: ``{"last_t", "w", "ls", "ss"}`` flat (rows, N_DECAY) tables;
    ``stream_ids``/``ts``/``lens``: (n,).  Returns ``(atoms, writes)``:
    the post-update atoms (n|m, N_DECAY, 3) (lanes w/ls/ss) in original
    order, at ``sample``'s rows if given, and the store-back (each
    stream's last row) for :func:`_store`, which the caller applies once
    every pass that reads the pre-batch table is done.  ``order`` is the
    stable sort by stream id, when already known; ``chunks`` cuts the scan
    and ``shard`` places it (:func:`seg_linear_scan`).
    """
    if order is None:
        order = torch.argsort(stream_ids, stable=True)
    inv = arith.invert_perm(order)
    sid = stream_ids[order]
    t = ts[order]
    x = lens[order]
    start, end = _segments(sid)
    delta = _decay(lam, start, t, tab["last_t"][sid])        # (n, ND)

    # stacked per-packet increments, the table carried into each segment's
    # first element: A_1 = delta_1 * A_tab + x_1
    n = sid.shape[0]
    xs = torch.stack([torch.ones(n, N_DECAY, device=x.device),
                      x[:, None].expand(n, N_DECAY),
                      (x * x)[:, None].expand(n, N_DECAY)], -1)   # (n, ND, 3)
    tab_a = torch.stack([tab["w"][sid], tab["ls"][sid], tab["ss"][sid]], -1)
    x0 = torch.where(start[:, None, None], xs + delta[..., None] * tab_a, xs)
    atoms = seg_linear_scan(start, delta[..., None], x0, chunks, shard)
    last = _seg_last(end)
    at_end = atoms[last]
    writes = (sid, {"last_t": t[last][:, None].expand(-1, N_DECAY),
                    "w": at_end[..., 0], "ls": at_end[..., 1],
                    "ss": at_end[..., 2]})
    rows = inv if sample is None else inv[sample]
    return atoms[rows], writes


# ---------------------------------------------------------------------------
# channel pass: stale opposite stats + SR recurrence
# ---------------------------------------------------------------------------
def _bi_features(own: torch.Tensor, opp: torch.Tensor,
                 sr: torch.Tensor) -> torch.Tensor:
    """The 7 bi statistics from own and opposite atoms (m, ND, 3) and the
    SR sums (m, ND); (m, ND, 7)."""
    mu, var, sig = _stats(torch.stack([own[..., 0], opp[..., 0]]),
                          torch.stack([own[..., 1], opp[..., 1]]),
                          torch.stack([own[..., 2], opp[..., 2]]))
    sq = arith.square(torch.stack([mu, var]))
    mag, rad = arith.sqrt(sq[:, 0] + sq[:, 1])
    cov = arith.div(sr, own[..., 0] + opp[..., 0])
    pcc = arith.div(cov, sig[0] * sig[1])
    return torch.stack([own[..., 0], mu[0], sig[0], mag, rad, cov, pcc], -1)


def channel_pass(tab: Dict[str, torch.Tensor], slots: torch.Tensor,
                 dirs: torch.Tensor, ts: torch.Tensor, lens: torch.Tensor,
                 own_atoms: torch.Tensor, lam: torch.Tensor,
                 order: torch.Tensor, dir_gather: torch.Tensor,
                 sample: Optional[torch.Tensor] = None, chunks: int = 1,
                 shard=None):
    """Cross-direction state of the bi streams.

    ``tab``: the flat bi tables, still holding their pre-batch values
    (``bw``/``bls``/``bss``/``brl`` rows ``2*slot + dir``, ``bsr``/``bslt``
    rows ``slot``); ``slots`` the channel rows, ``own_atoms`` the
    post-update atoms of each packet's own direction (original order, full
    width).  ``order`` is the stable sort by slot and ``dir_gather`` its
    directional permutation.  Returns ``(features (n|m, ND, 7), writes)``;
    ``sample`` restricts the emitted rows (the scans and store-backs always
    cover every packet, and a row's statistics are the same either way);
    ``chunks`` cuts both scans and ``shard`` places them.
    """
    inv = arith.invert_perm(order)
    sid = slots[order]
    d = dirs[order]
    t = ts[order]
    start, end = _segments(sid)
    own = own_atoms[order]                                   # (n, ND, 3)

    # residual against the own direction's mean (SR consumes every row)
    r = lens[order][:, None] - arith.div(own[..., 1], own[..., 0])

    # latest same-channel packet of each direction: atoms and residual;
    # the table fallback is applied where it is read
    n = sid.shape[0]
    lanes = torch.cat([own, r[..., None]], -1)               # (n, ND, 4)
    found, latest = seg_last_scan(start, torch.stack([d == 0, d == 1], 1),
                                  lanes[:, None].expand(n, 2, N_DECAY, 4),
                                  chunks, shard)
    res = [torch.where(found[:, X, None], latest[:, X, :, 3],
                       tab["brl"][2 * sid + X]) for X in (0, 1)]
    r_opp = torch.where((d == 0)[:, None], res[1], res[0])

    # SR recurrence over the whole channel (both directions)
    dsr = _decay(lam, start, t, tab["bslt"][sid])
    x_sr = r * r_opp
    x_sr = torch.where(start[:, None], x_sr + dsr * tab["bsr"][sid], x_sr)
    sr = seg_linear_scan(start, dsr, x_sr, chunks, shard)

    # statistics, emitted at the requested rows only
    rows = inv if sample is None else inv[sample]
    s, dr = sid[rows], d[rows]
    stale = [torch.where(found[rows, X, None, None], latest[rows, X, :, :3],
                         torch.stack([tab[k][2 * s + X]
                                      for k in ("bw", "bls", "bss")], -1))
             for X in (0, 1)]
    opp = torch.where((dr == 0)[:, None, None], stale[1], stale[0])
    feats = _bi_features(own[rows], opp, sr[rows])

    # store-back: SR at each channel's last row; the residual at each
    # (channel, direction)'s last row, the segment ends of the directional
    # order (the derived permutation, no re-sort)
    k2s = (2 * sid + d)[dir_gather]
    last, last2 = _seg_last(end), _seg_last(_segments(k2s)[1])
    writes = [(sid, {"bsr": sr[last],
                     "bslt": t[last][:, None].expand(-1, N_DECAY)}),
              (k2s, {"brl": r[dir_gather][last2]})]
    return feats, writes


# ---------------------------------------------------------------------------
# the whole batch
# ---------------------------------------------------------------------------
def _process(state: Dict, pkts: Dict[str, torch.Tensor],
             sample_idx: Optional[torch.Tensor] = None, chunks: int = 1,
             shard=None) -> Tuple[Dict, torch.Tensor]:
    """One batch, every row or ``sample_idx``'s; ``chunks=S`` cuts each key
    type's sorted run into S buckets (the ``bucketed`` backend) and
    ``shard`` places the buckets' scans over a mesh.

    Both key types of a group lie end to end in one sorted array of 2n
    positions (rows of key type 0 sort first), so S buckets a key type are
    2S equal cuts of that array, the JAX module's cuts when S divides n.
    A ragged batch is padded to a multiple of S at the sorted array's tail,
    after every real row of both key types, rather than with sentinel
    packets: the padding needs no table row (torch raises on an
    out-of-range index, where JAX drops the store), is never stored and is
    never emitted.  Key type 0's cuts are then JAX's; key type 1's fall
    ``-n % S`` positions later in its run, another legal reassociation.
    Placed, a place holds 2S/D of the cuts, and the padding lies in the
    last place's tail.
    """
    ts = pkts["ts"].to(torch.float32)
    lens = pkts["length"].to(torch.float32)
    n = ts.shape[0]
    m = n if sample_idx is None else sample_idx.shape[0]
    if n == 0 or m == 0:
        if n:
            _process(state, pkts, chunks=chunks, shard=shard)   # every packet
        return state, torch.empty((m, N_FEATURES), dtype=torch.float32,
                                  device=ts.device)
    n_slots = state_slots(state)
    rows = packet_rows(pkts, n_slots)
    tab = flat_tables(state)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    # both key types of a group in one array: position k*n + i is packet i
    # under key type k, so its stream id (row) also names the key type
    ts2, lens2 = ts.repeat(2), lens.repeat(2)
    dirs2 = rows["dir"].repeat(2)
    sample2 = (None if sample_idx is None else
               torch.cat([sample_idx, sample_idx + n]))
    cuts = 2 * chunks if chunks > 1 else 1

    # ---- unidirectional: one sort for both key types ----
    uni_tab = {"last_t": tab["ult"], "w": tab["uw"], "ls": tab["uls"],
               "ss": tab["uss"]}
    atoms, writes = stream_pass(uni_tab, rows["urow"].T.reshape(-1), ts2, lens2,
                                lam, sample=sample2, chunks=cuts, shard=shard)
    _store(uni_tab, writes)
    mu, _, sig = _stats(atoms[..., 0], atoms[..., 1], atoms[..., 2])
    uni_feats = torch.stack([atoms[..., 0], mu, sig], -1)       # (2m, ND, 3)

    # ---- bidirectional: one sort (by channel row) for both key types ----
    slots = rows["bbase"].T.reshape(-1)
    order = torch.argsort(slots, stable=True)
    start, end = _segments(slots[order])
    dir_gather = _dir_interleave_perm(start, end, dirs2[order])
    dir_tab = {"last_t": tab["blt"], "w": tab["bw"], "ls": tab["bls"],
               "ss": tab["bss"]}
    own, dir_writes = stream_pass(dir_tab, 2 * slots + dirs2, ts2, lens2, lam,
                                  order=order[dir_gather], chunks=cuts,
                                  shard=shard)
    # the channel pass reads the pre-batch direction tables: store after it
    bi_feats, ch_writes = channel_pass(tab, slots, dirs2, ts2, lens2, own, lam,
                                       order, dir_gather, sample=sample2,
                                       chunks=cuts, shard=shard)
    _store(dir_tab, dir_writes)
    for w in ch_writes:
        _store(tab, w)

    feats = torch.cat([uni_feats.reshape(2, m, -1).transpose(0, 1).reshape(m, -1),
                       bi_feats.reshape(2, m, -1).transpose(0, 1).reshape(m, -1)],
                      -1)
    return state, feats


def process_parallel(state: Dict, pkts: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict, torch.Tensor]:
    """Exact-mode FC by segmented scans: the same I/O as
    ``process_serial(..., mode="exact")``; ``state`` updated in place."""
    return _process(state, pkts)


def process_parallel_sampled(state: Dict, pkts: Dict[str, torch.Tensor],
                             sample_idx: torch.Tensor
                             ) -> Tuple[Dict, torch.Tensor]:
    """Exact-mode FC emitting only ``sample_idx``'s feature rows.

    The state update covers every packet, as :func:`process_parallel`'s
    does, and the rows equal ``process_parallel(...)[1][sample_idx]``: the
    scans are the same and a row's statistics take the same operations.
    """
    return _process(state, pkts, sample_idx)
