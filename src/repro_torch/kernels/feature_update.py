"""Exact FC kernels and their wrappers: the 80-feature ``csrc/fc_full.cu``
(``feature_update_full``) and the single-key-type ``csrc/feature_update.cu``
(``feature_update``), with plain twins of their phases.

``feature_update_full`` replaces the JAX package's Pallas TPU kernel
``repro/kernels/feature_update.py::feature_update_full`` (``_fc_full_kernel``).

On the TPU one sequential grid walks every packet with the flow tables in
VMEM.  On the H100 serial order only matters within a (key type, slot)
segment, so the wrapper stable-sorts the (key type, packet) pairs by table
row (:func:`fc_segments`); bi key types segment on the channel/socket slot
with both directions together, because the SR and last-residual state
crosses directions.  Inside a segment only the recurrences are serial: the
affine atom updates per (direction, decay) and, for bi key types, the SR.
One launch runs a parallel prelude (each position's previous packet of its
own and of the opposite direction in its segment, and its decay factors),
one thread per (segment, decay) for the atom chains, a parallel residual
pass, one thread per (bi segment, decay) for the SR chain, and a parallel
features pass; :func:`fc_phases_ref` is the same decomposition in PyTorch.

What bounds it on the card: bytes, about 1.1 KB per packet (touched rows
read and written once, 320 B of features); in practice the longest
segment's chain of dependent multiply-adds and the launches.

The tenant axis (:func:`feature_update_full_tenants`): the multi-tenant
engine keeps T tenants' tables stacked on a leading axis and advances L of
them in one launch.  The combined key becomes ``(t*4 + kt)*n_slots + slot``
with t the packet's pool tenant, so one stable sort over every lane's keys
gives each lane the segments of a solo launch, and the kernels address the
pool's rows in place (``fc_full.cu``'s ``key_row``, :func:`fc_key_rows`).
``feature_update_full`` is its one-tenant case, with today's keys.  A pool
placed over a mesh (``core.state.PlacedPool``) takes one launch a place,
over that place's lanes, on that place's stacked tables: the int32 key
limit applies to each place's tenants.

``feature_update`` replaces ``repro/kernels/feature_update.py::
feature_update`` (``_fc_kernel``), the JAX package's public single-key entry
point ``kernels/ops.feature_update``: one key type's atom update over an
``(n_slots, N_DECAY)`` table.  It is the uni half of ``fc_full.cu`` (the
prelude, the chain and the statistics, sharing ``csrc/common.cuh``);
:func:`feature_update_phases_ref` is its twin.  Bound: bytes, about 128 B of
touched rows and 64 B of stats, packet data, index and key a packet; in
practice the longest run's chain.

For a CPU tensor each wrapper runs its plain PyTorch version
(``core.pipeline.process_serial``, :func:`feature_update_ref`); for a CUDA
tensor it launches its kernels or raises.  The twins are held bit for bit
against the plain versions in the tests.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import arith
from repro_torch.core.pipeline import (_stats, flat_tables, packet_rows,
                                       process_serial)
from repro_torch.core.state import (LAMBDAS, N_DECAY, N_FEATURES, N_UNI,
                                    PlacedPool, state_device, state_slots,
                                    tenant_view)
from repro_torch.kernels.build import INT, VOIDP, CudaKernel

FC_FULL = CudaKernel("fc_full.cu", "fc_full_launch",
                     argtypes=[VOIDP] * 18 + [INT, INT, VOIDP],
                     flags=("--fmad=false",))
FEATURE_UPDATE = CudaKernel("feature_update.cu", "feature_update_launch",
                            argtypes=[VOIDP] * 10 + [INT, VOIDP],
                            flags=("--fmad=false",))

# as in csrc/fc_full.cu and csrc/common.cuh
SCAN_TILE = 1024      # sorted positions a scan block of fc_full.cu takes
CHAIN_PAD = 64        # positions past the last that a chain may load
# the flat tables in the order fc_full_launch takes them
_TABLE_ORDER = ("ult", "uw", "uls", "uss", "blt", "bw", "bls", "bss", "brl",
               "bsr", "bslt")


def check_tables(tab: Dict[str, torch.Tensor], device) -> None:
    for name, t in tab.items():
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"state table {name!r} must be a contiguous "
                             f"float32 tensor on {device}, got {t.dtype} "
                             f"on {t.device}")


def fc_segments(rows: Dict[str, torch.Tensor], n_slots: int,
                lane_keys: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted combined keys ``kt*n_slots + slot`` (int32, length 4n) and the
    stable sort permutation into the kt-major (4, n) key matrix (int64).
    Stability keeps each segment in array order, the oracle's order.

    ``lane_keys``: for packets of L equal lanes (lane-major), each lane's key
    offset ``t*4*n_slots``, t its tenant in a stacked pool; the keys become
    ``(t*4 + kt)*n_slots + slot``, so lanes share no segment."""
    keys = torch.cat([rows["urow"].T, rows["bbase"].T + N_UNI * n_slots])
    if lane_keys is not None:
        keys = (keys.view(4, lane_keys.numel(), -1)
                + lane_keys[None, :, None]).view(4, -1)
    skey, perm = torch.sort(keys.reshape(-1).to(torch.int32), stable=True)
    return skey, perm


def fc_scratch_words(n: int) -> int:
    """float32 words of ``fc_full.cu``'s scratch for n packets (its
    ``Scratch``): per sorted position, and for CHAIN_PAD positions past the
    last, eleven (N_DECAY,) arrays (decays, parked values) and eight scalars
    (time, length, packet and direction, three scans, the opposite link, the
    segment end); three values a scan tile."""
    N = 4 * n
    return (11 * N_DECAY + 8) * (N + CHAIN_PAD) + 3 * -(-N // SCAN_TILE)


def _as_pool(state: Dict) -> Dict:
    """A dense state as a one-tenant pool (views, same storage)."""
    return {g: {k: t[None] for k, t in state[g].items()} for g in ("uni", "bi")}


def _check_launch(device: torch.device, n_tenants: int, n_slots: int) -> None:
    if device.type != "cuda":
        raise ValueError(f"feature_update_full runs on cpu or cuda, not {device}")
    if 4 * n_tenants * n_slots >= 2 ** 31:
        raise ValueError(f"{n_tenants} tenant(s) of n_slots={n_slots} overflow "
                         "the int32 row keys")


def _fc_full_launch(tab: Dict[str, torch.Tensor], n_slots: int,
                    pkts: Dict[str, torch.Tensor],
                    lane_keys: Optional[torch.Tensor]) -> torch.Tensor:
    """One ``fc_full`` launch over (n,) packets, lane-major when
    ``lane_keys`` gives each lane's key offset (:func:`fc_segments`), on the
    flat tables ``tab`` of one state or a stacked pool; returns the
    (n, N_FEATURES) features."""
    device = tab["uw"].device
    check_tables(tab, device)
    if any(v.device != device for v in pkts.values()):
        raise ValueError(f"packet tensors must lie on the state's device {device}")
    ts = pkts["ts"].to(torch.float32).contiguous()
    lens = pkts["length"].to(torch.float32).contiguous()
    n = ts.shape[0]
    if ts.dim() != 1 or lens.shape != (n,) or 4 * n >= 2 ** 31:
        raise ValueError(f"ts/length must be (n,) with 4n < 2^31, got "
                         f"{tuple(ts.shape)} and {tuple(lens.shape)}")
    feats = torch.empty((n, N_FEATURES), dtype=torch.float32, device=device)
    if n == 0:
        return feats
    rows = packet_rows(pkts, n_slots)
    skey, perm = fc_segments(rows, n_slots, lane_keys)
    dirb = rows["dir"].to(torch.int32)
    scratch = torch.empty(fc_scratch_words(n), dtype=torch.float32, device=device)
    FC_FULL.launch(device, perm.data_ptr(), skey.data_ptr(), dirb.data_ptr(),
                   ts.data_ptr(), lens.data_ptr(),
                   *(tab[k].data_ptr() for k in _TABLE_ORDER),
                   feats.data_ptr(), scratch.data_ptr(), n, n_slots)
    return feats


def feature_update_full(state: Dict, pkts: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict, torch.Tensor]:
    """All 80 Peregrine features for one packet batch, state updated in place.

    ``state``: a dense ``init_state`` dict (the ``rr`` counters pass through
    untouched); ``pkts``: ``to_torch`` packet tensors on the state's device.
    Returns ``(state, feats (n, N_FEATURES))`` matching
    ``process_serial(mode="exact")``.  The one-tenant case of
    :func:`feature_update_full_tenants`: the same launch, with keys
    ``kt*n_slots + slot``.
    """
    device = state_device(state)
    if device.type == "cpu":
        return process_serial(state, pkts)
    n_slots = state_slots(state)
    _check_launch(device, 1, n_slots)
    return state, _fc_full_launch(flat_tables(state), n_slots, pkts, None)


def feature_update_full_tenants_ref(pool, tenant_ids: Sequence[int],
                                    pkts: Dict[str, torch.Tensor]
                                    ) -> Tuple[Dict, torch.Tensor]:
    """Plain version of :func:`feature_update_full_tenants`:
    ``process_serial`` lane by lane on each tenant's view of the pool (on
    its home place, features back on the packets' device)."""
    dev = pkts["ts"].device
    feats = []
    for lane, t in enumerate(tenant_ids):
        view = tenant_view(pool, t)
        home = state_device(view)
        feats.append(process_serial(view, {k: v[lane].to(home)
                                           for k, v in pkts.items()})[1].to(dev))
    return pool, torch.stack(feats)


def feature_update_full_tenants(pool, tenant_ids: Sequence[int],
                                pkts: Dict[str, torch.Tensor]
                                ) -> Tuple[Dict, torch.Tensor]:
    """:func:`feature_update_full` for L tenants of a stacked dense pool in
    one launch, the pool updated in place.

    ``pool``: ``init_state_stacked(T, n_slots)`` (tables with a leading
    tenant axis); ``tenant_ids``: L distinct pool tenants (host ints);
    ``pkts``: ``(L, chunk)`` packet tensors, lane l for tenant
    ``tenant_ids[l]``.  Returns ``(pool, feats (L, chunk, N_FEATURES))``;
    each lane equals ``process_serial`` on its tenant's state bit for bit,
    as a launch of that lane alone does: tenants share no key, so each
    lane's segments are those of a solo launch.

    A :class:`~repro_torch.core.state.PlacedPool` takes one launch a place
    over its lanes, on the place's stacked dict (``pool.parts[p]``), the
    features back on the packets' device in lane order.
    """
    if isinstance(pool, PlacedPool):
        tids = [int(t) for t in tenant_ids]
        dev = pkts["ts"].device
        feats = [None] * len(tids)
        for p, lanes, local in pool.groups(tids):
            idx = torch.tensor(lanes, device=dev)
            _, f = feature_update_full_tenants(
                pool.parts[p], local, {k: pool.ctx.to_place(v[idx], p)
                                       for k, v in pkts.items()})
            for j, lane in enumerate(lanes):
                feats[lane] = pool.ctx.to_home(f[j], p, dev)
        return pool, torch.stack(feats)
    tids = [int(t) for t in tenant_ids]
    uw = pool["uni"]["w"]
    if uw.dim() != 4 or "rr" not in pool["uni"]:
        raise ValueError("pool must be a stacked dense state (init_state_stacked)")
    device = uw.device
    T, n_slots = uw.shape[0], uw.shape[2]
    if not tids or len(set(tids)) != len(tids) or not all(0 <= t < T for t in tids):
        raise ValueError(f"tenant_ids must be distinct tenants in [0, {T}), got {tids}")
    L = len(tids)
    if any(v.dim() != 2 or v.shape[0] != L for v in pkts.values()):
        raise ValueError(f"packet tensors must be (L={L}, chunk)")
    if device.type == "cpu":
        return feature_update_full_tenants_ref(pool, tids, pkts)
    _check_launch(device, T, n_slots)
    lane_keys = torch.tensor(tids, dtype=torch.int64).mul_(4 * n_slots).to(device)
    feats = _fc_full_launch(flat_tables(pool), n_slots,
                            {k: v.reshape(-1) for k, v in pkts.items()}, lane_keys)
    return pool, feats.view(L, -1, N_FEATURES)


def _exp2_decay(lt: torch.Tensor, t: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The oracle's decay factor, ``0`` where ``lt < 0`` else
    ``2^(-lam * max(t - lt, 0))``, elementwise."""
    dt = (t - lt).clamp_min(0.0)
    return torch.where(lt < 0.0, torch.zeros_like(dt), torch.exp2(-lam * dt))


def _decay_in_groups(lt: torch.Tensor, t: torch.Tensor, lam: torch.Tensor,
                     groups: torch.Tensor) -> torch.Tensor:
    """:func:`_exp2_decay` of (P, N_DECAY) rows, evaluated on the row groups
    the oracle evaluates together (rows sharing a value of ``groups``, in
    row order): PyTorch's CPU ``exp2`` may round a value differently when it
    runs on a longer tensor, so each group goes through ``exp2`` as one
    small tensor, as in the oracle's step."""
    out = torch.empty_like(lt)
    order = torch.argsort(groups, stable=True)
    bounds = torch.unique_consecutive(groups[order], return_counts=True)[1]
    start = 0
    for c in bounds.tolist():
        rows = order[start:start + c]
        out[rows] = _exp2_decay(lt[rows], t[rows][:, None], lam)
        start += c
    return out


def fc_key_rows(skey: torch.Tensor, n_slots: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fc_full.cu``'s ``key_type`` and ``key_row`` of combined keys
    ``(t*4 + kt)*n_slots + slot``: the key type, and the uni row
    ``(t*N_UNI + kt)*n_slots + slot`` or the bi base row
    ``(t*N_BI + kt - 2)*n_slots + slot`` of the pool's flat tables."""
    key = skey.long()
    ks = key // n_slots
    return ks & 3, ((ks >> 2) * 2 + (ks & 1)) * n_slots + key - ks * n_slots


def fc_phases_ref(state: Dict, pkts: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict, torch.Tensor]:
    """Plain twin of ``fc_full.cu``'s phases, in PyTorch, state updated in
    place; returns ``(state, feats)`` like :func:`feature_update_full`.
    The one-tenant case of :func:`fc_phases_tenants_ref`."""
    _, feats = fc_phases_tenants_ref(_as_pool(state), [0],
                                     {k: v[None] for k, v in pkts.items()})
    return state, feats[0]


def fc_phases_tenants_ref(pool: Dict, tenant_ids: Sequence[int],
                          pkts: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict, torch.Tensor]:
    """Plain twin of ``fc_full.cu``'s phases on L tenants' lanes of a
    stacked dense pool, with the kernel's combined keys and rows
    (:func:`fc_segments`, :func:`fc_key_rows`), the pool updated in place;
    returns ``(pool, feats (L, chunk, N_FEATURES))`` like
    :func:`feature_update_full_tenants`.

    1. prelude, per sorted position: the segment head, the latest earlier
       position of the own and of the opposite direction in the segment
       (segmented "last index" scans), the own atoms' decay factors (since
       the previous own-direction packet, or the stored ``last_t``) and the
       SR's (since the previous packet, or the stored ``sr_last_t``);
    2. chains, per (segment, decay): ``w*d + 1``, ``ls*d + x``,
       ``ss*d + x*x``, both directions of a bi slot together, each
       position's atoms parked;
    3. residuals, per bi position: ``r = x - mu_own``, the opposite
       direction as stored and ``r * rl_opp``;
    4. the SR chain per (bi segment, decay): ``sr*dsr + r*rl_opp``;
    5. features from the parked values, and the tables as the oracle
       leaves them.
    """
    n_slots = pool["uni"]["w"].shape[2]
    tab = flat_tables(pool)
    L = len(tenant_ids)
    flat = {k: v.reshape(-1) for k, v in pkts.items()}
    rows = packet_rows(flat, n_slots)
    lane_keys = torch.tensor([int(t) for t in tenant_ids], dtype=torch.int64,
                             device=rows["dir"].device) * (4 * n_slots)
    skey, perm = fc_segments(rows, n_slots, lane_keys)
    ts = flat["ts"].to(torch.float32)
    lens = flat["length"].to(torch.float32)
    n = ts.shape[0]
    N = 4 * n
    feats = torch.empty((n, N_FEATURES), dtype=torch.float32, device=ts.device)
    if n == 0:
        return pool, feats.view(L, 0, N_FEATURES)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    key = skey.long()
    kt, row_of = fc_key_rows(skey, n_slots)
    idx = perm - kt * n
    bi = kt >= N_UNI
    dirb = torch.where(bi, rows["dir"][idx], 0)
    t, x = ts[idx], lens[idx]
    pos = torch.arange(N, device=ts.device)

    # 1. prelude
    head = torch.ones(N, dtype=torch.bool, device=ts.device)
    head[1:] = key[1:] != key[:-1]
    seg = torch.cummax(torch.where(head, pos, 0), 0).values

    def last_before(d):
        v = torch.cummax(torch.where(dirb == d, pos, -1), 0).values
        v = torch.cat([v.new_full((1,), -1), v[:-1]])
        return torch.where(v >= seg, v, -1)

    last0, last1 = last_before(0), last_before(1)
    same = torch.where(dirb == 0, last0, last1)
    popp = torch.where(dirb == 0, last1, last0)
    prev = torch.where(head, -1, pos - 1)
    uidx = torch.where(bi, 0, row_of)
    base = torch.where(bi, row_of, 0)
    own_row, opp_row = 2 * base + dirb, 2 * base + 1 - dirb
    prev_own = torch.where(bi, same, prev)
    lt = torch.where(bi[:, None], tab["blt"][own_row], tab["ult"][uidx])
    lt = torch.where(prev_own[:, None] >= 0, t[prev_own.clamp_min(0)][:, None], lt)
    slt = torch.where(prev[:, None] >= 0, t[prev.clamp_min(0)][:, None],
                      tab["bslt"][base])
    # the oracle's step takes both uni (or both bi) key types of a packet
    group = idx * 2 + bi.long()
    delta = _decay_in_groups(lt, t, lam, group)
    dsr = _decay_in_groups(slt, t, lam, group)

    # 2. the atom chains; parked (w, ls, ss) per position
    park = torch.empty((N, 3, N_DECAY), dtype=torch.float32, device=ts.device)
    atoms = {}
    last = {}
    for p in range(N):
        k, d, r_p = int(key[p]), int(dirb[p]), int(row_of[p])
        if bool(head[p]):
            if not bool(bi[p]):
                atoms = {0: [tab[f][r_p].clone() for f in ("uw", "uls", "uss")]}
            else:
                atoms = {e: [tab[f][2 * r_p + e].clone() for f in ("bw", "bls", "bss")]
                         for e in (0, 1)}
        w, ls, ss = atoms[d]
        w, ls, ss = w * delta[p] + 1.0, ls * delta[p] + x[p], ss * delta[p] + x[p] * x[p]
        atoms[d] = [w, ls, ss]
        park[p, 0], park[p, 1], park[p, 2] = w, ls, ss
        last[(k, d)] = p

    # 3. residuals and the opposite direction as stored
    po = popp.clamp_min(0)
    has = (popp >= 0)[:, None]
    r = x[:, None] - arith.div(park[:, 1], park[:, 0])
    opp = torch.stack([torch.where(has, park[po, j], tab[f][opp_row])
                       for j, f in enumerate(("bw", "bls", "bss"))], 1)
    rl = torch.where(has, x[po][:, None] - arith.div(park[po, 1], park[po, 0]),
                     tab["brl"][opp_row])
    rprod = r * rl

    # 4. the SR chain
    sr_park = torch.zeros((N, N_DECAY), dtype=torch.float32, device=ts.device)
    sr = None
    for p in torch.nonzero(bi).flatten().tolist():
        if bool(head[p]):
            sr = tab["bsr"][int(base[p])].clone()
        sr = sr * dsr[p] + rprod[p]
        sr_park[p] = sr
        if p + 1 == N or bool(head[p + 1]):
            tab["bsr"][int(base[p])] = sr
            tab["bslt"][int(base[p])] = t[p]

    # 5. the tables as the oracle leaves them, and the features
    for (k, d), p in last.items():
        if not bool(bi[p]):
            tab["ult"][row_of[p]] = t[p]
            for j, f in enumerate(("uw", "uls", "uss")):
                tab[f][row_of[p]] = park[p, j]
        else:
            row = 2 * int(row_of[p]) + d
            tab["blt"][row] = t[p]
            for j, f in enumerate(("bw", "bls", "bss")):
                tab[f][row] = park[p, j]
            tab["brl"][row] = r[p]
    mu_o, var_o, sig_o = _stats(park[:, 0], park[:, 1], park[:, 2])
    mu_p, var_p, sig_p = _stats(opp[:, 0], opp[:, 1], opp[:, 2])
    mag = arith.sqrt(arith.square(mu_o) + arith.square(mu_p))
    rad = arith.sqrt(arith.square(var_o) + arith.square(var_p))
    cov = arith.div(sr_park, park[:, 0] + opp[:, 0])
    pcc = arith.div(cov, sig_o * sig_p)
    q = torch.arange(N_DECAY, device=ts.device)
    u, b = ~bi, bi
    ucol = (kt[u] * 12)[:, None] + q * 3
    for j, v in enumerate((park[:, 0], mu_o, sig_o)):
        feats[idx[u][:, None], ucol + j] = v[u]
    bcol = (24 + (kt[b] - N_UNI) * 28)[:, None] + q * 7
    for j, v in enumerate((park[:, 0], mu_o, sig_o, mag, rad, cov, pcc)):
        feats[idx[b][:, None], bcol + j] = v[b]
    return pool, feats.view(L, -1, N_FEATURES)


# ---------------------------------------------------------------------------
# Single-key-type atom update
# ---------------------------------------------------------------------------
TABLE_KEYS = ("last_t", "w", "ls", "ss")


def feature_update_ref(table: Dict[str, torch.Tensor], slots: torch.Tensor,
                       ts: torch.Tensor, lens: torch.Tensor
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain single-key streaming atom update, packets in array order (port
    of ``repro.kernels.ref.feature_update_ref``).

    ``table``: ``{"last_t", "w", "ls", "ss"}`` each (n_slots, N_DECAY)
    float32, updated in place; ``slots`` (n,) integer; ``ts``/``lens`` (n,).
    Returns ``(table, stats (n, 3*N_DECAY))``, stats ``[w | mu | sigma]``
    per decay.
    """
    ts, lens = ts.to(torch.float32), lens.to(torch.float32)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    stats = torch.empty((ts.shape[0], 3 * N_DECAY), dtype=torch.float32,
                        device=ts.device)
    for i in range(ts.shape[0]):
        s, t, x = slots[i], ts[i], lens[i]
        lt = table["last_t"][s]
        delta = torch.where(lt < 0, torch.zeros_like(lt),
                            torch.exp2(-lam * (t - lt).clamp_min(0.0)))
        w2 = table["w"][s] * delta + 1.0
        ls2 = table["ls"][s] * delta + x
        ss2 = table["ss"][s] * delta + x * x
        mu = ls2 / w2
        sig = torch.sqrt(torch.abs(ss2 / w2 - mu * mu))
        table["last_t"][s] = t
        table["w"][s] = w2
        table["ls"][s] = ls2
        table["ss"][s] = ss2
        stats[i] = torch.cat([w2, mu, sig])
    return table, stats


def feature_update(table: Dict[str, torch.Tensor], slots: torch.Tensor,
                   ts: torch.Tensor, lens: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Single-key-type streaming atom update (the port of the JAX package's
    ``kernels.ops.feature_update``), table updated in place.

    ``table``: ``{"last_t", "w", "ls", "ss"}`` each (n_slots, N_DECAY)
    float32; ``slots`` (n,) integers in [0, n_slots); ``ts``/``lens`` (n,).
    Returns ``(table, stats (n, 3*N_DECAY))`` matching
    :func:`feature_update_ref`.
    """
    device = table["w"].device
    if device.type == "cpu":
        return feature_update_ref(table, slots, ts, lens)
    if device.type != "cuda":
        raise ValueError(f"feature_update runs on cpu or cuda, not {device}")
    if set(table) != set(TABLE_KEYS):
        raise ValueError(f"table must hold exactly {TABLE_KEYS}, got {sorted(table)}")
    check_tables(table, device)
    n_slots = table["w"].shape[0]
    if any(t.shape != (n_slots, N_DECAY) for t in table.values()):
        raise ValueError(f"every table must be ({n_slots}, {N_DECAY})")
    if any(v.device != device for v in (slots, ts, lens)):
        raise ValueError(f"slots/ts/lens must lie on the table's device {device}")
    ts = ts.to(torch.float32).contiguous()
    lens = lens.to(torch.float32).contiguous()
    n = ts.shape[0]
    if slots.shape != (n,) or lens.shape != (n,) or n_slots * N_DECAY >= 2 ** 31:
        raise ValueError(f"slots/ts/lens must be (n,), got {tuple(slots.shape)}, "
                         f"{tuple(ts.shape)} and {tuple(lens.shape)}")
    stats = torch.empty((n, 3 * N_DECAY), dtype=torch.float32, device=device)
    if n == 0:
        return table, stats
    if int(slots.min()) < 0 or int(slots.max()) >= n_slots:
        raise ValueError(f"slots must lie in [0, {n_slots})")
    skey, perm = torch.sort(slots.to(torch.int32), stable=True)
    # per sorted position (and CHAIN_PAD past the last): decays and parked
    # atoms, time, length, index, run end
    scratch = torch.empty((4 * N_DECAY + 4) * (n + CHAIN_PAD), dtype=torch.float32,
                          device=device)
    FEATURE_UPDATE.launch(device, perm.data_ptr(), skey.data_ptr(), ts.data_ptr(),
                          lens.data_ptr(),
                          *(table[k].data_ptr() for k in TABLE_KEYS),
                          stats.data_ptr(), scratch.data_ptr(), n)
    return table, stats


def feature_update_phases_ref(table: Dict[str, torch.Tensor], slots: torch.Tensor,
                              ts: torch.Tensor, lens: torch.Tensor
                              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain twin of ``feature_update.cu``'s phases, in PyTorch, table
    updated in place; returns ``(table, stats)`` like :func:`feature_update`:
    the prelude's decay factors per sorted position (since the previous
    packet of the slot, or the stored ``last_t``), the affine chain per
    (run, decay) with each packet's atoms parked, then ``mu`` and ``sigma``
    from the parked atoms."""
    ts, lens = ts.to(torch.float32), lens.to(torch.float32)
    n = ts.shape[0]
    stats = torch.empty((n, 3 * N_DECAY), dtype=torch.float32, device=ts.device)
    if n == 0:
        return table, stats
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    skey, perm = torch.sort(slots.to(torch.int32), stable=True)
    key = skey.long()
    t, x = ts[perm], lens[perm]
    head = torch.ones(n, dtype=torch.bool, device=ts.device)
    head[1:] = key[1:] != key[:-1]
    pos = torch.arange(n, device=ts.device)
    lt = torch.where(head[:, None], table["last_t"][key],
                     t[(pos - 1).clamp_min(0)][:, None])
    # the plain version evaluates each packet's decay as one small tensor
    delta = _decay_in_groups(lt, t, lam, pos)
    park = torch.empty((n, 3, N_DECAY), dtype=torch.float32, device=ts.device)
    for p in range(n):
        k = int(key[p])
        if bool(head[p]):
            w, ls, ss = (table[f][k].clone() for f in ("w", "ls", "ss"))
        w, ls, ss = w * delta[p] + 1.0, ls * delta[p] + x[p], ss * delta[p] + x[p] * x[p]
        park[p, 0], park[p, 1], park[p, 2] = w, ls, ss
        if p + 1 == n or bool(head[p + 1]):
            table["last_t"][k] = t[p]
            table["w"][k], table["ls"][k], table["ss"][k] = w, ls, ss
    mu = park[:, 1] / park[:, 0]
    sig = torch.sqrt(torch.abs(park[:, 2] / park[:, 0] - mu * mu))
    stats[perm] = torch.cat([park[:, 0], mu, sig], 1)
    return table, stats
