"""Serial feature computation (port of ``repro.core.pipeline``).

``process_serial`` applies packets one at a time, in array order, mirroring
the switch's per-packet MAU pipeline:

  decay feature atoms -> update atoms -> compute statistics -> emit features

Two fidelity modes, as in the JAX package:
  * ``exact``  — real mul/div/sqrt, all 4 decay instances updated per packet;
  * ``switch`` — the switch's shift and math-unit arithmetic (``arith``),
    floored decays, quantised decay, and the round-robin update of one decay
    instance per packet (``rr`` tables).

In exact mode it is the port's oracle and the plain PyTorch version of the
FC kernel (``kernels/feature_update.py``): the kernel is held against it on
the card, and it is held against the JAX package's ``process_serial`` in the
tests.  Switch mode has no kernel (the JAX package runs it only on its
serial oracle); it runs here on the state's device.  It is a Python loop
over packets, so it is slow by design.

Tables are addressed through the row layout of the JAX package's Pallas
kernel (DESIGN.md §2): every table is viewed as ``(rows, N_DECAY)``; uni key
type ``k`` of slot ``s`` is row ``k*n_slots + s``; bi key type ``k`` keeps
its two directions in rows ``2*(k*n_slots + s) + dir`` and its channel-level
SR state in row ``k*n_slots + s``.  The views share storage with the state
dict, so the step updates the state in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import arith
from repro_torch.core.state import (LAMBDAS, N_DECAY, N_FEATURES, N_UNI,
                                    packet_slots, state_slots)

# flat (rows, N_DECAY) view name -> (group, table) in the state dict
TABLES = {
    "ult": ("uni", "last_t"), "uw": ("uni", "w"), "uls": ("uni", "ls"),
    "uss": ("uni", "ss"),
    "blt": ("bi", "last_t"), "bw": ("bi", "w"), "bls": ("bi", "ls"),
    "bss": ("bi", "ss"), "brl": ("bi", "res_last"),
    "bsr": ("bi", "sr"), "bslt": ("bi", "sr_last_t"),
}


def flat_tables(state: Dict, tables: Dict = TABLES) -> Dict[str, torch.Tensor]:
    """``(rows, N_DECAY)`` views of the state's float tables (same storage)."""
    return {name: state[g][k].view(-1, N_DECAY)
            for name, (g, k) in tables.items()}


def packet_rows(pkts: Dict[str, torch.Tensor],
                n_slots: int) -> Dict[str, torch.Tensor]:
    """Per-packet table rows: ``urow`` (n, N_UNI) uni rows, ``bbase``
    (n, N_BI) bi base rows (the SR row; direction rows are ``2*bbase+dir``)
    and ``dir`` (n,)."""
    sl = packet_slots(pkts, n_slots)
    key_off = torch.arange(N_UNI, dtype=torch.int64,
                           device=sl["dir"].device) * n_slots
    urow = torch.stack([sl["src_mac_ip"], sl["src_ip"]], -1) + key_off
    bbase = torch.stack([sl["channel"], sl["socket"]], -1) + key_off
    return {"urow": urow, "bbase": bbase, "dir": sl["dir"]}


def _update(lam, lt, w, ls, ss, t, x, exp2=torch.exp2):
    """One stream's decay + atom update (exact mode)."""
    dt = (t - lt).clamp_min(0.0)
    delta = torch.where(lt < 0.0, torch.zeros_like(dt), exp2(-lam * dt))
    return w * delta + 1.0, ls * delta + x, ss * delta + x * x


def _update_switch(lam, lt, w, ls, ss, rr, t, x):
    """One stream's update in switch mode: only decay instance ``rr % 4``
    is decayed (floored, quantised) and updated this packet, and ``rr``
    advances (the paper's round-robin, Figure 5).  Returns the new
    ``(last_t, w, ls, ss, rr)``."""
    dt = (t - lt).clamp_min(0.0)
    delta = torch.where(lt < 0.0, torch.zeros_like(dt),
                        arith.quantized_decay(lam, dt))
    upd = torch.arange(N_DECAY, device=rr.device) == (rr % N_DECAY)[..., None]
    w2 = torch.where(upd, torch.floor(w * delta) + 1.0, w)
    ls2 = torch.where(upd, torch.floor(ls * delta) + x, ls)
    ss2 = torch.where(upd, torch.floor(ss * delta) + x * x, ss)
    return torch.where(upd, t, lt), w2, ls2, ss2, rr + 1


def _stats(w, ls, ss, mode: str = "exact"):
    """(mu, var, sigma) per decay instance."""
    mu = arith.div(ls, w, mode)
    ex2 = arith.div(ss, w, mode)
    var = torch.abs(ex2 - arith.square(mu, mode))
    return mu, var, arith.sqrt(var, mode)


def uni_step(tab, lam, urow, t, x, mode: str = "exact", rr=None,
             exp2=torch.exp2) -> torch.Tensor:
    """Apply one packet to the uni rows ``urow`` (one per key type);
    returns their features, (len(urow) * N_DECAY * 3,).  Switch mode also
    takes the flat round-robin counters ``rr`` (indexed by ``urow``).
    Exact mode's decays go through ``exp2`` (core/sharded.py evaluates
    them at the owning rows only)."""
    lt, w, ls, ss = (tab[k][urow] for k in ("ult", "uw", "uls", "uss"))
    if mode == "switch":
        lt2, w2, ls2, ss2, rr[urow] = _update_switch(lam, lt, w, ls, ss,
                                                     rr[urow], t, x)
    else:
        lt2 = t
        w2, ls2, ss2 = _update(lam, lt, w, ls, ss, t, x, exp2)
    mu, _, sig = _stats(w2, ls2, ss2, mode)
    tab["ult"][urow] = lt2
    tab["uw"][urow] = w2
    tab["uls"][urow] = ls2
    tab["uss"][urow] = ss2
    return torch.stack([w2, mu, sig], -1).reshape(-1)


def bi_step(tab, lam, brow_o, brow_p, brow_s, t, x, mode: str = "exact",
            rr=None, exp2=torch.exp2) -> torch.Tensor:
    """Apply one packet to the bi rows (own direction ``brow_o``, opposite
    ``brow_p``, channel-level SR ``brow_s``; one per key type); returns
    their features, (len(brow_o) * N_DECAY * 7,).  Switch mode also takes
    the flat round-robin counters ``rr``, one per channel (``brow_s``):
    both directions advance the same counter.  ``exp2`` as in
    :func:`uni_step`."""
    lt_o, w_o, ls_o, ss_o = (tab[k][brow_o] for k in ("blt", "bw", "bls", "bss"))
    if mode == "switch":
        lt_o, w_o, ls_o, ss_o, rr[brow_s] = _update_switch(
            lam, lt_o, w_o, ls_o, ss_o, rr[brow_s], t, x)
    else:
        w_o, ls_o, ss_o = _update(lam, lt_o, w_o, ls_o, ss_o, t, x, exp2)
        lt_o = t
    # own stats and the opposite direction's from its stored values (stale,
    # as on the switch), as one stacked call: [0] own, [1] opposite
    w_p = tab["bw"][brow_p]
    mu, var, sig = _stats(torch.stack([w_o, w_p]),
                          torch.stack([ls_o, tab["bls"][brow_p]]),
                          torch.stack([ss_o, tab["bss"][brow_p]]), mode)
    mu_o, sig_o, sig_p = mu[0], sig[0], sig[1]

    # SR: decayed sum of cross-direction residual products (every decay
    # instance, both modes)
    sr, sr_lt = tab["bsr"][brow_s], tab["bslt"][brow_s]
    dsr = torch.where(sr_lt < 0.0, torch.zeros_like(sr),
                      arith.decay(lam, (t - sr_lt).clamp_min(0.0), mode, exp2))
    r = x - mu_o
    sr2 = sr * dsr + r * tab["brl"][brow_p]

    # magnitude and radius: [0] from the means, [1] from the variances
    sq = arith.square(torch.stack([mu, var]), mode)
    mag, rad = arith.sqrt(sq[:, 0] + sq[:, 1], mode)
    cov = arith.div(sr2, w_o + w_p, mode)
    denom = (arith.shift_mul(sig_o, sig_p) if mode == "switch"
             else sig_o * sig_p)
    pcc = arith.div(cov, denom, mode)
    tab["blt"][brow_o] = lt_o
    tab["bw"][brow_o] = w_o
    tab["bls"][brow_o] = ls_o
    tab["bss"][brow_o] = ss_o
    tab["brl"][brow_o] = r
    tab["bsr"][brow_s] = sr2
    tab["bslt"][brow_s] = t
    return torch.stack([w_o, mu_o, sig_o, mag, rad, cov, pcc], -1).reshape(-1)


def process_serial(state: Dict, pkts: Dict[str, torch.Tensor],
                   mode: str = "exact") -> Tuple[Dict, torch.Tensor]:
    """Sequential per-packet processing in array order, ``mode`` exact or
    switch.

    ``pkts``: ``{ts, src, dst, sport, dport, proto, length}`` tensors of
    shape (n,) on the state's device (``traffic.to_torch``).  Updates
    ``state`` in place and returns ``(state, features (n, N_FEATURES))``.
    """
    arith.check_mode(mode)
    rows = packet_rows(pkts, state_slots(state))
    tab = flat_tables(state)
    rr_u = rr_b = None
    if mode == "switch":
        rr_u, rr_b = state["uni"]["rr"].view(-1), state["bi"]["rr"].view(-1)
    ts = pkts["ts"].to(torch.float32)
    lens = pkts["length"].to(torch.float32)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    d = rows["dir"][:, None]
    brow_s = rows["bbase"]
    brow_o = brow_s * 2 + d
    brow_p = brow_s * 2 + (1 - d)
    feats = torch.empty((ts.shape[0], N_FEATURES), dtype=torch.float32,
                        device=ts.device)
    for i in range(ts.shape[0]):
        t, x = ts[i], lens[i]
        feats[i] = torch.cat([uni_step(tab, lam, rows["urow"][i], t, x,
                                       mode, rr_u),
                              bi_step(tab, lam, brow_o[i], brow_p[i],
                                      brow_s[i], t, x, mode, rr_b)])
    return state, feats
