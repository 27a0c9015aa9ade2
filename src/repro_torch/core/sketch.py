"""Count-Min sketch flow state (port of ``repro.core.sketch``).

The dense layout direct-indexes ``hash(key) % n_slots``, so past the slot
budget flows merge.  The sketch keeps every decay atom in R independently
hashed rows of width W, reads the per-atom minimum across rows, and writes
with conservative update (a cell is raised to the new estimate, never past
its own decayed value), so an estimate only ever overestimates (DESIGN.md
§11).

Layout (``init_sketch_state``): the dense tables with the slot axis replaced
by (rows, width): uni atoms ``(N_UNI, R, W, N_DECAY)``, bi atoms
``(N_BI, R, W, 2, N_DECAY)``, channel SR state ``(N_BI, R, W, N_DECAY)``
plus ``sw``, a per-row conservative channel packet count.  SR is signed, so
a minimum would bias it: the emitted SR comes from the row with the least
``sw`` (the least collided).  ``evict_age`` is a 0-dim float32 tensor on
the state's device: a cell idle for longer than that many seconds reads as
empty (0 disables aging).  It stays on the device so that no step has to
read it back to the host.

Row r of key type k hashes with salt ``KEY_SALTS[k] ^ (r * 0x85EBCA6B)``, so
row 0 keeps the dense salt: a ``rows=1`` sketch of width ``n_slots`` maps
flows to the dense slots, and its state update is the dense serial oracle's
bit for bit (both run uncontracted float32 here).

Two implementations of one update:

  * :func:`process_sketch`, the plain version: a per-packet loop of torch
    ops in the JAX package's op order.  Conservative update is
    order-dependent through the cross-row minimum, so it is packet-serial.
  * ``kernels/sketch_update.sketch_update_full``, the CUDA kernel
    ``csrc/sketch_update.cu``; for CPU tensors it runs the plain version.

``compute_features(state, pkts, backend=...)`` finds a sketch state by its
keys and routes here: ``cuda`` (aliases ``pallas``, ``kernel``) runs the
kernel wrapper, ``serial`` the plain version.  Exact arithmetic only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import arith
from repro_torch.core.pipeline import TABLES, flat_tables
from repro_torch.core.state import (KEY_SALTS, LAMBDAS, N_BI, N_DECAY,
                                    N_FEATURES, N_UNI, StateBackend,
                                    hash_fields, key_fields,
                                    register_state_backend)
from repro_torch.device import DeviceLike, resolve_device

# row-salt derivation constant (murmur3 fmix): row 0 keeps the dense salt
_ROW_SALT_MIX = 0x85EBCA6B

# the dense flat views plus the sketch's per-row channel counts
SKETCH_TABLES = {**TABLES, "bsw": ("bi", "sw")}


def row_salt(base: int, r: int) -> int:
    """Salt of sketch row ``r`` for a key type with dense salt ``base``."""
    return (base ^ ((r * _ROW_SALT_MIX) & 0xFFFFFFFF)) & 0xFFFFFFFF


def init_sketch_state(n_slots: int, rows: int = 4, evict_age: float = 0.0,
                      device: DeviceLike = None) -> Dict:
    """Fresh Count-Min tables: ``rows`` hashed rows of width ``n_slots`` per
    key type; ``evict_age`` seconds of idleness after which a cell reads as
    empty (0 = no aging)."""
    if rows < 1:
        raise ValueError(f"sketch needs at least one row, got {rows}")
    R, W = int(rows), int(n_slots)
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def neg(*shape):
        return torch.full(shape, -1.0, dtype=torch.float32, device=dev)

    return {
        "uni": {
            "last_t": neg(N_UNI, R, W, N_DECAY),
            "w": z(N_UNI, R, W, N_DECAY),
            "ls": z(N_UNI, R, W, N_DECAY),
            "ss": z(N_UNI, R, W, N_DECAY),
        },
        "bi": {
            "last_t": neg(N_BI, R, W, 2, N_DECAY),
            "w": z(N_BI, R, W, 2, N_DECAY),
            "ls": z(N_BI, R, W, 2, N_DECAY),
            "ss": z(N_BI, R, W, 2, N_DECAY),
            "res_last": z(N_BI, R, W, 2, N_DECAY),
            "sr": z(N_BI, R, W, N_DECAY),
            "sr_last_t": neg(N_BI, R, W, N_DECAY),
            "sw": z(N_BI, R, W, N_DECAY),
        },
        "evict_age": torch.tensor(float(evict_age), dtype=torch.float32,
                                  device=dev),
    }


def sketch_rows(state: Dict) -> int:
    return state["uni"]["w"].shape[1]


def sketch_width(state: Dict) -> int:
    return state["uni"]["w"].shape[2]


def sketch_packet_rows(pkts: Dict[str, torch.Tensor], rows: int,
                       width: int) -> Dict[str, torch.Tensor]:
    """Per-packet sketch columns, (n, rows) int64 per key type, plus the
    channel ``dir`` bit: the multi-row ``packet_slots`` (row 0 is the dense
    slot mapping of a width-``width`` table)."""
    fields, dirb = key_fields(pkts)
    out = {"dir": dirb}
    for k, f in fields.items():
        out[k] = torch.stack([hash_fields(f, row_salt(KEY_SALTS[k], r)) % width
                              for r in range(rows)], -1)
    return out


def sketch_flat_rows(pkts: Dict[str, torch.Tensor], rows: int,
                     width: int) -> Dict[str, torch.Tensor]:
    """Rows of the flat ``(rows, N_DECAY)`` table views: ``urow``
    (n, N_UNI, R) uni rows ``(k*R + r)*W + col``, ``bbase`` (n, N_BI, R) bi
    base rows (the SR row; direction rows are ``2*bbase + dir``) and
    ``dir`` (n,)."""
    sl = sketch_packet_rows(pkts, rows, width)
    dev = sl["dir"].device
    key_off = (torch.arange(N_UNI, device=dev)[:, None] * rows
               + torch.arange(rows, device=dev)[None, :]) * width   # (K, R)
    urow = torch.stack([sl["src_mac_ip"], sl["src_ip"]], 1) + key_off
    bbase = torch.stack([sl["channel"], sl["socket"]], 1) + key_off
    return {"urow": urow, "bbase": bbase, "dir": sl["dir"]}


# ---------------------------------------------------------------------------
# Plain version (per-packet loop of torch ops)
# ---------------------------------------------------------------------------
def _cu_update(lam, age, lt, w, ls, ss, t, x):
    """Conservative-update decay + atom update across rows.

    ``lt/w/ls/ss``: (K, R, N_DECAY) gathered cells.  Returns the stored
    (w, ls, ss) and the per-atom Count-Min estimates (K, N_DECAY).  The
    candidate ``v*delta + inc`` comes first and the stored value is
    ``max(cand - inc, est)``, the JAX package's formulation: at R=1 the
    estimate is the candidate, so the stored state is the dense update's.
    """
    dt = (t - lt).clamp_min(0.0)
    dead = (lt < 0.0) | ((age > 0.0) & (dt > age))
    delta = torch.where(dead, torch.zeros_like(dt), torch.exp2(-lam * dt))
    cw = w * delta + 1.0
    cls = ls * delta + x
    css = ss * delta + x * x
    ew = cw.amin(1, keepdim=True)
    els = cls.amin(1, keepdim=True)
    ess = css.amin(1, keepdim=True)
    w2 = torch.maximum(cw - 1.0, ew)
    ls2 = torch.maximum(cls - x, els)
    ss2 = torch.maximum(css - x * x, ess)
    return w2, ls2, ss2, (ew[:, 0], els[:, 0], ess[:, 0])


def _stats(w, ls, ss):
    mu = arith.div(ls, w)
    var = torch.abs(arith.div(ss, w) - arith.square(mu))
    return mu, var, arith.sqrt(var)


def _sketch_packet_step(tab, lam, age, urow, brow_o, brow_p, brow_s,
                        t, x) -> torch.Tensor:
    """One packet through the sketch: the dense serial step with R-row
    conservative-update access.  Row arguments are (K, R); returns the
    packet's N_FEATURES features."""
    # ---- unidirectional key types ----
    lt, w, ls, ss = (tab[k][urow] for k in ("ult", "uw", "uls", "uss"))
    w2, ls2, ss2, (ew, els, ess) = _cu_update(lam, age, lt, w, ls, ss, t, x)
    mu, _, sig = _stats(ew, els, ess)
    f_uni = torch.stack([ew, mu, sig], -1).reshape(-1)
    tab["ult"][urow] = t
    tab["uw"][urow] = w2
    tab["uls"][urow] = ls2
    tab["uss"][urow] = ss2

    # ---- bidirectional key types ----
    lt_o, w_o, ls_o, ss_o = (tab[k][brow_o] for k in ("blt", "bw", "bls", "bss"))
    w_o2, ls_o2, ss_o2, (ew_o, els_o, ess_o) = _cu_update(
        lam, age, lt_o, w_o, ls_o, ss_o, t, x)
    mu_o, var_o, sig_o = _stats(ew_o, els_o, ess_o)

    # opposite-direction stats: stored values (stale, as on the switch),
    # aged-out cells read as empty, then the Count-Min min across rows
    zap = (age > 0.0) & ((t - tab["blt"][brow_p]) > age)

    def opp_min(name):
        v = tab[name][brow_p]
        return torch.where(zap, torch.zeros_like(v), v).amin(1)

    w_p, ls_p, ss_p = opp_min("bw"), opp_min("bls"), opp_min("bss")
    mu_p, var_p, sig_p = _stats(w_p, ls_p, ss_p)

    # SR: every row keeps its own sr/res_last stream; the emitted value comes
    # from the row with the least conservative channel count sw
    sr, sr_lt, sw = (tab[k][brow_s] for k in ("bsr", "bslt", "bsw"))
    res_last_o = tab["brl"][brow_p]
    r_feat = x - mu_o                                          # (K, ND)
    dt_sr = (t - sr_lt).clamp_min(0.0)
    evict_sr = (age > 0.0) & (dt_sr > age)
    dsr = torch.where((sr_lt < 0.0) | evict_sr, torch.zeros_like(sr),
                      torch.exp2(-lam * dt_sr))
    r_opp = torch.where(evict_sr, torch.zeros_like(res_last_o), res_last_o)
    sr2 = sr * dsr + r_feat[:, None, :] * r_opp                # (K, R, ND)
    sw_now = sw * dsr
    sw2 = torch.maximum(sw_now, sw_now.amin(1, keepdim=True) + 1.0)
    # argmin returns the first minimum, as jnp.argmin and the TPU kernel's
    # strict-< running select do
    best = sw2.argmin(1, keepdim=True)
    sr_est = sr2.gather(1, best)[:, 0]

    mag = arith.sqrt(arith.square(mu_o) + arith.square(mu_p))
    rad = arith.sqrt(arith.square(var_o) + arith.square(var_p))
    cov = arith.div(sr_est, ew_o + w_p)
    pcc = arith.div(cov, sig_o * sig_p)
    f_bi = torch.stack([ew_o, mu_o, sig_o, mag, rad, cov, pcc], -1).reshape(-1)

    tab["blt"][brow_o] = t
    tab["bw"][brow_o] = w_o2
    tab["bls"][brow_o] = ls_o2
    tab["bss"][brow_o] = ss_o2
    tab["brl"][brow_o] = r_feat[:, None, :].expand_as(sr2)
    tab["bsr"][brow_s] = sr2
    tab["bslt"][brow_s] = t
    tab["bsw"][brow_s] = sw2
    return torch.cat([f_uni, f_bi])


def _check_exact(mode: str) -> None:
    if mode != "exact":
        raise ValueError("the sketch state backend supports exact "
                         f"arithmetic only, got mode={mode!r} (switch-mode "
                         "round-robin decay is tied to the dense rr "
                         "counters)")


def process_sketch(state: Dict, pkts: Dict[str, torch.Tensor],
                   mode: str = "exact") -> Tuple[Dict, torch.Tensor]:
    """Plain sketch update: packets one at a time, in array order.

    Updates ``state`` in place and returns ``(state, feats (n,
    N_FEATURES))``.  The sketch kernel's plain version.
    """
    _check_exact(mode)
    rows = sketch_flat_rows(pkts, sketch_rows(state), sketch_width(state))
    tab = flat_tables(state, SKETCH_TABLES)
    ts = pkts["ts"].to(torch.float32)
    lens = pkts["length"].to(torch.float32)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32, device=ts.device)
    age = state["evict_age"]
    d = rows["dir"][:, None, None]
    brow_s = rows["bbase"]
    brow_o = brow_s * 2 + d
    brow_p = brow_s * 2 + (1 - d)
    feats = torch.empty((ts.shape[0], N_FEATURES), dtype=torch.float32,
                        device=ts.device)
    for i in range(ts.shape[0]):
        feats[i] = _sketch_packet_step(tab, lam, age, rows["urow"][i],
                                       brow_o[i], brow_p[i], brow_s[i],
                                       ts[i], lens[i])
    return state, feats


# ---------------------------------------------------------------------------
# compute dispatch + layout registration
# ---------------------------------------------------------------------------
def compute_features_sketch(state: Dict, pkts: Dict[str, torch.Tensor],
                            mode: str = "exact", fc_backend: str = "cuda",
                            buckets: Optional[int] = None,
                            shards: Optional[int] = None
                            ) -> Tuple[Dict, torch.Tensor]:
    """Route a sketch-state batch: ``cuda`` → the kernel wrapper, anything
    else → the plain version.  The dense backends' partition options
    (``buckets``/``shards``) are taken and ignored, as in the JAX package:
    partitioning belongs to the dense slot layout."""
    _check_exact(mode)
    if fc_backend == "cuda":
        from repro_torch.kernels.sketch_update import sketch_update_full
        return sketch_update_full(state, pkts)
    return process_sketch(state, pkts)


register_state_backend(StateBackend(
    name="sketch",
    init=init_sketch_state,
    slots=sketch_width,
    matches=lambda s: isinstance(s, dict) and "evict_age" in s,
    config=lambda s: {"rows": sketch_rows(s),
                      "evict_age": float(s["evict_age"])},
    compute=compute_features_sketch,
))
