"""Exact FC kernels and their wrappers: the 80-feature ``csrc/fc_full.cu``
(``feature_update_full``) and the single-key-type ``csrc/feature_update.cu``
(``feature_update``).

``feature_update_full`` replaces the JAX package's Pallas TPU kernel
``repro/kernels/feature_update.py::feature_update_full`` (``_fc_full_kernel``).

On the TPU one sequential grid walks every packet with the flow tables in
VMEM.  On the H100 the packets are split into per-(key type, slot) segments
instead: serial order only matters within a segment, so the wrapper stable-
sorts the (key type, packet) pairs by table row and the kernel runs one
thread per segment, with that segment's rows held in registers.  Bi key
types segment on the channel/socket slot with both directions together,
because the SR and last-residual state crosses directions.

What bounds it on the card: bytes, about 1.1 KB per packet (touched rows
read and written once, 320 B of features); in practice the sort and the
longest segment, which one thread walks alone, set its time.

``feature_update`` replaces ``repro/kernels/feature_update.py::
feature_update`` (``_fc_kernel``), the JAX package's public single-key entry
point ``kernels/ops.feature_update``: one key type's atom update over an
``(n_slots, N_DECAY)`` table.  It is the uni half of ``fc_full.cu``: the
packets are stable-sorted by slot and one thread walks each slot's run.
Bound: bytes, about 128 B of touched rows and 64 B of stats, packet data,
index and key a packet; in practice the longest run.

For a CPU tensor each wrapper runs its plain PyTorch version
(``core.pipeline.process_serial``, :func:`feature_update_ref`); for a CUDA
tensor it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.pipeline import flat_tables, packet_rows, process_serial
from repro_torch.core.state import (LAMBDAS, N_DECAY, N_FEATURES, N_UNI,
                                    state_device, state_slots)
from repro_torch.kernels.build import INT, VOIDP, CudaKernel

FC_FULL = CudaKernel("fc_full.cu", "fc_full_launch",
                     argtypes=[VOIDP] * 17 + [INT, INT, INT, VOIDP],
                     flags=("--fmad=false",))
FEATURE_UPDATE = CudaKernel("feature_update.cu", "feature_update_launch",
                            argtypes=[VOIDP] * 9 + [INT, INT, VOIDP],
                            flags=("--fmad=false",))

_BLOCK = 256
# the flat tables in the order fc_full_launch takes them
_TABLE_ORDER = ("ult", "uw", "uls", "uss", "blt", "bw", "bls", "bss", "brl",
               "bsr", "bslt")


def check_tables(tab: Dict[str, torch.Tensor], device) -> None:
    for name, t in tab.items():
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"state table {name!r} must be a contiguous "
                             f"float32 tensor on {device}, got {t.dtype} "
                             f"on {t.device}")


def fc_segments(rows: Dict[str, torch.Tensor],
                n_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted combined keys ``kt*n_slots + slot`` (int32, length 4n) and the
    stable sort permutation into the kt-major (4, n) key matrix (int64).
    Stability keeps each segment in array order, the oracle's order."""
    keys = torch.cat([rows["urow"].T, rows["bbase"].T + N_UNI * n_slots])
    skey, perm = torch.sort(keys.reshape(-1).to(torch.int32), stable=True)
    return skey, perm


def feature_update_full(state: Dict, pkts: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict, torch.Tensor]:
    """All 80 Peregrine features for one packet batch, state updated in place.

    ``state``: a dense ``init_state`` dict (the ``rr`` counters pass through
    untouched); ``pkts``: ``to_torch`` packet tensors on the state's device.
    Returns ``(state, feats (n, N_FEATURES))`` matching
    ``process_serial(mode="exact")``.
    """
    device = state_device(state)
    if device.type == "cpu":
        return process_serial(state, pkts)
    if device.type != "cuda":
        raise ValueError(f"feature_update_full runs on cpu or cuda, not {device}")
    n_slots = state_slots(state)
    if 4 * n_slots >= 2 ** 31:
        raise ValueError(f"n_slots={n_slots} overflows the int32 row keys")
    tab = flat_tables(state)
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
        return state, feats
    rows = packet_rows(pkts, n_slots)
    skey, perm = fc_segments(rows, n_slots)
    dirb = rows["dir"].to(torch.int32)
    stream = torch.cuda.current_stream(device).cuda_stream
    FC_FULL.launch(perm.data_ptr(), skey.data_ptr(), dirb.data_ptr(),
                   ts.data_ptr(), lens.data_ptr(),
                   *(tab[k].data_ptr() for k in _TABLE_ORDER),
                   feats.data_ptr(), n, n_slots, _BLOCK, stream)
    return state, feats


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
    stream = torch.cuda.current_stream(device).cuda_stream
    FEATURE_UPDATE.launch(perm.data_ptr(), skey.data_ptr(), ts.data_ptr(),
                          lens.data_ptr(),
                          *(table[k].data_ptr() for k in TABLE_KEYS),
                          stats.data_ptr(), n, _BLOCK, stream)
    return table, stats
