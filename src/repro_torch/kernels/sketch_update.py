"""Count-Min sketch FC: the CUDA kernels ``csrc/sketch_update.cu`` and their
wrapper, and the plain twin of the kernels' schedule.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/sketch_update.py::sketch_update_full`` (``_sketch_kernel``).

The TPU kernel walks every packet in one sequential grid with all sketch
tables in VMEM.  On the card most of that order is false dependence: per
key type, a packet only has to follow the earlier packets that share one of
its columns in some row (a bi key type's own, opposite and SR cells all hang
off the channel's base column).  So one launch runs three kernels:

* the schedule, one block per key type: each packet's dependency level,
  ``level(i) = 1 + max_r last[r, col_r(i)]``, then ``last[r, col_r(i)] =
  level(i)``, computed 32 packets a warp step; the packets sorted stably by
  level; each level cut into rounds of at most ``round_size(R)`` packets.
  ``last`` is a shared-memory table of ``LAST_TABLE`` entries where row r
  owns a stripe of ``last_row_width(R)`` and a column is taken modulo it:
  aliased columns only add dependencies.
* the update, one block per (key type, decay): the rounds in order, a
  packet per group of R lanes (R rounded up to a power of two, at most a
  warp; past 32 rows a lane takes several and reduces over them first), the
  Count-Min minimum and the argmin of ``sw`` as shuffles inside the group;
  it leaves each packet's estimates in its feature slots;
* the features, a thread per (packet, key type, decay): the divisions and
  square roots that only the features need, off the chain of rounds.

Each cell still sees its packets in array order, so the result is the serial
walk's bit for bit.  The wrapper hashes each packet's R row indices per key
type in torch ops first, as the TPU wrapper does, and allocates the
schedule's scratch (``scratch_size``) on the card.

What bounds it on the card: bytes, each touched cell read and written once
and 320 B of features a packet; in practice the chain of levels, a round of
dependent L2 round trips and arithmetic per level of the deepest key type.

For a CPU tensor the wrapper runs the plain PyTorch version,
``core.sketch.process_sketch``; for a CUDA tensor it launches the kernels or
raises.  :func:`sketch_schedule_ref` is the schedule's plain twin: the same
levels, order and rounds from the same row indices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.pipeline import flat_tables
from repro_torch.core.sketch import (SKETCH_TABLES, process_sketch,
                                     sketch_flat_rows, sketch_rows,
                                     sketch_width)
from repro_torch.core.state import N_FEATURES, state_device
from repro_torch.kernels.build import INT, VOIDP, CudaKernel
from repro_torch.kernels.feature_update import check_tables

SKETCH_UPDATE = CudaKernel("sketch_update.cu", "sketch_update_launch",
                           argtypes=[VOIDP] * 19 + [INT, INT, INT, VOIDP],
                           flags=("--fmad=false",))

# as in csrc/sketch_update.cu
LAST_TABLE = 32768    # entries of the schedule's `last` table; at most R rows
UPDATE_THREADS = 512  # threads of an update block
# the flat tables in the order sketch_update_launch takes them
_TABLE_ORDER = ("ult", "uw", "uls", "uss", "blt", "bw", "bls", "bss", "brl",
                "bsr", "bslt", "bsw")


def round_size(rows: int) -> int:
    """Packets a round of the update: a group of lanes a packet, one lane a
    row, rows rounded up to a power of two, at most a warp of 32 lanes."""
    return UPDATE_THREADS // min(32, 1 << (rows - 1).bit_length())


def last_row_width(rows: int, table: int = LAST_TABLE) -> int:
    """Entries of ``last`` a row owns: the largest power of two with
    ``rows`` of them in ``table``."""
    w = table
    while w * rows > table:
        w //= 2
    return w


def scratch_size(n: int) -> int:
    """int32 entries of the schedule's scratch for n packets: per key type
    level, rank, order (n each), level starts (n + 2), round starts (n + 1)
    and {depth, rounds}."""
    return 4 * (5 * n + 5)


def kernel_rows(pkts: Dict[str, torch.Tensor], rows: int,
                width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's index inputs: flat table rows, (4, n, R) int32 with key
    type major (uni rows, then bi SR rows), and the (n,) int32 dir bits."""
    fr = sketch_flat_rows(pkts, rows, width)
    idx = torch.cat([fr["urow"], fr["bbase"]], 1).permute(1, 0, 2)
    return idx.to(torch.int32).contiguous(), fr["dir"].to(torch.int32)


def schedule_views(scratch: torch.Tensor, n: int) -> Dict:
    """The schedule the kernel left in ``scratch``: ``level`` and ``order``
    (4, n) int32, ``depth`` and ``rounds`` per key type, and the
    ``round_starts`` of each key type (rounds + 1 positions in ``order``)."""
    per = scratch.view(4, 5 * n + 5)
    meta = per[:, 5 * n + 3:].tolist()
    return {"level": per[:, :n], "order": per[:, 2 * n:3 * n],
            "depth": [m[0] for m in meta], "rounds": [m[1] for m in meta],
            "round_starts": [per[k, 4 * n + 2:4 * n + 3 + meta[k][1]]
                             for k in range(4)]}


def sketch_schedule_ref(idx: torch.Tensor, width: int,
                        table: int = LAST_TABLE) -> Dict:
    """Plain twin of the kernel's schedule, from ``kernel_rows``' (4, n, R)
    row indices, as :func:`schedule_views` returns it.  ``table`` is the
    size of ``last``; columns alias modulo ``last_row_width``."""
    _, n, R = idx.shape
    tw = last_row_width(R, table)
    P = round_size(R)
    r = torch.arange(R, dtype=torch.int64)
    out = {"level": torch.zeros((4, n), dtype=torch.int32),
           "order": torch.zeros((4, n), dtype=torch.int32),
           "depth": [], "rounds": [], "round_starts": []}
    for kt in range(4):
        col = idx[kt].cpu().to(torch.int64) - ((kt % 2) * R + r) * width
        slots = (r * tw + (col & (tw - 1))).tolist()
        last = [0] * (R * tw)
        lev = []
        for s in slots:
            lv = 1 + max(last[c] for c in s)
            for c in s:
                last[c] = lv
            lev.append(lv)
        level = torch.tensor(lev, dtype=torch.int32)
        counts = torch.bincount(level.to(torch.int64), minlength=1)[1:]
        starts = torch.cumsum(counts, 0) - counts
        rs = [int(b) + m * P for b, c in zip(starts.tolist(), counts.tolist())
              for m in range(-(-c // P))]
        out["level"][kt] = level
        out["order"][kt] = torch.sort(level, stable=True).indices.to(torch.int32)
        out["depth"].append(int(counts.numel()))
        out["rounds"].append(len(rs))
        out["round_starts"].append(torch.tensor(rs + [n], dtype=torch.int32))
    return out


def sketch_update_full(state: Dict, pkts: Dict[str, torch.Tensor],
                       schedule: Optional[Dict] = None
                       ) -> Tuple[Dict, torch.Tensor]:
    """All 80 features through the Count-Min sketch, state updated in place.

    ``state``: an ``init_state(..., state_backend="sketch")`` dict with at
    most ``LAST_TABLE`` rows; ``pkts``: ``to_torch`` packet tensors on the
    state's device.  Returns ``(state, feats (n, N_FEATURES))`` matching
    ``process_sketch``.  A ``schedule`` dict, if given, receives the
    kernel's schedule (:func:`schedule_views`) on the card.
    """
    device = state_device(state)
    if device.type == "cpu":
        return process_sketch(state, pkts)
    if device.type != "cuda":
        raise ValueError(f"sketch_update_full runs on cpu or cuda, not {device}")
    R, W = sketch_rows(state), sketch_width(state)
    if R > LAST_TABLE:
        raise ValueError(f"the sketch kernel takes at most {LAST_TABLE} rows "
                         f"(a stripe of its schedule's table each), got {R}")
    if 2 * 2 * R * W * 4 >= 2 ** 31:
        raise ValueError(f"rows={R}, width={W} overflow the int32 row indices")
    tab = flat_tables(state, SKETCH_TABLES)
    check_tables(tab, device)
    age = state["evict_age"]
    if age.device != device or age.dtype != torch.float32 or age.dim() != 0:
        raise ValueError("evict_age must be a 0-dim float32 tensor on "
                         f"{device}, got {age.dtype} {tuple(age.shape)} on "
                         f"{age.device}")
    if any(v.device != device for v in pkts.values()):
        raise ValueError(f"packet tensors must lie on the state's device {device}")
    ts = pkts["ts"].to(torch.float32).contiguous()
    lens = pkts["length"].to(torch.float32).contiguous()
    n = ts.shape[0]
    if ts.dim() != 1 or lens.shape != (n,) or 4 * n * R >= 2 ** 31:
        raise ValueError(f"ts/length must be (n,) with 4nR < 2^31, got "
                         f"{tuple(ts.shape)} and {tuple(lens.shape)}")
    feats = torch.empty((n, N_FEATURES), dtype=torch.float32, device=device)
    if n == 0:
        return state, feats
    idx, dirb = kernel_rows(pkts, R, W)
    scratch = torch.empty(scratch_size(n), dtype=torch.int32, device=device)
    SKETCH_UPDATE.launch(device, idx.data_ptr(), dirb.data_ptr(), ts.data_ptr(),
                         lens.data_ptr(), age.data_ptr(),
                         *(tab[k].data_ptr() for k in _TABLE_ORDER),
                         feats.data_ptr(), scratch.data_ptr(), n, R, W)
    if schedule is not None:
        schedule.update(schedule_views(scratch, n))
    return state, feats
