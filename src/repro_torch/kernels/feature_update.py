"""Exact 80-feature FC: the CUDA kernel ``csrc/fc_full.cu`` and its wrapper.

Replaces the JAX package's Pallas TPU kernel
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

For a CPU tensor the wrapper runs the plain PyTorch version,
``core.pipeline.process_serial``; for a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.pipeline import flat_tables, packet_rows, process_serial
from repro_torch.core.state import N_FEATURES, N_UNI, state_device, state_slots
from repro_torch.kernels.build import INT, VOIDP, CudaKernel

FC_FULL = CudaKernel("fc_full.cu", "fc_full_launch",
                     argtypes=[VOIDP] * 17 + [INT, INT, INT, VOIDP],
                     flags=("--fmad=false",))

_BLOCK = 256
# the flat tables in the order fc_full_launch takes them
_TABLE_ORDER = ("ult", "uw", "uls", "uss", "blt", "bw", "bls", "bss", "brl",
               "bsr", "bslt")


def _check_tables(tab: Dict[str, torch.Tensor], device) -> None:
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
    _check_tables(tab, device)
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
