"""Count-Min sketch FC: the CUDA kernel ``csrc/sketch_update.cu`` and its
wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/sketch_update.py::sketch_update_full`` (``_sketch_kernel``).

The TPU kernel walks every packet in one sequential grid with all sketch
tables in VMEM.  Colliding flows share cells across rows, so the dense FC
kernel's per-slot segments do not hold here; what does run in parallel is
the four key types (disjoint tables) and the four decays (elementwise).  The
kernel runs one warp per key type, lane ``r*4 + j`` holding row r and decay
j, and walks the packets in order; the Count-Min minimum and the argmin of
``sw`` are warp shuffles.  The wrapper hashes each packet's R row indices
per key type in torch ops first, as the TPU wrapper does.

What bounds it on the card: bytes, each touched cell read and written once
and 320 B of features a packet; in practice latency, one L2 round trip a
packet along each warp's chain.

For a CPU tensor the wrapper runs the plain PyTorch version,
``core.sketch.process_sketch``; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.pipeline import flat_tables
from repro_torch.core.sketch import (SKETCH_TABLES, process_sketch,
                                     sketch_flat_rows, sketch_rows,
                                     sketch_width)
from repro_torch.core.state import N_FEATURES, state_device
from repro_torch.kernels.build import INT, VOIDP, CudaKernel
from repro_torch.kernels.feature_update import check_tables

SKETCH_UPDATE = CudaKernel("sketch_update.cu", "sketch_update_launch",
                           argtypes=[VOIDP] * 18 + [INT, INT, VOIDP],
                           flags=("--fmad=false",))

MAX_ROWS = 8          # rows that fit one warp, four lanes a row
# the flat tables in the order sketch_update_launch takes them
_TABLE_ORDER = ("ult", "uw", "uls", "uss", "blt", "bw", "bls", "bss", "brl",
                "bsr", "bslt", "bsw")


def kernel_rows(pkts: Dict[str, torch.Tensor], rows: int,
                width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's index inputs: flat table rows, (4, n, R) int32 with key
    type major (uni rows, then bi SR rows), and the (n,) int32 dir bits."""
    fr = sketch_flat_rows(pkts, rows, width)
    idx = torch.cat([fr["urow"], fr["bbase"]], 1).permute(1, 0, 2)
    return idx.to(torch.int32).contiguous(), fr["dir"].to(torch.int32)


def sketch_update_full(state: Dict, pkts: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict, torch.Tensor]:
    """All 80 features through the Count-Min sketch, state updated in place.

    ``state``: an ``init_state(..., state_backend="sketch")`` dict with at
    most ``MAX_ROWS`` rows; ``pkts``: ``to_torch`` packet tensors on the
    state's device.  Returns ``(state, feats (n, N_FEATURES))`` matching
    ``process_sketch``.
    """
    device = state_device(state)
    if device.type == "cpu":
        return process_sketch(state, pkts)
    if device.type != "cuda":
        raise ValueError(f"sketch_update_full runs on cpu or cuda, not {device}")
    R, W = sketch_rows(state), sketch_width(state)
    if R > MAX_ROWS:
        raise ValueError(f"the sketch kernel takes at most {MAX_ROWS} rows, "
                         f"got {R}")
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
    stream = torch.cuda.current_stream(device).cuda_stream
    SKETCH_UPDATE.launch(idx.data_ptr(), dirb.data_ptr(), ts.data_ptr(),
                         lens.data_ptr(), age.data_ptr(),
                         *(tab[k].data_ptr() for k in _TABLE_ORDER),
                         feats.data_ptr(), n, R, stream)
    return state, feats
