"""KitNET ensemble layer: the CUDA kernel ``csrc/kitnet_ae.cu`` and its
wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/kitnet_ae.py::kitnet_ensemble`` (``_ae_kernel``): k small
autoencoders each reconstruct their feature subset, and the kernel returns
each one's masked reconstruction RMSE.

The TPU kernel runs two MXU matmuls per (AE, batch tile).  The AEs are far
too small for tensor cores (m <= 10 features, h = ceil(0.75 m) hidden), so
on the H100 a block takes one AE and a tile of records, holds the AE's
weights in shared memory (in global memory past what fits), and gives each
thread one record, computed with scalar FMAs: in registers up to width 64
(``REGISTER_DIMS``), with the hidden vector in a scratch row past it, so
any m and h run.  What bounds it is bytes: the gathered (B, k, m)
input read once and the (B, k) output written once.  One thread per record
also makes every score bitwise independent of its batch.

For a CPU tensor the wrapper runs the plain PyTorch version
(:func:`kitnet_ensemble_ref`); for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import INT, VOIDP, CudaKernel

KITNET_AE = CudaKernel("kitnet_ae.cu", "kitnet_ae_launch",
                       argtypes=[VOIDP] * 8 + [INT] * 6 + [VOIDP])

REGISTER_DIMS = (16, 32, 64)   # widths whose kernel keeps a record in registers
BLOCK = 128           # records (threads) per block


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, the kernel's formula.  Unlike
    ``torch.sigmoid``, whose CPU kernel rounds the vector tail differently,
    it gives each element the same bits whatever the batch."""
    return 1.0 / (1.0 + torch.exp(-x))


def kitnet_ensemble_ref(x_sub, w1, b1, w2, b2, mask) -> torch.Tensor:
    """Plain PyTorch ensemble forward: (B, k, m) -> per-AE RMSE (B, k).

    The products are broadcast multiplies summed over one axis rather than
    ``einsum``, whose CPU path rounds differently at small batch sizes; so
    every record's score has the same bits whatever batch it arrives in.
    """
    xm = x_sub * mask[None]
    h = sigmoid((xm[..., None] * w1[None]).sum(2) + b1[None])
    y = sigmoid((h[..., None] * w2[None]).sum(2) + b2[None])
    se = ((y - xm) ** 2) * mask[None]
    denom = mask.sum(-1).clamp_min(1.0)
    return torch.sqrt(se.sum(-1) / denom[None])


def kitnet_ensemble(x_sub, w1, b1, w2, b2, mask) -> torch.Tensor:
    """x_sub (B, k, m) gathered, normalised feature subsets; w1 (k, m, h),
    b1 (k, h), w2 (k, h, m), b2 (k, m), mask (k, m).  Returns (B, k).
    """
    if x_sub.device.type == "cpu":
        return kitnet_ensemble_ref(x_sub, w1, b1, w2, b2, mask)
    if x_sub.device.type != "cuda":
        raise ValueError(f"kitnet_ensemble runs on cpu or cuda, not {x_sub.device}")
    B, k, m = x_sub.shape
    h = w1.shape[-1]
    shapes = {"x_sub": (x_sub, (B, k, m)), "w1": (w1, (k, m, h)),
              "b1": (b1, (k, h)), "w2": (w2, (k, h, m)), "b2": (b2, (k, m)),
              "mask": (mask, (k, m))}
    for name, (t, shape) in shapes.items():
        if (t.device != x_sub.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {x_sub.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if -(-B // BLOCK) > 65535:
        raise ValueError(f"B={B} records exceed the grid's "
                         f"{65535 * BLOCK}-record limit")
    out = torch.empty((B, k), dtype=torch.float32, device=x_sub.device)
    if B == 0 or k == 0:
        return out
    maxd = next((d for d in REGISTER_DIMS if max(m, h) <= d), 0)
    # past the register widths each (record, AE) keeps its hidden vector here
    hid = torch.empty(B * k * h if maxd == 0 else 0, dtype=torch.float32,
                      device=x_sub.device)
    stream = torch.cuda.current_stream(x_sub.device).cuda_stream
    KITNET_AE.launch(x_sub.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                     w2.data_ptr(), b2.data_ptr(), mask.data_ptr(),
                     out.data_ptr(), hid.data_ptr(), B, k, m, h, maxd, BLOCK,
                     stream)
    return out
