"""KitNET's MD stage on the card: the ensemble kernel ``csrc/kitnet_ae.cu``,
the scoring kernel ``csrc/kitnet_score.cu``, their wrappers and their plain
versions.

``kitnet_ensemble`` replaces the JAX package's Pallas TPU kernel
``repro/kernels/kitnet_ae.py::kitnet_ensemble`` (``_ae_kernel``): k small
autoencoders each reconstruct their feature subset, and the kernel returns
each one's masked reconstruction RMSE.  ``kitnet_score`` computes what the
JAX package runs as one jit around that kernel
(``repro/detection/md_backends.py::_score_pallas_jit``): normalise the
records, gather each AE's subset, the ensemble, normalise its RMSEs, the
output AE; one launch from (B, F) records to (B,) scores.

The TPU kernel runs two MXU matmuls per (AE, batch tile).  The AEs are far
too small for tensor cores (m <= 10 features, h = ceil(0.75 m) hidden), so
on the H100 the work is scalar FMAs in one of two designs
(``csrc/kitnet_ae.cu``), which its launcher chooses between by the batch
and the net's size.  *tile* (few records, or wide AEs): a block takes a
tile of records and every AE, stages the net and its tile into shared
memory with TMA bulk copies and cp.async, and runs each layer with a
thread per (record, AE, unit), the layers' values in shared memory
(``csrc/kitnet_ae.cuh``, which the scoring kernel shares).  *pair* (many
records of narrow AEs, or a record too large for a block): a thread runs
one (record, AE) pair's whole AE, in registers up to width 64 and with a
scratch row in global memory past it.  Both do a record's operations in
the same order, and every sum runs in a fixed order over one record's own
values, so each score is bitwise independent of its batch.  Every width
runs: the scoring kernel keeps a record's values in global memory where
they do not fit a block's shared memory.

For a CPU tensor each wrapper runs its plain PyTorch version
(:func:`kitnet_ensemble_ref`, :func:`kitnet_score_ref`); for a CUDA tensor
it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import INT, VOIDP, CudaKernel

KITNET_AE = CudaKernel("kitnet_ae.cu", "kitnet_ae_launch",
                       argtypes=[VOIDP] * 8 + [INT] * 5 + [VOIDP])
KITNET_SCORE = CudaKernel("kitnet_score.cu", "kitnet_score_launch",
                          argtypes=[VOIDP] * 17 + [INT] * 7 + [VOIDP])

SMEM_MAX = 232448    # shared memory a block may take (bytes)
REGISTER_WIDTH = 64  # the pair design's widest m in registers; a scratch past it
# kitnet_ensemble's designs, as the C entry numbers them: "auto" lets the
# launcher choose by the batch and the net's size
DESIGNS = {"auto": 0, "tile": 1, "pair": 2}
SCORE_SCRATCH_BLOCKS = 264   # blocks (2 a SM) when a record's values go to global memory


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, the kernels' formula.  Unlike
    ``torch.sigmoid``, whose CPU kernel rounds the vector tail differently,
    it gives each element the same bits whatever the batch."""
    return 1.0 / (1.0 + torch.exp(-x))


def _normalize(x, lo, hi):
    # benign training data lands in [0,1]; eval values may reach 4x so
    # flood-style feature explosions sit far off the learned manifold
    # (DESIGN.md §3)
    return torch.clamp((x - lo) / (hi - lo).clamp_min(1e-9), 0.0, 4.0)


def output_rmse(params, r_norm) -> torch.Tensor:
    """r_norm: (B, k) normalised ensemble RMSEs -> final score (B,)."""
    h = sigmoid((r_norm[..., None] * params["V1"][None]).sum(1)
                + params["c1"][None])
    y = sigmoid((h[..., None] * params["V2"][None]).sum(1) + params["c2"][None])
    return torch.sqrt(torch.mean((y - r_norm) ** 2, dim=-1))


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


def kitnet_score_ref(X, idx, mask, w1, b1, w2, b2, v1, c1, v2, c2,
                     norm_min, norm_max, out_min, out_max) -> torch.Tensor:
    """Plain PyTorch scoring: (B, F) records -> (B,) anomaly scores.
    Normalise, gather each AE's subset, the ensemble, normalise its RMSEs,
    the output AE; each step batch-independent bit for bit."""
    r = kitnet_ensemble_ref(_normalize(X, norm_min, norm_max)[:, idx],
                            w1, b1, w2, b2, mask)
    return output_rmse({"V1": v1, "c1": c1, "V2": v2, "c2": c2},
                       _normalize(r, out_min, out_max))


def _check(device: torch.device, tensors: dict) -> None:
    """Each ``name: (tensor, shape, dtype)`` contiguous, of its shape and
    dtype, on ``device``; raises ValueError otherwise."""
    for name, (t, shape, dtype) in tensors.items():
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _on_card(x: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return True


def _record_fits(floats_per_record: int) -> bool:
    """Whether one record's values (and the 16-byte mbarrier before them)
    fit in a block's shared memory."""
    return 16 + 4 * floats_per_record <= SMEM_MAX


def kitnet_ensemble(x_sub, w1, b1, w2, b2, mask, *, design: str = "auto") -> torch.Tensor:
    """x_sub (B, k, m) gathered, normalised feature subsets; w1 (k, m, h),
    b1 (k, h), w2 (k, h, m), b2 (k, m), mask (k, m).  Returns (B, k).

    ``design`` picks the card's kernel: "auto" (the launcher chooses by the
    batch and the net's size), or "tile" or "pair" forced, as the card tests
    and ``chip_smoke.py`` do to hold the two against each other; every
    design gives the same bits.  The plain version ignores it.
    """
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {sorted(DESIGNS)}, got {design!r}")
    if not _on_card(x_sub, "kitnet_ensemble"):
        return kitnet_ensemble_ref(x_sub, w1, b1, w2, b2, mask)
    B, k, m = x_sub.shape
    h = w1.shape[-1]
    f32 = torch.float32
    _check(x_sub.device, {"x_sub": (x_sub, (B, k, m), f32),
                          "w1": (w1, (k, m, h), f32), "b1": (b1, (k, h), f32),
                          "w2": (w2, (k, h, m), f32), "b2": (b2, (k, m), f32),
                          "mask": (mask, (k, m), f32)})
    out = torch.empty((B, k), dtype=f32, device=x_sub.device)
    if B == 0 or k == 0:
        return out
    if m == 0 or h == 0:
        raise ValueError(f"kitnet_ensemble needs m, h >= 1, got m={m}, h={h}")
    if design == "tile" and not _record_fits(k * (2 * m + h)):
        raise ValueError(f"kitnet_ensemble: the tile design holds a record's "
                         f"{4 * k * (2 * m + h)} bytes in shared memory, past "
                         f"a block's {SMEM_MAX - 16}")
    hid = (torch.empty((B, k, h), dtype=f32, device=x_sub.device)
           if m > REGISTER_WIDTH else None)
    KITNET_AE.launch(x_sub.device, x_sub.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                     w2.data_ptr(), b2.data_ptr(), mask.data_ptr(),
                     out.data_ptr(), None if hid is None else hid.data_ptr(),
                     B, k, m, h, DESIGNS[design])
    return out


def kitnet_score(X, idx, mask, w1, b1, w2, b2, v1, c1, v2, c2,
                 norm_min, norm_max, out_min, out_max) -> torch.Tensor:
    """X (B, F) float32 records; the net's idx (k, m) int64 feature indices
    in [0, F), mask (k, m), w1 (k, m, h), b1 (k, h), w2 (k, h, m), b2 (k, m),
    v1 (k, kh), c1 (kh,), v2 (kh, k), c2 (k,), norm_min/norm_max (F,),
    out_min/out_max (k,), float32 but idx.  Returns the (B,) scores."""
    args = (X, idx, mask, w1, b1, w2, b2, v1, c1, v2, c2, norm_min, norm_max,
            out_min, out_max)
    if not _on_card(X, "kitnet_score"):
        return kitnet_score_ref(*args)
    if X.dim() != 2 or idx.dim() != 2 or w1.dim() != 3 or v1.dim() != 2:
        raise ValueError("kitnet_score takes X (B, F), idx (k, m), w1 (k, m, h) "
                         "and v1 (k, kh)")
    B, F = X.shape
    k, m = idx.shape
    h, kh = w1.shape[-1], v1.shape[-1]
    f32 = torch.float32
    _check(X.device, {"X": (X, (B, F), f32), "idx": (idx, (k, m), torch.int64),
                      "mask": (mask, (k, m), f32), "w1": (w1, (k, m, h), f32),
                      "b1": (b1, (k, h), f32), "w2": (w2, (k, h, m), f32),
                      "b2": (b2, (k, m), f32), "v1": (v1, (k, kh), f32),
                      "c1": (c1, (kh,), f32), "v2": (v2, (kh, k), f32),
                      "c2": (c2, (k,), f32), "norm_min": (norm_min, (F,), f32),
                      "norm_max": (norm_max, (F,), f32),
                      "out_min": (out_min, (k,), f32),
                      "out_max": (out_max, (k,), f32)})
    if min(F, k, m, h, kh) == 0:
        raise ValueError(f"kitnet_score needs F, k, m, h, kh >= 1, got "
                         f"{(F, k, m, h, kh)}")
    out = torch.empty(B, dtype=f32, device=X.device)
    if B == 0:
        return out
    # a record's values: normalised X row, hidden units, squared errors,
    # RMSEs, output AE hidden row; in global memory where they do not fit
    # a block's shared memory
    rec = (F | 1) + k * (h + m + 1) + kh
    rows = 0 if _record_fits(rec) else min(B, SCORE_SCRATCH_BLOCKS)
    scratch = torch.empty(rows * rec, dtype=f32, device=X.device) if rows else None
    KITNET_SCORE.launch(X.device, *(t.data_ptr() for t in args), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), rows,
                        B, F, k, m, h, kh)
    return out
