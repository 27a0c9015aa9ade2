"""Flash attention (forward): the CUDA kernel ``csrc/flash_attention.cu``,
its wrapper and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` (``_attn_kernel``):
softmax attention with scale 1/sqrt(D), an optional tanh logit softcap, a
causal and a sliding-window mask on absolute positions from 0 (top-left
aligned when Sq != Sk), and GQA (query head h reads kv head h // (H / K)).
The softmax runs in float32; the output is in q's dtype (float32 or
bfloat16).  The kernel is built for D in {32, 64, 128, 256}; any other D up
to 256 is zero-padded to the next of them (80 and 112 to 128, 48 to 64),
which adds exact zeros to every dot product, with the scale kept at
1/sqrt of the true D, and the output sliced back.

What bounds it on the H100 is operations, 4*D a visible (query, key) pair
and head: at the bf16 tensor rate for bf16 inputs, and for float32 inputs
at the rate of the arithmetic the kernel uses, split TF32 (three TF32
tensor-core products per float32 product, 495/3 TFLOP/s).

The TPU kernel walks the kv blocks of one (head, q block) in a sequential
grid axis, carrying max, denominator and accumulator in VMEM.  On the H100
a block of two warpgroups takes a (batch, head, 128-row q tile), 16 rows a
warp; TMA loads the q tile once and K/V tiles into a ring of shared memory
that the block refills as it frees each stage, so loads overlap the
products of the tiles before them.  bf16: both products on ``wgmma``
(S = Q K^T with Q and K from shared memory; O += P V with P from
registers), P split into bf16 P_hi + P_lo so that P V keeps float32
accuracy.  float32: split TF32, each operand as hi + lo parts and three
tensor-core products for one: S on ``wgmma`` (Q split in registers, K's lo
part staged in shared memory), P V on ``mma.sync``.  The tensor cores take bf16
or TF32 operands while the tolerances are those of float32 arithmetic:
hence the split.  Shared memory per (dtype, D) is 24-224 KiB and registers
at most 255 a thread; the source's header gives each budget.

The kernel reads q, k, v and writes the output through their strides (the
last dimension contiguous, strides of whole 16-byte units, 16-byte aligned
pointers, as TMA takes them), so the model's (B, S, H, D) projections go
in as transposed views without a copy.

For CPU tensors the wrapper runs :func:`flash_attention_ref`; for CUDA
tensors it launches the kernel or raises.  The launch is the custom op
``torch.ops.repro_torch.flash_attention`` (registered here; nothing is
built at import), whose fake version gives the output's shape on the meta
device without an S x S score tensor, and whose FLOP formula (4 B H Sq Sk
D, ``torch.utils.flop_counter``'s for attention) the dry run counts: so
the meta dry run takes the card's route.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import INT, VOIDP, CudaKernel

I64 = ctypes.c_int64
FLASH_ATTENTION = CudaKernel(
    "flash_attention.cu", "flash_attention_launch",
    argtypes=[VOIDP] * 4 + [INT] * 7 + [I64] * 12
    + [INT, INT, ctypes.c_float, INT, VOIDP])

HEAD_DIMS = (32, 64, 128, 256)      # head_dim values the kernel is built for
NEG_INF = -1e30                     # masked score: finite, as in the TPU kernel


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, K, Sk, D).  Full-score float32 softmax
    attention (the JAX package's ``kernels/ref.flash_attention_ref``)."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Sq, D).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, K, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B and D, H a multiple of K)")
    if k.shape[2] == 0:
        raise ValueError("flash_attention needs at least one key")


def built_head_dim(D: int) -> int:
    """The head dim the kernel runs a head of D at: D itself if built, else
    the next built one (zero padding); raises past the largest."""
    for built in HEAD_DIMS:
        if D <= built:
            return built
    raise ValueError(f"head_dim {D} exceeds the largest the kernel is built "
                     f"for, {HEAD_DIMS[-1]}")


def _pad_head_dim(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """``t`` zero-padded along its last dimension to ``Dp``, laid out in
    memory with its dimensions in the order of t's strides."""
    order = sorted(range(3), key=lambda d: -t.stride(d)) + [3]
    shape = [t.shape[d] for d in order[:3]] + [Dp]
    out = t.new_zeros(shape).permute(*[order.index(d) for d in range(4)])
    out[..., :t.shape[3]] = t
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int, softcap: float, head_dim: int) -> torch.Tensor:
    """The kernel on q (B, H, Sq, Dp), k/v (B, K, Sk, Dp) at a built head
    dim Dp (``head_dim`` the true D, for the scale): (B, H, Sq, Dp), laid
    out in memory as q is."""
    B, H, Sq, Dp = q.shape
    K, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        step = 16 // t.element_size()        # TMA: 16-byte strides
        if (t.stride(3) != 1 or any(s % step or s <= 0 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have a contiguous last dimension, "
                             f"positive strides that are multiples of {step} "
                             f"elements (16 bytes) and 16-byte alignment, got "
                             f"strides {t.stride()}")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the grid's 65535")
    if Sq == 0:
        return out
    FLASH_ATTENTION.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, K, Sq, Sk, Dp, head_dim,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), float(softcap),
        int(q.dtype == torch.bfloat16))
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, softcap, head_dim):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """4 B H Sq Sk D at the true head dim (the args' last), as the flop
    counter counts attention: the mask's skipped pairs are not subtracted."""
    B, H, Sq, _ = q_shape
    head_dim = args[-1]
    return 4 * B * H * Sq * k_shape[2] * head_dim


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, K, Sk, D) with H a multiple of K.

    Returns (B, H, Sq, D) in q.dtype, laid out in memory as q is (at a
    padded head dim, as a view of the padded output's first D columns).
    On the card, raises when autograd would need its gradient: the kernel
    has no backward.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the flash kernel has no backward (nor has the JAX "
                         "package's flash_attention): its output would carry no "
                         "gradient; train through attn_impl='plain' (lm_loss's "
                         "default)")
    D = q.shape[3]
    Dp = built_head_dim(D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or t.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"{name} must be float32 or bfloat16 on {q.device} "
                             f"like q, got {t.dtype} on {t.device}")
    if Dp != D:
        q, k, v = (_pad_head_dim(t, Dp) for t in (q, k, v))
    out = torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), int(window),
                                                float(softcap), D)
    return out[..., :D]
