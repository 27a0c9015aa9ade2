"""Shared neural-net building blocks of the LM stack.

A port of the JAX package's ``models/layers.py``: plain tensor functions
over parameters held in ``nn.ParameterDict``s.  Weights are stored
``(d_in, d_out)`` as in the JAX package, so a projection is ``x @ w``.
Initialisers draw from an explicit ``torch.Generator`` with the JAX
package's distributions (not its numbers: the two generators differ).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, scale: float, dtype) -> nn.Parameter:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype), requires_grad=False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> nn.Parameter:
    """A (d_in, d_out) weight, N(0, 1) / sqrt(d_in) unless ``scale``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> nn.Parameter:
    """A (vocab, d) embedding, N(0, 0.02^2)."""
    return normal_init(gen, (vocab, d), 0.02, dtype)


def zeros_param(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms and nonlinearities
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the ``(1 + gain)`` scale."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + gain.float())).to(dt)


def layernorm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Layer norm in float32 (biased variance), ``gain`` and ``bias`` as
    given, back in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * gain.float() + bias.float()).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in float32, back in x's dtype; identity at 0.
    Without autograd, one temporary updated in place: at a long prompt the
    final logits are GiBs.  Under autograd tanh's output is saved for the
    backward, so the scale is a new tensor."""
    if cap <= 0.0:
        return x
    t = (x.float() / cap).tanh_()
    if torch.is_grad_enabled() and x.requires_grad:
        return (t * cap).to(x.dtype)
    return t.mul_(cap).to(x.dtype)


def act_fn(name: str):
    """"gelu" and "gelu_tanh" are the same function, the tanh
    approximation, as in the JAX package (whose gelu defaults to it)."""
    gelu_tanh = lambda x: F.gelu(x, approximate="tanh")  # noqa: E731
    return {"silu": F.silu, "gelu": gelu_tanh, "gelu_tanh": gelu_tanh}[name]


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (D/2,)
    ang = positions.float()[..., None] * freqs                     # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions: (B, S, 3)
    [temporal, height, width].  The D/2 frequency slots go to the three
    position streams in runs of ``sections`` (which sum to D/2); with equal
    t/h/w positions this is 1-D RoPE."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {D // 2}")
    freqs = rope_freqs(D, theta, x.device)                         # (D/2,)
    pos = positions.float()
    # each stream's position repeated over its run of slots (no index
    # tensor copied to the card)
    pos = torch.cat([pos[..., i:i + 1].expand(*pos.shape[:-1], n)
                     for i, n in enumerate(sections)], dim=-1)     # (B, S, D/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated, SwiGLU-style, or classic)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype,
             gated: bool = True) -> nn.ParameterDict:
    p = {"wi": dense_init(gen, d, d_ff, dtype)}
    if gated:
        p["wg"] = dense_init(gen, d, d_ff, dtype)
    p["wo"] = dense_init(gen, d_ff, d, dtype)
    return nn.ParameterDict(p)


def mlp_fwd(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """x: (B, S, d); gated when ``p`` holds "wg", classic otherwise."""
    h = x @ p["wi"]
    if "wg" in p:
        h = act_fn(act)(x @ p["wg"]) * h
    else:
        h = act_fn(act)(h)
    return h @ p["wo"]
