"""Mamba-2 (SSD) block: the chunked parallel scan for prefill, the O(1)
state recurrence for decode.

A port of the JAX package's ``models/ssm.py``.  The SSD chunked algorithm
is an intra-chunk quadratic term (masked, from ``_segsum``) plus an
inter-chunk recurrence over a (heads, head_dim, state) carry; the products
are torch einsums (the JAX package computes them outside any Pallas
kernel), and JAX's ``lax.scan`` over chunks a Python loop.  A sequence is
padded to a whole number of chunks with ``dt = 0`` (an identity transition
with zero input).  ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the
model's dtype; the state math runs in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, normal_init

CONV_K = 4  # depthwise causal conv kernel width (mamba2 default)


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(1, d_inner // 64)
    return d_inner, nh, d_inner // nh


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ParameterDict:
    d = cfg.d_model
    d_inner, nh, _ = ssm_dims(cfg)
    ds = cfg.ssm_state
    conv_dim = d_inner + 2 * ds
    dev = gen.device

    def const(n, value, dt):
        return nn.Parameter(torch.full((n,), value, dtype=dt, device=dev),
                            requires_grad=False)

    return nn.ParameterDict({
        # in_proj -> [z, x, B, C, dt]
        "w_in": dense_init(gen, d, 2 * d_inner + 2 * ds + nh, dtype),
        "conv_w": normal_init(gen, (CONV_K, conv_dim), 0.2, dtype),
        "conv_b": const(conv_dim, 0.0, dtype),
        "A_log": const(nh, 0.0, torch.float32),          # A = -exp(A_log)
        "D": const(nh, 1.0, torch.float32),
        "dt_bias": const(nh, -2.0, torch.float32),       # softplus ~0.12
        "w_out": dense_init(gen, d_inner, d, dtype),
        "norm_g": const(d_inner, 0.0, dtype),            # gated RMSNorm gain
    })


def _split_proj(p, u: torch.Tensor, cfg: ArchConfig):
    d_inner, _, _ = ssm_dims(cfg)
    zxbcdt = u @ p["w_in"]
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * cfg.ssm_state,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * cfg.ssm_state],
                       dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel CONV_K. xbc: (B,S,C); state: (B,K-1,C).
    Returns silu(conv + b) and the last K-1 inputs (the next state)."""
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], CONV_K - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                      # (B, S+K-1, C)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(CONV_K))
    return F.silu(out + b[None, None, :]), xp[:, -(CONV_K - 1):, :]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j<k<=i} x_k below the diagonal, -inf above: a
    difference of cumulative sums, as the JAX package computes it."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, h0: Optional[torch.Tensor] = None):
    """SSD parallel form.

    x: (b, S, nh, p); dt: (b, S, nh); A: (nh,) negative; B, C: (b, S, ds).
    Returns y (b, S, nh, p) and the final state (b, nh, p, ds) in float32.
    """
    b, S, nh, p = x.shape
    ds = B.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")

    def r(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc, Bc, Cc = r(x), r(dt), r(B), r(C)
    dA = (dtc * A[None, None, None, :]).permute(0, 1, 3, 2)      # (b,nc,nh,Q)
    dA_cs = torch.cumsum(dA, dim=-1)

    # intra-chunk (quadratic, masked)
    L = torch.exp(_segsum(dA))                                    # (b,nc,nh,Q,Q)
    CB = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)                  # (b,nc,Q,Q)
    gates = L * CB[:, :, None, :, :]
    xdt = xc * dtc[..., None]                                     # (b,nc,Q,nh,p)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", gates, xdt)

    # chunk states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)             # (b,nc,nh,Q)
    states = torch.einsum("bcqs,bchq,bcqhp->bchps", Bc, decay_states, xdt)

    # inter-chunk recurrence: h_prevs[c] is the state entering chunk c
    chunk_decay = torch.exp(dA_cs[..., -1]).float()               # (b,nc,nh)
    h = torch.zeros((b, nh, p, ds), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c].float()
    h_prevs = torch.stack(h_prevs, dim=1)                         # (b,nc,nh,p,ds)

    # state -> output
    state_decay = torch.exp(dA_cs)                                # (b,nc,nh,Q)
    y_off = torch.einsum("bcqs,bchps,bchq->bcqhp", Cc, h_prevs.to(x.dtype),
                         state_decay.to(x.dtype))
    return (y_diag + y_off).reshape(b, S, nh, p), h


def _gated_rmsnorm(y, z, gain, eps):
    dt = y.dtype
    y = y.float() * F.silu(z.float())
    var = y.square().mean(-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * (1.0 + gain.float())).to(dt)


def mamba2_fwd(p, u: torch.Tensor, cfg: ArchConfig,
               state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward. u: (B, S, d); ``state`` an optional initial
    state.  Returns (out, {"ssm", "conv"})."""
    d_inner, nh, hp = ssm_dims(cfg)
    ds = cfg.ssm_state
    z, xbc, dt = _split_proj(p, u, cfg)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x, B, C = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    bsz, S, _ = x.shape
    x = x.reshape(bsz, S, nh, hp)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    h0 = None if state is None else state["ssm"]
    # pad S to a chunk multiple with dt=0 (identity transition, zero input)
    chunk = min(cfg.ssm_chunk, max(8, S)) if S < cfg.ssm_chunk else cfg.ssm_chunk
    Sp = -(-S // chunk) * chunk
    if Sp != S:
        x = F.pad(x, (0, 0, 0, 0, 0, Sp - S))
        dt = F.pad(dt, (0, 0, 0, Sp - S))
        B = F.pad(B, (0, 0, 0, Sp - S))
        C = F.pad(C, (0, 0, 0, Sp - S))
    y, h_last = ssd_chunked(x.float(), dt, A, B.float(), C.float(), chunk, h0)
    y, x = y[:, :S], x[:, :S]
    y = y + x.float() * p["D"][None, None, :, None]
    y = y.reshape(bsz, S, d_inner).to(u.dtype)
    y = _gated_rmsnorm(y, z, p["norm_g"], cfg.norm_eps)
    return y @ p["w_out"], {"ssm": h_last, "conv": new_conv}


def mamba2_decode(p, u: torch.Tensor, cfg: ArchConfig,
                  state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent step. u: (B, 1, d)."""
    d_inner, nh, hp = ssm_dims(cfg)
    ds = cfg.ssm_state
    z, xbc, dt = _split_proj(p, u, cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], state["conv"])
    x, B, C = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    bsz = x.shape[0]
    x = x.reshape(bsz, nh, hp).float()
    B_, C_ = B[:, 0].float(), C[:, 0].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                               # (B, nh)
    h = state["ssm"] * dA[..., None, None] + torch.einsum(
        "bhp,bs->bhps", x * dt[..., None], B_)
    y = torch.einsum("bhps,bs->bhp", h, C_) + x * p["D"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = _gated_rmsnorm(y, z, p["norm_g"], cfg.norm_eps)
    return y @ p["w_out"], {"ssm": h, "conv": new_conv}


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    d_inner, nh, hp = ssm_dims(cfg)
    return {
        "ssm": torch.zeros((batch, nh, hp, cfg.ssm_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * cfg.ssm_state),
                            dtype=torch.float32, device=device),
    }
