"""Mamba-2 (SSD) block: the chunked parallel scan for prefill, the O(1)
state recurrence for decode.

A port of the JAX package's ``models/ssm.py``.  The SSD chunked algorithm
is an intra-chunk quadratic term (masked, from ``_segsum``) plus an
inter-chunk recurrence over a (heads, head_dim, state) carry; the products
are torch einsums (the JAX package computes them outside any Pallas
kernel), and JAX's ``lax.scan`` over chunks one more, its closed form (a
segment sum over the chunks' decays, as the Mamba2 reference's
``ssd_minimal``): a handful of kernels where a loop would launch two a
chunk.  A sequence is
padded to a whole number of chunks with ``dt = 0`` (an identity transition
with zero input).  ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the
model's dtype; the state math runs in float32.

Inside a placed step whose model axis binds ``ssm_inner`` (JAX's ``lshard(x,
"batch", "seq", "ssm_inner")`` at ``src/repro/models/ssm.py:141``), the
weights come as ``tensor_parallel.Pieces`` and each model place computes its
block of the d_inner channels (``split_regions``: its columns of ``w_in`` for
z and x, the dt of its heads; its rows of ``w_out``), the SSD on its heads or
its part of a head with B and C, which the first place computes once and
hands to the others, through ``tensor_parallel.channel_split``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel
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

    # inter-chunk recurrence, h = h * exp(dA_cs[-1]) + state a chunk, in
    # closed form: the state entering chunk z (z = nc: the final state) is
    # the initial state and each earlier chunk's, decayed by the chunk sums
    # between (a segment sum over chunks; one product, no loop)
    h = torch.zeros((b, nh, p, ds), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    last = F.pad(dA_cs[..., -1].transpose(1, 2).float(), (1, 0))   # (b,nh,nc+1)
    decay = torch.exp(_segsum(last))                              # (b,nh,nc+1,nc+1)
    entering = torch.einsum("bhzc,bchps->bzhps", decay,
                            torch.cat([h[:, None], states.float()], dim=1))
    h_prevs, h = entering[:, :nc], entering[:, nc]                # (b,nc,nh,p,ds)

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
    state.  Returns (out, {"ssm", "conv"}).  With ``p`` cut over the model
    places (``tensor_parallel.Pieces``) each place computes its channels
    (``_channels``, ``_channels_out``); the states come in its pieces
    (``tensor_parallel.Parts``)."""
    if isinstance(p["w_in"], tensor_parallel.Pieces):
        if state is not None:
            raise ValueError("the channel split runs from a zero state")
        out, (ssm, conv) = tensor_parallel.channel_split(
            functools.partial(_bc, cfg=cfg), functools.partial(_channels, cfg=cfg),
            functools.partial(_channels_out, cfg=cfg, dtype=u.dtype), p, u)
        return out, {"ssm": ssm, "conv": conv}
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
    chunk = _chunk(cfg, S)
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


def _chunk(cfg: ArchConfig, S: int) -> int:
    """The SSD's chunk for S positions; S is padded to a multiple of it
    with dt = 0 (an identity transition with zero input)."""
    return min(cfg.ssm_chunk, max(8, S)) if S < cfg.ssm_chunk else cfg.ssm_chunk


# ---------------------------------------------------------------------------
# the channels cut over the model places
# ---------------------------------------------------------------------------
_OWN_NDIM = {"w_in": 2, "conv_w": 2, "w_out": 2}    # the rest are vectors


def split_dims(shapes: Dict) -> Tuple[int, int, int]:
    """(d_inner, heads, state) of a Mamba2 weight dict from its shapes."""
    d_inner, nh = shapes["w_out"][-2], shapes["A_log"][-1]
    return d_inner, nh, (shapes["w_in"][-1] - 2 * d_inner - nh) // 2


def _block(dims, m: int, M: int) -> Tuple[int, int, int, int]:
    """Model place m's channels [c0, c1) of M blocks, and the heads [h0, h1)
    they fall in."""
    d_inner, nh, _ = dims
    hp, c = d_inner // nh, d_inner // M
    c0, c1 = m * c, (m + 1) * c
    return c0, c1, c0 // hp, -(-c1 // hp)


def split_regions(name: str, shape, dims, m: int, M: int) -> List[Tuple[slice, ...]]:
    """The regions of Mamba2 weight ``name`` (of ``shape``, the layers
    stacked on leading axes or not) that model place m of M reads where the
    d_inner channels are cut in M blocks: ``w_in``'s columns of z, x and dt
    (of its heads); ``conv_w``'s and ``conv_b``'s of x; its heads of
    ``A_log``, ``D``, ``dt_bias``; its channels of ``norm_g``; its rows of
    ``w_out``.  Place 0 also reads B and C's (``w_in``, ``conv_w``,
    ``conv_b``), for every place."""
    d_inner, _, ds = dims
    c0, c1, h0, h1 = _block(dims, m, M)
    lead = tuple(slice(0, n) for n in shape[:len(shape) - _OWN_NDIM.get(name, 1)])
    rows = (slice(0, shape[-2]),) if name in _OWN_NDIM else ()
    bc = [slice(d_inner, d_inner + 2 * ds)] if m == 0 else []
    cols = {"w_in": [slice(c0, c1), slice(d_inner + c0, d_inner + c1),
                     slice(2 * d_inner + 2 * ds + h0, 2 * d_inner + 2 * ds + h1)]
            + [slice(2 * d_inner, 2 * d_inner + 2 * ds)] * (m == 0),
            "conv_w": [slice(c0, c1)] + bc, "conv_b": [slice(c0, c1)] + bc,
            "norm_g": [slice(c0, c1)]}
    if name == "w_out":
        return [lead + (slice(c0, c1), slice(0, shape[-1]))]
    return [lead + rows + (c,) for c in cols.get(name, [slice(h0, h1)])]


def _segments(c0: int, c1: int, hp: int) -> List[Tuple[int, int, int, int]]:
    """The channels [c0, c1) as runs of the heads they fall in: (first
    head, end head, first channel in a head, end channel in a head), whole
    heads together, a head the cut divides alone."""
    out, c = [], c0
    while c < c1:
        h, lo = divmod(c, hp)
        if lo == 0 and c + hp <= c1:
            n = (c1 - c) // hp
            out.append((h, h + n, 0, hp))
            c += n * hp
        else:
            hi = min(hp, lo + c1 - c)
            out.append((h, h + 1, lo, hi))
            c += hi - lo
    return out


def _bc(w, u: torch.Tensor, cfg: ArchConfig):
    """B and C through their conv, from place 0's pieces (``w_in``'s and
    ``conv_w``'s, ``conv_b``'s last): (B and C (B, S, 2 * state), the
    states: none of ssm, B and C's of conv)."""
    d_inner, nh, hp = ssm_dims(cfg)
    ds = cfg.ssm_state
    bc, conv_bc = _causal_conv(u @ w["w_in"][-1], w["conv_w"][-1], w["conv_b"][-1])
    bsz = u.shape[0]
    region = (slice(0, bsz), slice(0, CONV_K - 1), slice(d_inner, d_inner + 2 * ds))
    return bc, [((bsz, nh, hp, ds), []), ((bsz, CONV_K - 1, d_inner + 2 * ds),
                                          [(region, conv_bc)])]


def _channels(w, u: torch.Tensor, bc: torch.Tensor, m: int, M: int, cfg: ArchConfig):
    """Model place m's channels of the mixer, up to the gated norm, with B
    and C (``bc``, from ``_bc``): (y * silu(z) in float32 (B, S,
    d_inner/M), its sum of squares (B, S, 1), the states in pieces: [(shape,
    [(region, tensor)])] for ssm and conv)."""
    d_inner, nh, hp = ssm_dims(cfg)
    ds = cfg.ssm_state
    c0, c1, h0, _ = _block((d_inner, nh, ds), m, M)
    w_z, w_x, w_dt = w["w_in"][:3]
    z = u @ w_z
    x, conv_x = _causal_conv(u @ w_x, w["conv_w"][0], w["conv_b"][0])
    B, C = torch.split(bc, [ds, ds], dim=-1)
    dt = F.softplus((u @ w_dt).float() + w["dt_bias"][0][None, None, :])
    A = -torch.exp(w["A_log"][0])
    bsz, S, _ = x.shape
    chunk = _chunk(cfg, S)
    Sp = -(-S // chunk) * chunk
    if Sp != S:
        x, dt = F.pad(x, (0, 0, 0, Sp - S)), F.pad(dt, (0, 0, 0, Sp - S))
        B, C = F.pad(B, (0, 0, 0, Sp - S)), F.pad(C, (0, 0, 0, Sp - S))
    ys, ssm, at = [], [], 0
    for ha, hb, pa, pb in _segments(c0, c1, hp):
        n = (hb - ha) * (pb - pa)
        xs = x[..., at:at + n].reshape(bsz, Sp, hb - ha, pb - pa)
        hs = slice(ha - h0, hb - h0)
        y, h_last = ssd_chunked(xs.float(), dt[..., hs], A[hs], B.float(), C.float(), chunk)
        y = y[:, :S] + xs[:, :S].float() * w["D"][0][hs][None, None, :, None]
        ys.append(y.reshape(bsz, S, n))
        ssm.append(((slice(0, bsz), slice(ha, hb), slice(pa, pb), slice(0, ds)), h_last))
        at += n
    y = (torch.cat(ys, -1) if len(ys) > 1 else ys[0]).to(u.dtype)
    g = y.float() * F.silu(z.float())
    conv = [((slice(0, bsz), slice(0, CONV_K - 1), slice(c0, c1)), conv_x)]
    return g, g.square().sum(-1, keepdim=True), [
        ((bsz, nh, hp, ds), ssm), ((bsz, CONV_K - 1, d_inner + 2 * ds), conv)]


def _channels_out(w, g: torch.Tensor, total: torch.Tensor, cfg: ArchConfig, dtype):
    """The gated RMSNorm of a place's channels from ``total``, the sum of
    squares over all d_inner, then its rows of ``w_out``: its partial
    output."""
    d_inner, _, _ = ssm_dims(cfg)
    y = g * torch.rsqrt(total / d_inner + cfg.norm_eps) * (1.0 + w["norm_g"][0].float())
    return y.to(dtype) @ w["w_out"][0]


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
