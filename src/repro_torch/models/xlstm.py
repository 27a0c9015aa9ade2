"""xLSTM blocks (arXiv:2405.04517): the mLSTM (matrix memory, exponential
gating) and the sLSTM (scalar memory, exponential gating with a
stabiliser).

A port of the JAX package's ``models/xlstm.py``.  The mLSTM runs in a
chunkwise form: an intra-chunk quadratic term plus an inter-chunk (C, n, m)
recurrence, a Python loop over chunks (JAX's ``lax.scan``).  The sLSTM is a
true sequential recurrence (its recurrent matrix R makes it
non-associative): a Python loop over time.  Gates and stabilisers run in
float32, and ``w_if``/``b_if`` (mLSTM) and ``w_gates``/``r_gates``/
``b_gates`` (sLSTM) are float32 whatever the model's dtype; a training
step's compute-dtype copy casts them down, and the gate products promote
them back to float32, as JAX's einsums do.  The
stabiliser starts at m = -1e30, and a sequence padded to whole chunks gets
log_i = -1e30 (no input) and log_f = 0 (no decay) there.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, normal_init

M_INIT = -1e30


def _const(shape, value, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // cfg.n_heads


def mlstm_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ParameterDict:
    d = cfg.d_model
    d_inner, _ = mlstm_dims(cfg)
    H = cfg.n_heads
    b_if = torch.cat([torch.zeros(H), torch.full((H,), 3.0)]).to(gen.device)
    return nn.ParameterDict({
        "w_up": dense_init(gen, d, 2 * d_inner, dtype),           # [u, z-gate]
        "wq": dense_init(gen, d_inner, d_inner, dtype),
        "wk": dense_init(gen, d_inner, d_inner, dtype),
        "wv": dense_init(gen, d_inner, d_inner, dtype),
        "w_if": dense_init(gen, d_inner, 2 * H, torch.float32),
        "b_if": nn.Parameter(b_if, requires_grad=False),
        "norm_g": _const((d_inner,), 0.0, dtype, gen.device),
        "w_down": dense_init(gen, d_inner, d, dtype),
    })


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    _, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), M_INIT, **f32)}


def _mlstm_gates(p, u: torch.Tensor):
    """u: (B, S, d_inner) -> log_i, log_f each (B, S, H), float32."""
    raw = u.float() @ p["w_if"].float() + p["b_if"]
    i_raw, f_raw = raw.chunk(2, dim=-1)
    return i_raw, -F.softplus(-f_raw)          # exponential input gate, log sigmoid


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, S, E = x.shape
    return x.reshape(B, S, H, E // H).transpose(1, 2)             # (B,H,S,dh)


def mlstm_cell_chunked(q, k, v, log_i, log_f, state: Dict, chunk: int):
    """Chunkwise stabilised mLSTM.

    q, k, v: (B,H,S,dh) float32; log_i/log_f: (B,S,H) float32.
    Returns h (B,H,S,dh) and the final state {C, n, m}.
    """
    B, H, S, dh = q.shape
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    scale = 1.0 / math.sqrt(dh)
    li = log_i.permute(0, 2, 1).reshape(B, H, nc, chunk)
    lf = log_f.permute(0, 2, 1).reshape(B, H, nc, chunk)

    def rc(t):
        return t.reshape(B, H, nc, chunk, dh)

    qc, kc, vc = rc(q), rc(k), rc(v)
    Fc = torch.cumsum(lf, dim=-1)                   # inclusive cumsum of log f
    Ftot = Fc[..., -1]                              # (B,H,nc)
    # intra-chunk log decay matrix: D[i,j] = F_i - F_j + li_j  (j <= i)
    Dm = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    Dm = Dm.masked_fill(~tri, float("-inf"))        # (B,H,nc,Q,Q)
    a_intra = Dm.amax(-1)                           # (B,H,nc,Q)

    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c in range(nc):
        qi, ki, vi = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        Fi, Fti, Di, ai, lii = Fc[:, :, c], Ftot[:, :, c], Dm[:, :, c], \
            a_intra[:, :, c], li[:, :, c]
        qs = qi * scale
        # stabiliser per position: m_i = max(F_i + m_prev, max_j<=i D_ij)
        m_pos = torch.maximum(Fi + m[..., None], ai)              # (B,H,Q)
        inter_w = torch.exp(Fi + m[..., None] - m_pos)            # (B,H,Q)
        intra_w = torch.exp(Di - m_pos[..., None])                # (B,H,Q,Q)
        s = torch.einsum("bhqd,bhkd->bhqk", qs, ki)
        h_num = (torch.einsum("bhqk,bhkd->bhqd", s * intra_w, vi)
                 + torch.einsum("bhqd,bhde->bhqe", qs, C) * inter_w[..., None])
        # normaliser: n_i = sum_j<=i exp(D_ij - m_i) k_j + the carry's part
        n_vec = (torch.einsum("bhqk,bhkd->bhqd", intra_w, ki)
                 + n[:, :, None, :] * inter_w[..., None])
        denom = torch.maximum(torch.einsum("bhqd,bhqd->bhq", qs, n_vec).abs(),
                              torch.exp(-m_pos))
        hs.append(h_num / denom[..., None])
        # chunk-end state update
        a_end = (Fti[..., None] - Fi + lii).amax(-1)              # (B,H)
        m_end = torch.maximum(Fti + m, a_end)
        carry_w = torch.exp(Fti + m - m_end)                      # (B,H)
        in_w = torch.exp(Fti[..., None] - Fi + lii - m_end[..., None])  # (B,H,Q)
        C = (C * carry_w[..., None, None]
             + torch.einsum("bhkd,bhke,bhk->bhde", ki, vi, in_w))
        n = n * carry_w[..., None] + torch.einsum("bhkd,bhk->bhd", ki, in_w)
        m = m_end
    h = torch.stack(hs, dim=2).reshape(B, H, S, dh)
    return h, {"C": C, "n": n, "m": m}


def _rms(x, gain, eps):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * (1.0 + gain.float())


def mlstm_fwd(p, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (out, state)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    d_inner, _ = mlstm_dims(cfg)
    u, z = (x @ p["w_up"]).chunk(2, dim=-1)
    q = _heads(u @ p["wq"], H).float()
    k = _heads(u @ p["wk"], H).float()
    v = _heads(u @ p["wv"], H).float()
    log_i, log_f = _mlstm_gates(p, u)
    st = state or mlstm_init_state(cfg, B, x.device)
    chunk = min(cfg.ssm_chunk or 128, S)
    # pad S to a chunk multiple: log_i=-1e30 (no input), log_f=0 (no decay)
    Sp = -(-S // chunk) * chunk
    if Sp != S:
        q, k, v = (F.pad(t, (0, 0, 0, Sp - S)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, Sp - S), value=M_INIT)
        log_f = F.pad(log_f, (0, 0, 0, Sp - S))
    h, new_state = mlstm_cell_chunked(q, k, v, log_i, log_f, st, chunk)
    h = h[:, :, :S].transpose(1, 2).reshape(B, S, d_inner)
    h = _rms(h, p["norm_g"], cfg.norm_eps) * F.silu(z.float())
    return h.to(x.dtype) @ p["w_down"], new_state


def mlstm_decode(p, x: torch.Tensor, cfg: ArchConfig,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-step recurrent mLSTM. x: (B, 1, d).  Its three parts: the
    projections (``mlstm_decode_in``), the state's update from them
    (``mlstm_decode_state``, which reads no weight: a placed decode runs it
    on every place that holds the state) and the output
    (``mlstm_decode_out``)."""
    ins, z = mlstm_decode_in(p, x, cfg)
    h, new_state = mlstm_decode_state(None, ins, cfg, state)
    return mlstm_decode_out(p, h, z, x.dtype, cfg), new_state


def mlstm_decode_in(p, x: torch.Tensor, cfg: ArchConfig):
    """(q, k, v (B, H, dh) in float32, log_i, log_f (B, H)), z."""
    H = cfg.n_heads
    u, z = (x @ p["w_up"]).chunk(2, dim=-1)
    q = _heads(u @ p["wq"], H)[:, :, 0].float()
    k = _heads(u @ p["wk"], H)[:, :, 0].float()
    v = _heads(u @ p["wv"], H)[:, :, 0].float()
    log_i, log_f = _mlstm_gates(p, u)
    return (q, k, v, log_i[:, 0], log_f[:, 0]), z


def mlstm_decode_state(p, ins, cfg: ArchConfig, state: Dict) -> Tuple[torch.Tensor, Dict]:
    """(h (B, 1, d_inner), the new state) from ``mlstm_decode_in``'s
    projections; ``p`` is not read."""
    q, k, v, li, lf = ins
    B = q.shape[0]
    d_inner, dh = mlstm_dims(cfg)
    scale = 1.0 / math.sqrt(dh)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)[..., None]
    iw = torch.exp(li - m_new)[..., None]
    C = C * fw[..., None] + torch.einsum("bhd,bhe->bhde", k, v) * iw[..., None]
    n = n * fw + k * iw
    num = torch.einsum("bhd,bhde->bhe", q, C) * scale
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs() * scale,
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, d_inner)
    return h, {"C": C, "n": n, "m": m_new}


def mlstm_decode_out(p, h: torch.Tensor, z: torch.Tensor, dtype, cfg: ArchConfig):
    h = _rms(h, p["norm_g"], cfg.norm_eps) * F.silu(z.float())
    return h.to(dtype) @ p["w_down"]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ParameterDict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    d_ff = int(4 * d * 4 / 3 / 2) * 2
    return nn.ParameterDict({
        "w_gates": dense_init(gen, d, 4 * d, torch.float32),      # i,f,z,o
        "r_gates": normal_init(gen, (H, dh, 4 * dh), dh ** -0.5, torch.float32),
        "b_gates": _const((4 * d,), 0.0, torch.float32, gen.device),
        "norm_g": _const((d,), 0.0, dtype, gen.device),
        "w_ff1": dense_init(gen, d, 2 * d_ff, dtype),
        "w_ff2": dense_init(gen, d_ff, d, dtype),
    })


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.full((batch, d), 1e-6, **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M_INIT, **f32)}


def _slstm_step(p, H: int, carry, wx_t):
    """wx_t: (B, 4d), the input projection at step t.  The recurrent term
    is reshaped to (B, 4d) before the split into i, f, z, o, so the four
    gates interleave per head, as in the JAX package."""
    c, n, h, m = carry
    B, d = c.shape
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, d // H),
                       p["r_gates"].float()).reshape(B, 4 * d)
    i_raw, f_raw, z_raw, o_raw = (wx_t + rec + p["b_gates"]).chunk(4, dim=-1)
    log_f = -F.softplus(-f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    iw = torch.exp(i_raw - m_new)
    fw = torch.exp(log_f + m - m_new)
    c_new = fw * c + iw * torch.tanh(z_raw)
    n_new = fw * n + iw
    # maximum, not clamp_min: at a tie it splits the gradient, as JAX does
    h_new = torch.sigmoid(o_raw) * c_new / torch.maximum(n_new, n_new.new_full((), 1e-6))
    return c_new, n_new, h_new, m_new


def slstm_fwd(p, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d).  A Python loop over time."""
    B, S, _ = x.shape
    H = cfg.n_heads
    st = state or slstm_init_state(cfg, B, x.device)
    wx = x.float() @ p["w_gates"].float()
    carry = (st["c"], st["n"], st["h"], st["m"])
    hs = []
    for t in range(S):
        carry = _slstm_step(p, H, carry, wx[:, t])
        hs.append(carry[2])
    h = _rms(torch.stack(hs, dim=1), p["norm_g"], cfg.norm_eps).to(x.dtype)
    # gated FFN (pf = 4/3); "gelu" is the tanh approximation, as in JAX
    a, b = (h @ p["w_ff1"]).chunk(2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * b) @ p["w_ff2"]
    return out, dict(zip(("c", "n", "h", "m"), carry))


def slstm_decode(p, x: torch.Tensor, cfg: ArchConfig,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    return slstm_fwd(p, x, cfg, state)
