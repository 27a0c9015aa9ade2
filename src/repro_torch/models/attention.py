"""Attention: GQA with RoPE or M-RoPE, sliding window and logit softcap.

A port of the JAX package's ``models/attention.py``.  Four paths share one
definition of the function:
  * ``dense_attention``     — materialises the (Sq, Sk) scores;
  * ``blockwise_attention`` — online softmax over KV blocks, for long
    sequences without O(S^2) memory;
  * the flash kernel (``kernels/flash_attention.py``) — every prefill on the
    card;
  * ``decode_attention``    — one query step against a KV cache (plain
    torch on every device, as the JAX package computes it outside any
    Pallas kernel).

``attention`` runs the prefill path it is given; the model's forward
(``transformer._prefill_impl``) picks it.  q heads are grouped as (K, G),
so the kv tensors are never repeated.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import rematctx, tensor_parallel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init, softcap

NEG_INF = -1e30
BLOCKWISE_THRESHOLD = 4096   # the blockwise path for S >= this (CPU routing)
KV_BLOCK = 1024


def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.hd
    return nn.ParameterDict({
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    })


def qkv_proj(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,K,hd), RoPE applied:
    M-RoPE on positions (B, S, 3) where the config asks for it, else 1-D
    RoPE on positions (B, S) (or on the first stream of (B, S, 3)).  The
    head counts are the weights' (a model place's share of them under the
    split)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(B, S, -1, hd)
    k = (x @ p["wk"]).reshape(B, S, -1, hd)
    v = (x @ p["wv"]).reshape(B, S, -1, hd)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        pos1d = positions if positions.dim() == 2 else positions[..., 0]
        q = apply_rope(q, pos1d, cfg.rope_theta)
        k = apply_rope(k, pos1d, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(…, Sq, Sk) additive bias; ``window`` 0 means full attention."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF)


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, d) -> (B, S, K, G, d)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def dense_attention(q, k, v, cfg: ArchConfig, q_pos, k_pos,
                    causal: Optional[bool] = None, window: Optional[int] = None):
    """Full-score attention. q: (B,Sq,H,d), k/v: (B,Sk,K,d) -> (B,Sq,H,d)."""
    causal = cfg.causal if causal is None else causal
    window = cfg.window if window is None else window
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = _grouped(q, K)                                   # (B,Sq,K,G,d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    bias = _mask_bias(q_pos, k_pos, causal, window)       # (B?,Sq,Sk)
    if bias.dim() == 2:
        bias = bias[None]
    scores = scores + bias[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def blockwise_attention(q, k, v, cfg: ArchConfig, q_pos, k_pos,
                        causal: Optional[bool] = None,
                        window: Optional[int] = None,
                        kv_block: int = KV_BLOCK):
    """Streaming softmax over KV blocks (O(Sq * kv_block) memory); the same
    float32 softmax as ``dense_attention``.  As JAX's ``jax.checkpoint`` of
    its loop, the forward leaves the backward only q, k, v and the
    positions, under every remat policy: the backward recomputes each
    block's scores, probabilities and ``p @ v`` (``rematctx.no_residuals``)."""
    causal = cfg.causal if causal is None else causal
    window = cfg.window if window is None else window

    def run(q, k, v, k_pos):
        B, Sq, H, hd = q.shape
        Sk, K = k.shape[1], k.shape[2]
        G = H // K
        nb = -(-Sk // kv_block)
        pad = nb * kv_block - Sk
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2 ** 30)
        qg = _grouped(q, K)                               # (B,Sq,K,G,d)
        scale = 1.0 / math.sqrt(hd)
        m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32, device=q.device)
        for i in range(nb):
            blk = slice(i * kv_block, (i + 1) * kv_block)
            kblk, vblk, pblk = k[:, blk], v[:, blk], k_pos[:, blk]
            s = torch.einsum("bskgd,btkd->bkgst", qg.float(), kblk.float()) * scale
            s = softcap(s, cfg.attn_softcap)
            s = s + _mask_bias(q_pos, pblk, causal, window)[:, None, None, :, :]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(v.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)

    return rematctx.no_residuals(run, q, k, v, k_pos)


def is_prefill_positions(q_pos: torch.Tensor, k_pos: torch.Tensor) -> bool:
    """Whether ``q_pos`` and ``k_pos`` are equal and each row is ``arange(S)
    + c`` for a constant ``c`` of that row (one device sync).  The masks sit
    on position differences (``_mask_bias``), so these positions give the
    flash kernel's masks, which sit on indices."""
    S = q_pos.shape[-1]
    if k_pos.shape[-1] != S:
        return False
    ar = torch.arange(S, device=q_pos.device)
    return bool(((q_pos - q_pos[..., :1]) == ar).all() & (q_pos == k_pos).all())


def flash_prefill(q, k, v, cfg: ArchConfig, causal: Optional[bool] = None,
                  window: Optional[int] = None):
    """Prefill attention through the flash kernel (its plain version for
    CPU tensors), on positions ``arange(S) + c`` per row (the masks of
    ``arange(S)``): q (B,S,H,d), k/v (B,S,K,d)."""
    causal = cfg.causal if causal is None else causal
    window = cfg.window if window is None else window
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=int(window),
                        softcap=cfg.attn_softcap)
    return o.transpose(1, 2)


def attention(q, k, v, cfg: ArchConfig, q_pos, k_pos,
              causal: Optional[bool] = None, window: Optional[int] = None, *,
              impl: str):
    """Prefill attention through ``impl``: "flash" (the kernel; the caller
    vouches that the positions are ``arange(S) + c`` per row), "dense" or
    "blockwise"."""
    if impl == "flash":
        return flash_prefill(q, k, v, cfg, causal, window)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, cfg, q_pos, k_pos, causal, window)
    if impl == "dense":
        return dense_attention(q, k, v, cfg, q_pos, k_pos, causal, window)
    raise ValueError(f"unknown attention impl {impl!r}; one of flash, dense, "
                     "blockwise")


def decode_attention(q, k_cache, v_cache, cfg: ArchConfig,
                     cache_len: torch.Tensor, window: Optional[int] = None):
    """Single-step decode. q: (B,1,H,d); caches: (B,Smax,K,d); cache_len:
    (B,).  Masks cache positions >= cache_len, and those before
    cache_len - window.  Caches cut along their positions over places
    (``tensor_parallel.SeqCache``) attend by the partial-softmax combine."""
    window = cfg.window if window is None else window
    if isinstance(k_cache, tensor_parallel.SeqCache):
        return tensor_parallel.seq_attend(q, k_cache, v_cache, cfg, cache_len, window)
    B, _, H, hd = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    qg = _grouped(q, K).float()[:, 0]                      # (B,K,G,d)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) / math.sqrt(hd)
    s = softcap(s, cfg.attn_softcap)
    t = torch.arange(Smax, device=q.device)[None, :]
    ok = t < cache_len[:, None]
    if window > 0:
        ok &= t >= (cache_len[:, None] - window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["wo"]


def self_attention(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                   attend, *extra):
    """``qkv_proj`` -> ``attend(q, k, v, positions, *extra)`` -> ``attn_out``:
    (the output, (k, v)).  With ``p`` cut by heads over the model places
    (``tensor_parallel.Blocks``), each place runs it on its own heads (and
    its pieces of any ``Blocks`` in ``extra``: its cache), the partial
    outputs summed at home and (k, v) returned as each place's; with a
    cache cut along its positions (``tensor_parallel.SeqCache``) it runs
    once at home, its products split over the places.  One body either
    way."""
    def body(p, x, positions, *extra):
        q, k, v = qkv_proj(p, x, cfg, positions)
        kq, vq = tensor_parallel.kv_for_heads(k, v, q.shape[2], cfg)
        return attn_out(p, attend(q, kq, vq, positions, *extra)), k, v

    if any(isinstance(e, tensor_parallel.SeqCache) for e in extra):
        out, k, v = body(p, x, positions, *extra)
    else:
        out, k, v = tensor_parallel.row_parallel(body, p, x, positions, *extra)
    return out, (k, v)
