"""The dense transformer stack: parameters, full-sequence forward, one-token
decode and the LM loss.

A port of the dense family of the JAX package's ``models/transformer.py``.
Parameters live in an ``nn.Module`` (``Transformer``) with one ``Block`` per
layer in a ``ModuleList``; they are created without gradients (serving),
and ``requires_grad_(True)`` makes them trainable.  Training holds them as
the JAX package's tree instead (``params_tree``: every layer's weights
stacked on a leading L axis), so that statistics the JAX optimizer takes
over a stacked leaf stay global over the layers; ``forward`` and
``lm_loss`` take either form, and read a tree's layers as views of its
stacked leaves.
JAX's ``lax.scan`` over stacked layers becomes a Python loop whose body goes
through ``maybe_remat``, and each layer's attention window a Python int.

Public entry points (through ``registry.build_model``):
  * ``init_params``  — random parameters from a ``torch.Generator``
  * ``forward``      — full-sequence forward (prefill), returns
                       (logits, aux, cache-or-None)
  * ``decode_step``  — one token per sequence against a cache
  * ``init_cache``   — the KV cache for (batch, max_seq)
  * ``lm_loss``      — mean token cross-entropy, on the JAX package's
                       attention routing (never the flash kernel, which
                       has no backward)

The cache is ``{"k": (L,B,Smax,K,hd), "v": (L,B,Smax,K,hd), "pos": int}``.
``decode_step`` writes the new keys and values into it in place (the JAX
function returns a new cache) and returns it with ``pos`` advanced.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import DENSE, ArchConfig
from repro_torch.distributed.rematctx import maybe_remat
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, mlp_fwd,
                                       mlp_init, rmsnorm, softcap, zeros_param)

ATTN_ROUTES = (None, "plain", "flash")


class Block(nn.Module):
    """One layer: the two norm gains, attention and MLP weights."""

    def __init__(self, ln1: nn.Parameter, ln2: nn.Parameter,
                 attn_p: nn.ParameterDict, mlp_p: nn.ParameterDict):
        super().__init__()
        self.ln1, self.ln2 = ln1, ln2
        self.attn, self.mlp = attn_p, mlp_p


class Transformer(nn.Module):
    """The parameters of a dense LM: ``embed`` (V, d), ``final_norm`` (d,),
    ``lm_head`` (d, V) unless the embeddings are tied, and ``layers``."""

    def __init__(self, embed: nn.Parameter, final_norm: nn.Parameter,
                 layers: Sequence[Block], lm_head: Optional[nn.Parameter] = None):
        super().__init__()
        self.embed, self.final_norm = embed, final_norm
        self.lm_head = lm_head
        self.layers = nn.ModuleList(layers)


# ===========================================================================
# Init
# ===========================================================================
def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Transformer:
    """Random parameters on ``gen``'s device, with the JAX package's
    distributions (gains zero, so each norm starts as 1 * x)."""
    if cfg.family != DENSE:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    d, dev = cfg.d_model, gen.device
    embed = embed_init(gen, cfg.vocab, d, dtype)
    lm_head = None if cfg.tie_embeddings else dense_init(gen, d, cfg.vocab, dtype)
    layers = [Block(zeros_param(d, dtype, dev), zeros_param(d, dtype, dev),
                    attn.attn_init(gen, cfg, dtype),
                    mlp_init(gen, d, cfg.d_ff, dtype, cfg.gated_mlp))
              for _ in range(cfg.n_layers)]
    return Transformer(embed, zeros_param(d, dtype, dev), layers, lm_head)


def params_tree(p: Transformer) -> Dict:
    """The JAX package's parameter tree of ``p``: ``embed``, ``final_norm``,
    ``lm_head`` unless tied, and ``layers`` with every weight stacked on a
    leading L axis (copies; the rest share ``p``'s storage)."""
    lay = p.layers
    tree = {"embed": p.embed.detach(), "final_norm": p.final_norm.detach(),
            "layers": {
                "ln1": torch.stack([b.ln1.detach() for b in lay]),
                "ln2": torch.stack([b.ln2.detach() for b in lay]),
                "attn": {n: torch.stack([b.attn[n].detach() for b in lay])
                         for n in lay[0].attn},
                "mlp": {n: torch.stack([b.mlp[n].detach() for b in lay])
                        for n in lay[0].mlp}}}
    if p.lm_head is not None:
        tree["lm_head"] = p.lm_head.detach()
    return tree


def _as_params(p):
    """``p`` itself, or for the JAX package's tree (a dict) the same
    attributes with each layer's weights views of the stacked leaves
    (``unbind``: one stack in the backward, not one scatter a layer)."""
    if not isinstance(p, dict):
        return p
    lay = p["layers"]
    per = {g: {n: w.unbind(0) for n, w in lay[g].items()} for g in ("attn", "mlp")}
    layers = [SimpleNamespace(ln1=ln1, ln2=ln2,
                              attn={n: w[i] for n, w in per["attn"].items()},
                              mlp={n: w[i] for n, w in per["mlp"].items()})
              for i, (ln1, ln2) in enumerate(zip(lay["ln1"].unbind(0),
                                                 lay["ln2"].unbind(0)))]
    return SimpleNamespace(embed=p["embed"], final_norm=p["final_norm"],
                           lm_head=p.get("lm_head"), layers=layers)


# ===========================================================================
# Embedding / head
# ===========================================================================
def embed_in(p: Transformer, cfg: ArchConfig, batch: Dict) -> torch.Tensor:
    if "embeds" in batch:
        raise NotImplementedError("embedding inputs (audio/vlm frontends) are "
                                  "not ported")
    x = p.embed[batch["tokens"]]
    if cfg.embed_scale:
        # a device fill, not a host tensor copied over (which waits on the card)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def lm_head(p: Transformer, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, p.final_norm, cfg.norm_eps)
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return softcap(x @ w, cfg.final_softcap)


# ===========================================================================
# Attention stack
# ===========================================================================
def _per_layer_windows(cfg: ArchConfig):
    """Each layer's attention window (0 = full)."""
    if cfg.alt_local_global:
        return [cfg.window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


def _prefill_impl(x: torch.Tensor, positions: torch.Tensor, explicit: bool,
                  attn_impl: Optional[str]) -> str:
    """The attention path of one forward.  The flash kernel on the card, or
    wherever "flash" is asked for; its masks are those of positions
    arange(S) + c per row, checked once when the caller gave positions.
    Otherwise ("plain", or None on the CPU) the JAX package's routing by
    length."""
    if attn_impl not in ATTN_ROUTES:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_ROUTES}")
    if attn_impl == "flash" or (attn_impl is None and x.is_cuda):
        if explicit and not attn.is_prefill_positions(positions, positions):
            raise ValueError("prefill through the flash kernel masks positions "
                             "arange(S) + c per row; pass attn_impl='plain' "
                             "for others")
        return "flash"
    return "blockwise" if x.shape[1] >= attn.BLOCKWISE_THRESHOLD else "dense"


def _layer(x: torch.Tensor, lp, cfg: ArchConfig, positions: torch.Tensor,
           window: int, impl: str):
    """One layer over the full sequence. Returns (x, k, v)."""
    h = rmsnorm(x, lp.ln1, cfg.norm_eps)
    q, k, v = attn.qkv_proj(lp.attn, h, cfg, positions)
    o = attn.attention(q, k, v, cfg, positions, positions,
                       causal=cfg.causal, window=window, impl=impl)
    x = x + attn.attn_out(lp.attn, o)
    h2 = rmsnorm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_fwd(lp.mlp, h2, cfg.act), k, v


def _attn_stack_full(p: Transformer, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, impl: str, build_cache: bool,
                     max_seq: int = 0):
    """All layers over the full sequence. Returns (x, cache or None)."""
    B, S, _ = x.shape
    cache = None
    if build_cache:
        shape = (cfg.n_layers, B, max(max_seq, S), cfg.n_kv_heads, cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "pos": S}
    layer = maybe_remat(_layer)
    for i, (lp, window) in enumerate(zip(p.layers, _per_layer_windows(cfg))):
        x, k, v = layer(x, lp, cfg, positions, window, impl)
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    return x, cache


def _attn_stack_decode(p: Transformer, cfg: ArchConfig, x: torch.Tensor,
                       cache: Dict):
    """One token per sequence through all layers, against the cache."""
    pos = cache["pos"]
    B = x.shape[0]
    at = min(pos, cache["k"].shape[2] - 1)     # JAX clamps the update slice
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    cache_len = torch.full((B,), pos + 1, dtype=torch.long, device=x.device)
    for i, (lp, window) in enumerate(zip(p.layers, _per_layer_windows(cfg))):
        h = rmsnorm(x, lp.ln1, cfg.norm_eps)
        q, k, v = attn.qkv_proj(lp.attn, h, cfg, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, at] = k[:, 0].to(kc.dtype)
        vc[:, at] = v[:, 0].to(vc.dtype)
        o = attn.decode_attention(q, kc, vc, cfg, cache_len, window=window)
        x = x + attn.attn_out(lp.attn, o)
        h2 = rmsnorm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp_fwd(lp.mlp, h2, cfg.act)
    cache["pos"] = pos + 1
    return x, cache


# ===========================================================================
# Public API
# ===========================================================================
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


def default_positions(cfg: ArchConfig, batch: int, seq: int,
                      device=None) -> torch.Tensor:
    return torch.arange(seq, device=device)[None].expand(batch, seq)


def forward(params: Transformer, cfg: ArchConfig, batch: Dict,
            build_cache: bool = False, max_seq: int = 0,
            attn_impl: Optional[str] = None):
    """Full-sequence forward. Returns (logits, aux_loss, cache|None).

    ``attn_impl`` None runs the flash kernel on the card and the JAX
    package's routing (dense below 4096 tokens, blockwise from 4096) on the
    CPU; "plain" takes that routing on the card too; "flash" takes the
    kernel (its plain version on the CPU).  ``params`` is a ``Transformer``
    or the JAX package's tree.
    """
    params = _as_params(params)
    x = embed_in(params, cfg, batch)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    explicit = positions is not None
    if not explicit:
        positions = default_positions(cfg, B, S, x.device)
    impl = _prefill_impl(x, positions, explicit, attn_impl)
    x, cache = _attn_stack_full(params, cfg, x, positions, impl, build_cache,
                                max_seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_head(params, cfg, x), aux, cache


def decode_step(params: Transformer, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict):
    """tokens: (B, 1). Returns (logits (B, 1, V), cache)."""
    x = embed_in(params, cfg, {"tokens": tokens})
    x, cache = _attn_stack_decode(params, cfg, x, cache)
    return lm_head(params, cfg, x), cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE in fp32. logits (B,S,V), labels (B,S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def lm_loss(params, cfg: ArchConfig, batch: Dict, aux_weight: float = 0.01,
            attn_impl: Optional[str] = "plain"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"ce", "aux"}) of ``batch`` ({tokens, labels, mask?}).  The
    attention takes the JAX package's routing on every device (dense below
    4096 tokens, blockwise from 4096): the flash kernel has no backward."""
    logits, aux, _ = forward(params, cfg, batch, attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}
