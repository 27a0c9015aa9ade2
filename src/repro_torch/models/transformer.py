"""The model stacks of every family: parameters, full-sequence forward,
one-token decode and the LM loss.

A port of the JAX package's ``models/transformer.py``.  Parameters live in
an ``nn.Module`` (``Transformer``) with one ``Block`` per layer in a
``ModuleList``; they are created without gradients (serving), and
``requires_grad_(True)`` makes them trainable.  The stacks:
  * dense, moe, vlm and audio: attention then an MLP or the MoE FFN in each
    layer (M-RoPE for the vlm, embedding inputs and no causal mask for the
    audio encoder, which has no decode step);
  * hybrid (Zamba2): Mamba2 layers, and after every ``attn_every``-th one
    shared attention + MLP block (JAX's ``lax.cond`` on the layer's flag is
    a Python ``if`` on its index);
  * ssm (xLSTM): a list of mLSTM and sLSTM blocks.
Training holds a model of any family as the JAX package's tree instead
(``params_tree``: every layer's weights stacked on a leading L axis, the
xLSTM's blocks a list), so that statistics the JAX optimizer takes over a
stacked leaf stay global over the layers; ``forward`` and ``lm_loss`` take
either form, and read a tree's layers as views of its stacked leaves.
JAX's ``lax.scan`` over stacked layers becomes a Python loop (each layer's
body through ``maybe_remat`` in the attention and hybrid stacks, as JAX
remats its scan bodies; the xLSTM blocks, which JAX unrolls, without), and
each layer's attention window a Python int.

Public entry points (through ``registry.build_model``):
  * ``init_params``  — random parameters from a ``torch.Generator``
  * ``forward``      — full-sequence forward (prefill), returns
                       (logits, aux, cache-or-None)
  * ``decode_step``  — one token per sequence against a cache
  * ``init_cache``   — the decode cache for (batch, max_seq)
  * ``lm_loss``      — mean token cross-entropy plus ``aux_weight`` times
                       the MoE aux loss, on the JAX package's attention
                       routing (never the flash kernel, which has no
                       backward)

The caches: ``{"k", "v": (L,B,Smax,K,hd), "pos": int}`` (attention
families); ``{"attn_k", "attn_v": (apps,B,Smax,K,hd), "ssm": (L,B,nh,hp,ds),
"conv": (L,B,3,conv_dim), "pos"}`` (hybrid, the states in float32);
``{"states": [per block {C, n, m} or {c, n, h, m}], "pos"}`` (xLSTM).
``decode_step`` updates the cache in place (the JAX function returns a new
cache) and returns it with ``pos`` advanced.

Inside a placed step the same functions take one data replica's view of the
placed parameters, whose weights cut over the model axis are
``distributed/tensor_parallel.Blocks``: the hooks there (the attention and
MLP bodies, the embedding, the head, the cross-entropy, the caches) split
the compute over the model places.  A stacked weight that FSDP cuts comes
as ``tensor_parallel.Gathered``, assembled in each layer's body
(``tensor_parallel.assembled``), one layer at a time.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import tree
from repro_torch.configs.base import (AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
                                      ArchConfig)
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.rematctx import maybe_remat
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (dense_init, embed_init, mlp_fwd,
                                       mlp_init, rmsnorm, softcap, zeros_param)

ATTN_ROUTES = (None, "plain", "flash")
ATTN_FAMILIES = (DENSE, MOE, AUDIO, VLM)


class Block(nn.Module):
    """One layer's parameters, as named parts: ``ln1``, ``ln2``, ``attn``
    and ``mlp`` or ``moe`` (the attention families; also the hybrid's shared
    block), ``ln`` and ``mamba`` (a hybrid layer), ``ln`` and ``cell`` (an
    xLSTM block)."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part)


class Transformer(nn.Module):
    """The parameters of an LM: ``embed`` (V, d), ``final_norm`` (d,),
    ``lm_head`` (d, V) unless the embeddings are tied, ``in_proj`` (d_in, d)
    where the model takes embeddings, ``layers`` (the xLSTM's blocks, which
    differ by kind), and the hybrid's ``shared_attn`` block."""

    def __init__(self, embed: nn.Parameter, final_norm: nn.Parameter,
                 layers: Sequence[Block], lm_head: Optional[nn.Parameter] = None,
                 in_proj: Optional[nn.Parameter] = None,
                 shared_attn: Optional[Block] = None):
        super().__init__()
        self.embed, self.final_norm = embed, final_norm
        self.lm_head, self.in_proj = lm_head, in_proj
        self.layers = nn.ModuleList(layers)
        self.shared_attn = shared_attn


# ===========================================================================
# Init
# ===========================================================================
def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Transformer:
    """Random parameters on ``gen``'s device, with the JAX package's
    distributions (gains zero, so each norm starts as 1 * x)."""
    d, dev = cfg.d_model, gen.device

    def gain():
        return zeros_param(d, dtype, dev)

    embed = embed_init(gen, cfg.vocab, d, dtype)
    in_proj = None if cfg.embed_inputs else dense_init(gen, cfg.d_in, d, dtype)
    lm_head = None if cfg.tie_embeddings else dense_init(gen, d, cfg.vocab, dtype)
    shared = None
    if cfg.family in ATTN_FAMILIES:
        def ffn():
            if cfg.is_moe:
                return {"moe": moe_mod.moe_init(gen, cfg, dtype)}
            return {"mlp": mlp_init(gen, d, cfg.d_ff, dtype, cfg.gated_mlp)}
        layers = [Block(ln1=gain(), ln2=gain(), attn=attn.attn_init(gen, cfg, dtype),
                        **ffn()) for _ in range(cfg.n_layers)]
    elif cfg.family == HYBRID:
        layers = [Block(ln=gain(), mamba=ssm_mod.mamba2_init(gen, cfg, dtype))
                  for _ in range(cfg.n_layers)]
        shared = Block(ln1=gain(), ln2=gain(), attn=attn.attn_init(gen, cfg, dtype),
                       mlp=mlp_init(gen, d, cfg.d_ff, dtype))
    elif cfg.family == SSM:
        layers = [Block(ln=gain(), cell=(xlstm_mod.slstm_init if i in cfg.slstm_at
                                         else xlstm_mod.mlstm_init)(gen, cfg, dtype))
                  for i in range(cfg.n_layers)]
    else:
        raise ValueError(cfg.family)
    return Transformer(embed, gain(), layers, lm_head, in_proj, shared)


def _part_tree(part):
    """A block's part as a tree: a weight detached, or a dict of them."""
    if isinstance(part, torch.Tensor):
        return part.detach()
    return {n: _part_tree(w) for n, w in part.items()}


def _block_tree(b) -> Dict:
    """A ``Block`` (or a namespace of the same parts) as a dict of trees."""
    parts = ({**dict(b.named_parameters(recurse=False)), **dict(b.named_children())}
             if isinstance(b, nn.Module) else vars(b))
    return {n: _part_tree(w) for n, w in parts.items()}


def params_tree(p: Transformer) -> Dict:
    """The JAX package's parameter tree of ``p``: ``embed``, ``final_norm``,
    ``lm_head`` unless tied, ``in_proj`` where the model takes embeddings,
    and the layers.  ``layers`` holds every layer's weights stacked on a
    leading L axis (copies): ``ln1``, ``ln2``, ``attn``, ``mlp`` or ``moe``
    (attention families), or ``ln`` and ``mamba`` (hybrid, beside an
    unstacked ``shared_attn``); the xLSTM's blocks, which differ by kind,
    are a list ``blocks`` of ``{ln, cell}``.  Unstacked leaves share ``p``'s
    storage."""
    out = {"embed": p.embed.detach(), "final_norm": p.final_norm.detach()}
    for name in ("lm_head", "in_proj"):
        if getattr(p, name, None) is not None:
            out[name] = getattr(p, name).detach()
    blocks = [_block_tree(b) for b in p.layers]
    if "cell" in blocks[0]:
        out["blocks"] = blocks
    else:
        out["layers"] = tree.tree_map(lambda *ws: torch.stack(ws), *blocks)
    if getattr(p, "shared_attn", None) is not None:
        out["shared_attn"] = _block_tree(p.shared_attn)
    return out


def _as_params(p):
    """``p`` itself, or for the JAX package's tree (a dict) the same
    attributes with each layer's weights views of the stacked leaves
    (``unbind``: one stack in the backward, not one scatter a layer; a
    placed view's ``tensor_parallel.Gathered`` leaf unbinds into each
    layer's pieces, assembled when the layer runs)."""
    if not isinstance(p, dict):
        return p
    if "blocks" in p:
        layers = [SimpleNamespace(**b) for b in p["blocks"]]
    else:
        lay = p["layers"]
        cols = [w.unbind(0) for w in tree.leaves(lay)]
        layers = [SimpleNamespace(**tree.unflatten(lay, [c[i] for c in cols]))
                  for i in range(len(cols[0]))]
    shared = p.get("shared_attn")
    return SimpleNamespace(embed=p["embed"], final_norm=p["final_norm"],
                           lm_head=p.get("lm_head"), in_proj=p.get("in_proj"),
                           layers=layers,
                           shared_attn=None if shared is None else SimpleNamespace(**shared))


# ===========================================================================
# Embedding / head
# ===========================================================================
def embed_in(p: Transformer, cfg: ArchConfig, batch: Dict) -> torch.Tensor:
    """Token ids through ``embed``, or frontend embeddings (``embeds``,
    (B, S, d_in)) through ``in_proj``."""
    if "embeds" in batch:
        if p.in_proj is None:
            raise ValueError(f"{cfg.name} takes token ids, not embeddings")
        x = batch["embeds"].to(p.in_proj.dtype) @ p.in_proj
    else:
        # F.embedding, not p.embed[tokens]: its backward sums a row's
        # gradients in one order (indexing's accumulates in parallel on the
        # CPU, so two runs differ in the last bits); cut by vocab over the
        # model places, each looks up its range
        x = tensor_parallel.embedding(batch["tokens"], p.embed)
    if cfg.embed_scale:
        # a device fill, not a host tensor copied over (which waits on the card)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def lm_head(p: Transformer, cfg: ArchConfig, x: torch.Tensor):
    """The logits; with the head cut by vocab over the model places, each
    place's columns (a ``tensor_parallel.Blocks``)."""
    x = rmsnorm(x, p.final_norm, cfg.norm_eps)
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return tensor_parallel.column_parallel(
        lambda w, x: softcap(x @ w, cfg.final_softcap), w, x)


# ===========================================================================
# Attention-family stack (dense / moe / audio / vlm)
# ===========================================================================
def _per_layer_windows(cfg: ArchConfig):
    """Each layer's attention window (0 = full)."""
    if cfg.alt_local_global:
        return [cfg.window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


def _check_route(attn_impl: Optional[str]) -> None:
    if attn_impl not in ATTN_ROUTES:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_ROUTES}")


def _prefill_impl(x: torch.Tensor, pos1d: torch.Tensor, explicit: bool,
                  attn_impl: Optional[str]) -> str:
    """The attention path of one forward.  The flash kernel on the card, or
    wherever "flash" is asked for; its masks are those of positions
    arange(S) + c per row (``pos1d``: the positions, or M-RoPE's first
    stream, which the masks read), checked once when the caller gave
    positions (not on the meta device, which holds no values: the dry run
    takes the card's route).  Otherwise ("plain", or None on the CPU) the
    JAX package's routing by length."""
    _check_route(attn_impl)
    if attn_impl == "flash" or (attn_impl is None and (x.is_cuda or x.is_meta)):
        if explicit and not x.is_meta and not attn.is_prefill_positions(pos1d, pos1d):
            raise ValueError("prefill through the flash kernel masks positions "
                             "arange(S) + c per row; pass attn_impl='plain' "
                             "for others")
        return "flash"
    return "blockwise" if x.shape[1] >= attn.BLOCKWISE_THRESHOLD else "dense"


def _pos1d(positions: torch.Tensor) -> torch.Tensor:
    """The positions the masks read: M-RoPE's first stream."""
    return positions if positions.dim() == 2 else positions[..., 0]


def _layer(x: torch.Tensor, lp, cfg: ArchConfig, positions: torch.Tensor,
           window: int, impl: str):
    """One layer over the full sequence. Returns (x, k, v, the MoE aux loss
    or None); under the split, k and v are each model place's.  A weight
    that FSDP cuts is assembled here, and so again in a remat recompute."""
    lp = tensor_parallel.assembled(lp)
    h = rmsnorm(x, lp.ln1, cfg.norm_eps)

    def attend(q, k, v, positions):
        pos1d = _pos1d(positions)
        return attn.attention(q, k, v, cfg, pos1d, pos1d,
                              causal=cfg.causal, window=window, impl=impl)

    a, (k, v) = attn.self_attention(lp.attn, h, cfg, positions, attend)
    x = x + a
    h2 = rmsnorm(x, lp.ln2, cfg.norm_eps)
    if cfg.is_moe:
        f, aux = moe_mod.moe_ffn(lp.moe, h2, cfg)
        return x + f, k, v, aux
    return x + mlp_fwd(lp.mlp, h2, cfg.act), k, v, None


def _attn_stack_full(p: Transformer, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, impl: str,
                     build_cache: bool, max_seq: int = 0):
    """All layers over the full sequence. Returns (x, aux, cache or None);
    aux sums the layers' MoE losses (0 without experts).  The cache's keys
    and values are in x's dtype (under the split, each model place's:
    ``tensor_parallel.new_kv_cache``)."""
    B, S, _ = x.shape
    cache = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = maybe_remat(_layer)
    for i, (lp, window) in enumerate(zip(p.layers, _per_layer_windows(cfg))):
        x, k, v, a = layer(x, lp, cfg, positions, window, impl)
        if a is not None:
            aux = aux + a
        if build_cache:
            if cache is None:
                cache = {n: tensor_parallel.new_kv_cache(t, cfg.n_layers, max(max_seq, S),
                                                         x.dtype, cfg)
                         for n, t in (("k", k), ("v", v))}
                cache["pos"] = S
            tensor_parallel.write_prefill_kv(cache["k"], i, k, S)
            tensor_parallel.write_prefill_kv(cache["v"], i, v, S)
    return x, aux, cache


def _decode_positions(cfg: ArchConfig, pos: int, B: int, device) -> torch.Tensor:
    """(B, 1) positions ``pos``, repeated over M-RoPE's three streams."""
    positions = torch.full((B, 1), pos, dtype=torch.long, device=device)
    return positions[..., None].expand(B, 1, 3) if cfg.mrope else positions


def _write_kv(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, pos: int) -> None:
    """One token's keys and values into caches (B, Smax, K, hd) at ``pos``
    (the last row past the end: JAX clamps the update slice); a cache cut
    along its positions writes on the places that hold ``pos``."""
    if isinstance(kc, tensor_parallel.SeqCache):
        return tensor_parallel.seq_write(kc, vc, k, v, pos)
    at = min(pos, kc.shape[1] - 1)
    kc[:, at] = k[:, 0].to(kc.dtype)
    vc[:, at] = v[:, 0].to(vc.dtype)


def _attn_stack_decode(p: Transformer, cfg: ArchConfig, x: torch.Tensor,
                       cache: Dict):
    """One token per sequence through all layers, against the cache."""
    pos = cache["pos"]
    B = x.shape[0]
    positions = _decode_positions(cfg, pos, B, x.device)
    cache_len = torch.full((B,), pos + 1, dtype=torch.long, device=x.device)
    for i, (lp, window) in enumerate(zip(p.layers, _per_layer_windows(cfg))):
        lp = tensor_parallel.assembled(lp)
        h = rmsnorm(x, lp.ln1, cfg.norm_eps)

        def attend(q, k, v, positions, kc, vc, cache_len, window=window):
            _write_kv(kc, vc, k, v, pos)
            return attn.decode_attention(q, kc, vc, cfg, cache_len, window=window)

        a, _ = attn.self_attention(lp.attn, h, cfg, positions, attend,
                                   cache["k"][i], cache["v"][i], cache_len)
        x = x + a
        h2 = rmsnorm(x, lp.ln2, cfg.norm_eps)
        if cfg.is_moe:
            x = x + moe_mod.moe_ffn(lp.moe, h2, cfg)[0]
        else:
            x = x + mlp_fwd(lp.mlp, h2, cfg.act)
    cache["pos"] = pos + 1
    return x, cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                    device=None) -> Dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


# ===========================================================================
# Hybrid stack (Zamba2: Mamba2 layers + one shared attention block)
# ===========================================================================
def n_attn_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _attn_app(cfg: ArchConfig, i: int) -> Optional[int]:
    """Which application of the shared block follows layer ``i``, if any
    (after every ``attn_every``-th layer)."""
    if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
        return (i + 1) // cfg.attn_every - 1
    return None


def _shared_attn_apply(sp, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor, impl: Optional[str] = None,
                       kv=None, pos: int = 0):
    """The shared attention + MLP block.  ``kv`` None: the full sequence
    through ``impl``, returning its keys and values; else one token against
    the caches ``kv`` = (k, v) (B, Smax, K, hd), written at ``pos`` in
    place."""
    h = rmsnorm(x, sp.ln1, cfg.norm_eps)
    if kv is None:
        def attend(q, k, v, positions):
            pos1d = _pos1d(positions)
            return attn.attention(q, k, v, cfg, pos1d, pos1d, impl=impl)

        a, (k, v) = attn.self_attention(sp.attn, h, cfg, positions, attend)
    else:
        def attend(q, k, v, positions, kc, vc, cache_len):
            _write_kv(kc, vc, k, v, pos)
            return attn.decode_attention(q, kc, vc, cfg, cache_len)

        cache_len = torch.full((x.shape[0],), pos + 1, dtype=torch.long,
                               device=x.device)
        a, _ = attn.self_attention(sp.attn, h, cfg, positions, attend, *kv, cache_len)
        k, v = kv
    x = x + a
    h2 = rmsnorm(x, sp.ln2, cfg.norm_eps)
    return x + mlp_fwd(sp.mlp, h2, cfg.act), (k, v)


def _hybrid_layer(x: torch.Tensor, lp, sp, cfg: ArchConfig,
                  positions: torch.Tensor, impl: str, shared: bool):
    """One Mamba2 layer over the full sequence, then the shared block
    (parameters ``sp``) where ``shared``: JAX's rematted scan body, the
    shared block's application inside it.  Returns (x, the layer's Mamba2
    state, the shared block's (k, v) or None)."""
    lp = tensor_parallel.assembled(lp)
    h = rmsnorm(x, lp.ln, cfg.norm_eps)
    m_out, st = ssm_mod.mamba2_fwd(lp.mamba, h, cfg, None)
    x = x + m_out
    kv = None
    if shared:
        x, kv = _shared_attn_apply(sp, cfg, x, positions, impl)
    return x, st, kv


def _hybrid_full(p: Transformer, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, impl: str, build_cache: bool,
                 max_seq: int = 0):
    """All layers over the full sequence, the shared block after every
    ``attn_every``-th.  The cache's keys and values are in x's dtype."""
    B, S, _ = x.shape
    if build_cache:
        kv_all, ssm_st, conv_st = None, [], []
    layer = maybe_remat(_hybrid_layer)
    for i, lp in enumerate(p.layers):
        a = _attn_app(cfg, i)
        x, st, kv = layer(x, lp, p.shared_attn, cfg, positions, impl, a is not None)
        if build_cache:
            if a is not None:
                if kv_all is None:
                    kv_all = [tensor_parallel.new_kv_cache(t, n_attn_apps(cfg),
                                                           max(max_seq, S), x.dtype, cfg)
                              for t in kv]
                for c, t in zip(kv_all, kv):
                    tensor_parallel.write_prefill_kv(c, a, t, S)
            ssm_st.append(st["ssm"])
            conv_st.append(st["conv"])
    cache = None
    if build_cache:
        cache = {"attn_k": kv_all[0], "attn_v": kv_all[1], "ssm": torch.stack(ssm_st),
                 "conv": torch.stack(conv_st), "pos": S}
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


def _hybrid_decode(p: Transformer, cfg: ArchConfig, x: torch.Tensor, cache: Dict):
    """One token per sequence; every state and cache updated in place."""
    pos = cache["pos"]
    positions = _decode_positions(cfg, pos, x.shape[0], x.device)
    for i, lp in enumerate(p.layers):
        lp = tensor_parallel.assembled(lp)
        h = rmsnorm(x, lp.ln, cfg.norm_eps)
        m_out, st = ssm_mod.mamba2_decode(
            lp.mamba, h, cfg, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
        x = x + m_out
        cache["ssm"][i] = st["ssm"]
        cache["conv"][i] = st["conv"]
        a = _attn_app(cfg, i)
        if a is not None:
            x, _ = _shared_attn_apply(p.shared_attn, cfg, x, positions,
                                      kv=(cache["attn_k"][a], cache["attn_v"][a]),
                                      pos=pos)
    cache["pos"] = pos + 1
    return x, cache


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                      device=None) -> Dict:
    """Keys and values in ``dtype``; the Mamba2 states in float32."""
    kv = (n_attn_apps(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd)
    st = ssm_mod.mamba2_init_state(cfg, batch, device)
    return {"attn_k": torch.zeros(kv, dtype=dtype, device=device),
            "attn_v": torch.zeros(kv, dtype=dtype, device=device),
            **{k: v.expand(cfg.n_layers, *v.shape).clone() for k, v in st.items()},
            "pos": 0}


# ===========================================================================
# xLSTM stack (a list of blocks whose structure differs by kind)
# ===========================================================================
def _xlstm_cell(cfg: ArchConfig, i: int, decode: bool):
    if i in cfg.slstm_at:
        return xlstm_mod.slstm_decode if decode else xlstm_mod.slstm_fwd
    return xlstm_mod.mlstm_decode if decode else xlstm_mod.mlstm_fwd


def _xlstm_full(p: Transformer, cfg: ArchConfig, x: torch.Tensor,
                build_cache: bool):
    states = []
    for i, blk in enumerate(p.layers):
        out, st = _xlstm_cell(cfg, i, False)(
            blk.cell, rmsnorm(x, blk.ln, cfg.norm_eps), cfg, None)
        x = x + out
        states.append(st)
    cache = {"states": states, "pos": x.shape[1]} if build_cache else None
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


def _xlstm_decode(p: Transformer, cfg: ArchConfig, x: torch.Tensor, cache: Dict):
    for i, blk in enumerate(p.layers):
        out, cache["states"][i] = _xlstm_cell(cfg, i, True)(
            blk.cell, rmsnorm(x, blk.ln, cfg.norm_eps), cfg, cache["states"][i])
        x = x + out
    cache["pos"] += 1
    return x, cache


def init_xlstm_cache(cfg: ArchConfig, batch: int, device=None) -> Dict:
    return {"states": [(xlstm_mod.slstm_init_state if i in cfg.slstm_at
                        else xlstm_mod.mlstm_init_state)(cfg, batch, device)
                       for i in range(cfg.n_layers)],
            "pos": 0}


# ===========================================================================
# Public API
# ===========================================================================
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """The decode cache for (batch, max_seq); an encoder has none."""
    if cfg.family in (DENSE, MOE, VLM):
        return init_attn_cache(cfg, batch, max_seq, dtype, device)
    if cfg.family == HYBRID:
        return init_hybrid_cache(cfg, batch, max_seq, dtype, device)
    if cfg.family == SSM:
        return init_xlstm_cache(cfg, batch, device)
    raise ValueError(cfg.family)


def default_positions(cfg: ArchConfig, batch: int, seq: int,
                      device=None) -> torch.Tensor:
    """(B, S) positions arange(S); (B, S, 3) with t = h = w under M-RoPE."""
    pos = torch.arange(seq, device=device)[None].expand(batch, seq)
    return pos[..., None].expand(batch, seq, 3) if cfg.mrope else pos


def forward(params: Transformer, cfg: ArchConfig, batch: Dict,
            build_cache: bool = False, max_seq: int = 0,
            attn_impl: Optional[str] = None):
    """Full-sequence forward of ``batch`` ({tokens} or {embeds}, positions
    optional). Returns (logits, aux_loss, cache|None).

    ``attn_impl`` None runs the flash kernel on the card and the JAX
    package's routing (dense below 4096 tokens, blockwise from 4096) on the
    CPU; "plain" takes that routing on the card too; "flash" takes the
    kernel (its plain version on the CPU).  ``params`` is a ``Transformer``
    or the JAX package's tree (``params_tree``).
    """
    params = _as_params(params)
    x = embed_in(params, cfg, batch)
    B, S = x.shape[:2]
    if cfg.family == SSM:
        _check_route(attn_impl)
        x, aux, cache = _xlstm_full(params, cfg, x, build_cache)
        return lm_head(params, cfg, x), aux, cache
    positions = batch.get("positions")
    explicit = positions is not None
    if not explicit:
        positions = default_positions(cfg, B, S, x.device)
    impl = _prefill_impl(x, _pos1d(positions), explicit, attn_impl)
    if cfg.family in ATTN_FAMILIES:
        x, aux, cache = _attn_stack_full(params, cfg, x, positions, impl,
                                         build_cache, max_seq)
    elif cfg.family == HYBRID:
        x, aux, cache = _hybrid_full(params, cfg, x, positions, impl,
                                     build_cache, max_seq)
    else:
        raise ValueError(cfg.family)
    return lm_head(params, cfg, x), aux, cache


def decode_step(params: Transformer, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict):
    """tokens: (B, 1). Returns (logits (B, 1, V), cache).  ``params`` is a
    ``Transformer`` or the JAX package's tree, as ``forward`` takes."""
    if cfg.is_encoder:
        raise ValueError("encoder-only model has no decode step")
    params = _as_params(params)
    x = embed_in(params, cfg, {"tokens": tokens})
    if cfg.family in (DENSE, MOE, VLM):
        x, cache = _attn_stack_decode(params, cfg, x, cache)
    elif cfg.family == HYBRID:
        x, cache = _hybrid_decode(params, cfg, x, cache)
    elif cfg.family == SSM:
        x, cache = _xlstm_decode(params, cfg, x, cache)
    else:
        raise ValueError(cfg.family)
    return tensor_parallel.whole(lm_head(params, cfg, x)), cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE in fp32. logits (B,S,V), labels (B,S); cut by vocab
    over the model places, the vocab-parallel cross-entropy."""
    if isinstance(logits, tensor_parallel.Blocks):
        return tensor_parallel.cross_entropy(logits, labels, mask)
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
    """(loss, {"ce", "aux"}) of ``batch`` ({tokens or embeds, labels,
    mask?}): cross-entropy plus ``aux_weight`` times the MoE aux loss.  The
    attention takes the JAX package's routing on every device (dense below
    4096 tokens, blockwise from 4096): the flash kernel has no backward."""
    logits, aux, _ = forward(params, cfg, batch, attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}
