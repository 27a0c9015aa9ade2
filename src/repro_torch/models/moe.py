"""Mixture-of-Experts FFN with sort-based capacity dispatch.

A port of the JAX package's ``models/moe.py`` (its dense dispatch).  Tokens
are routed into an (E, C, d) buffer by a scatter, the experts run as three
batched products over E, and the results gather back; no (N, E, C) one-hot
tensor is built.  The router runs in float32, and the auxiliary
load-balancing loss is Switch-Transformer's, E * sum_e f_e * P_e.

A token slot past its expert's capacity C is dropped: the scatter writes it
to row C of an (E, C + 1, d) buffer whose last row is then cut off (JAX's
``mode="drop"``), so no boolean mask has to be compacted on the host.  C is
``n_tokens * top_k * capacity_factor / n_experts`` rounded up to a multiple
of 8, and at least 8.

The mesh dispatch (JAX's ``moe_ffn_local``, a shard_map over an expert axis,
and the ``flags.moe_dispatch()`` switch) waits for placement over several
cards (ROADMAP queue 1 item 12g).

``count_drops()`` collects each call's dropped token slots as 0-dim device
tensors, without a wait on the card.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (act_fn, dense_init, mlp_fwd, mlp_init,
                                       normal_init)

_DROPS: Optional[List[torch.Tensor]] = None


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ParameterDict:
    """``router`` (d, E) in float32 whatever ``dtype``; the experts' ``wi``,
    ``wg`` (E, d, f) and ``wo`` (E, f, d); ``shared``, a gated MLP of width
    ``d_ff_expert * n_shared_experts``, where the config has shared
    experts."""
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": dense_init(gen, d, E, torch.float32),
         "wi": normal_init(gen, (E, d, f), d ** -0.5, dtype),
         "wg": normal_init(gen, (E, d, f), d ** -0.5, dtype),
         "wo": normal_init(gen, (E, f, d), f ** -0.5, dtype)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, f * cfg.n_shared_experts, dtype)
    return nn.ParameterDict(p)


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _routing(xt: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """xt: (n, d) -> gates (n, k) renormalised over the top k, expert
    indices (n, k) and the aux loss, all from float32 logits (a router cast
    to a lower compute dtype is promoted back, as JAX's einsum does)."""
    n = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.ones(n * k, dtype=torch.float32, device=xt.device)) / (n * k)
    return gate_vals, expert_idx, E * (me * ce).sum()


def _dispatch_positions(expert_idx: torch.Tensor, n: int, k: int, E: int, C: int):
    """Each token slot's expert, token and rank within its expert (slots in
    token order, then top-k order), and whether the rank is below C."""
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1)
    flat_t = torch.arange(n * k, device=dev) // k
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                      # exclusive
    pos_sorted = torch.arange(n * k, device=dev) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return flat_e, flat_t, pos, pos < C


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, a 0-dim float32 tensor)."""
    B, S, d = x.shape
    N = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, N)
    xt = x.reshape(N, d)
    gate_vals, expert_idx, aux = _routing(xt, p["router"], cfg)
    flat_e, flat_t, pos, keep = _dispatch_positions(expert_idx, N, k, E, C)
    if _DROPS is not None:
        _DROPS.append((~keep).sum())

    # dispatch: a dropped slot lands in row C, which is cut off
    buf = x.new_zeros((E, C + 1, d))
    buf[flat_e, torch.where(keep, pos, C)] = xt[flat_t]
    buf = buf[:, :C]

    # the experts: batched products over E
    h = torch.bmm(buf, p["wi"])
    h = act_fn(cfg.act)(torch.bmm(buf, p["wg"])) * h
    out_buf = torch.bmm(h, p["wo"])

    # combine
    gathered = out_buf[flat_e, torch.clamp_max(pos, C - 1)]       # (N*k, d)
    w = (gate_vals.reshape(-1) * keep).to(x.dtype)
    y = (gathered * w[:, None]).reshape(N, k, d).sum(1)
    if cfg.n_shared_experts:
        y = y + mlp_fwd(p["shared"], x, cfg.act).reshape(N, d)
    return y.reshape(B, S, d), aux


@contextlib.contextmanager
def count_drops():
    """Inside the block, every ``moe_ffn`` call appends its dropped token
    slots (a 0-dim device tensor) to the list this yields."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev
