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

Under ``flags.use_local_moe_dispatch(mesh, dp_axes, ep_axis)`` the FFN
takes ``moe_ffn_local``, JAX's shard_map dispatch on the port's
single-controller mesh: place (data d, expert shard e) routes its N/dp
tokens into its own (E/ep, C_loc, d) slab, C_loc the capacity of N/dp
tokens (so its drops differ from the dense dispatch's by design), runs its
experts, and the token outputs sum over the EP axis at home.

Inside a placed step whose experts are cut over the model places (a
``tensor_parallel.Blocks``), ``moe_ffn`` takes ``moe_ffn_local`` too, its
layout read from the blocks: the replica's tokens are one data shard (dp
1, so C_loc = capacity(N) and the drops are the dense dispatch's of those
tokens), each model place routes them and runs its E/M experts, the
outputs summed at the replica's home.

``count_drops()`` collects each call's dropped token slots as 0-dim device
tensors, without a wait on the card; a layer recomputed under remat is not
counted again.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import flags, tensor_parallel
from repro_torch.distributed.rematctx import recomputing
from repro_torch.distributed.sharding import Mesh, current_rules, hand
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


def _count(drops: torch.Tensor) -> None:
    if _DROPS is not None and not recomputing():
        _DROPS.append(drops)


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, a 0-dim float32 tensor)."""
    if isinstance(p["wi"], tensor_parallel.Blocks) or flags.moe_dispatch() is not None:
        return moe_ffn_local(p, x, cfg)
    B, S, d = x.shape
    N = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, N)
    xt = x.reshape(N, d)
    gate_vals, expert_idx, aux = _routing(xt, p["router"], cfg)
    flat_e, flat_t, pos, keep = _dispatch_positions(expert_idx, N, k, E, C)
    _count((~keep).sum())

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


def _experts_part(xt, flat_e, flat_t, pos, keep, gates, wi, wg, wo, e0: int,
                  C: int, cfg: ArchConfig) -> torch.Tensor:
    """One place's experts [e0, e0 + E_loc) (``wi``/``wg``/``wo`` its
    (E_loc, ...) slices) on the token slots routed to them: the slots
    scattered into its (E_loc, C, d) slab (others land in the row past its
    experts and the column past its capacity, cut off), the three products,
    and each token's gated outputs of its slots summed: (N, d), zero for a
    token none of whose slots is here."""
    N, d = xt.shape
    E_loc = wi.shape[0]
    local_e = flat_e - e0
    mine = (local_e >= 0) & (local_e < E_loc) & keep
    buf = xt.new_zeros((E_loc + 1, C + 1, d))
    buf[torch.where(mine, local_e, E_loc), torch.where(mine, pos, C)] = xt[flat_t]
    buf = buf[:E_loc, :C]
    h = torch.bmm(buf, wi)
    h = act_fn(cfg.act)(torch.bmm(buf, wg)) * h
    out = torch.bmm(h, wo)
    vals = out[torch.clamp(local_e, 0, E_loc - 1), torch.clamp_max(pos, C - 1)]
    w = (gates.reshape(-1) * mine).to(xt.dtype)
    return (vals * w[:, None]).reshape(N, cfg.top_k, d).sum(1)


def _dp_coords(mesh: Mesh, dp_axes, d: int):
    out = {}
    for a in reversed(dp_axes):
        out[a] = d % mesh.shape[a]
        d //= mesh.shape[a]
    return out


def moe_ffn_local(p, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's shard_map MoE: place (d, e) routes tokens [d N/dp, (d+1) N/dp)
    into its (E_loc, C_loc, d) slab for experts [e E_loc, (e+1) E_loc), runs
    them and combines its token slots; the outputs sum over e (the one
    collective) and ``aux`` is the mean of the data places'.  The places
    are those of the ambient ``flags.moe_dispatch()`` mesh, ``x`` and the
    weights whole on the caller's device (place 0), weights whose ``fsdp``
    rule is bound cut over the data places too and gathered back on each
    place, as JAX's explicit FSDP gather; or, inside a placed step's data
    replica, the model places its experts are cut over
    (``tensor_parallel.Blocks`` along E): dp 1, each place's experts already
    assembled there, the replica's home the caller's place.  Every copy
    between places is counted and carries autograd.  Places off the data
    and EP axes are not run (they would repeat place 0's)."""
    B, S, d = x.shape
    N = B * S
    E, k = cfg.n_experts, cfg.top_k
    names = ("wi", "wg", "wo")
    if isinstance(p["wi"], tensor_parallel.Blocks):
        blocks = p["wi"]
        if blocks.dim != 0:
            raise ValueError(f"moe_ffn_local: experts cut along dimension {blocks.dim}")
        dp, ep, home = 1, blocks.n, blocks.places[0]
        devs = dict(zip(blocks.places, blocks.devices))
        fsdp_sharded = False

        def place_of(d_idx, e):
            return blocks.places[e]
    else:
        mesh, dp_axes, ep_axis = flags.moe_dispatch()
        ep, home, devs = int(mesh.shape[ep_axis]), 0, mesh.devices
        dp = 1
        for a in dp_axes:
            dp *= int(mesh.shape[a])
        rules = current_rules()
        fsdp_sharded = (rules is not None and rules.rules.get("fsdp") is not None
                        and d % dp == 0 and p["wi"].dim() == 3)

        def place_of(d_idx, e):
            return mesh.place_at({**_dp_coords(mesh, dp_axes, d_idx), ep_axis: e})
    if E % ep or N % dp:
        raise ValueError(f"moe_ffn_local: {E} experts over {ep} places, "
                         f"{N} tokens over {dp}")
    E_loc, N_loc = E // ep, N // dp
    C_loc = capacity(cfg, N_loc)
    xt = x.reshape(N, d)
    hdev = x.device

    def weights(e, dst):
        """Place dst's (E_loc, ...) slices of wi, wg, wo: its expert shard,
        gathered over the data places under FSDP."""
        if isinstance(p["wi"], tensor_parallel.Blocks):
            return [p[name].tensors[e] for name in names]
        out = []
        for name in names:
            w = p[name][e * E_loc:(e + 1) * E_loc]
            if not fsdp_sharded:
                out.append(hand(w, home, dst, devs[dst], "moe"))
                continue
            if w.shape[1] % dp:
                raise ValueError(f"moe_ffn_local: {name} dim 1 of {tuple(w.shape)} "
                                 f"does not divide over {dp} data places")
            n1 = w.shape[1] // dp
            parts = []
            for j in range(dp):                     # place (j, e)'s FSDP block
                src = place_of(j, e)
                blk = hand(w[:, j * n1:(j + 1) * n1], home, src, devs[src], "moe")
                parts.append(hand(blk, src, dst, devs[dst], "moe"))
            out.append(torch.cat(parts, 1))
        return out

    ys, auxes, drops = [], [], []
    for d_idx in range(dp):
        y_d = None
        for e in range(ep):
            me = place_of(d_idx, e)
            x_loc = hand(xt[d_idx * N_loc:(d_idx + 1) * N_loc], home, me, devs[me], "moe")
            wi, wg, wo = weights(e, me)
            gates, idx, aux = _routing(x_loc, hand(p["router"], home, me, devs[me], "moe"),
                                       cfg)
            flat_e, flat_t, pos, keep = _dispatch_positions(idx, N_loc, k, E, C_loc)
            y_loc = hand(_experts_part(x_loc, flat_e, flat_t, pos, keep, gates, wi, wg, wo,
                                       e * E_loc, C_loc, cfg), me, home, hdev, "moe")
            y_d = y_loc if y_d is None else y_d + y_loc
            if e == 0:
                auxes.append(hand(aux, me, home, hdev, "moe"))
                drops.append(hand((~keep).sum(), me, home, hdev, "moe"))
        ys.append(y_d)
    _count(torch.stack(drops).sum())
    y = torch.cat(ys, 0)
    aux = torch.stack(auxes).sum() / dp
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
