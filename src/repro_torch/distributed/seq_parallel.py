"""Sequence-parallel decode attention: the log-sum-exp combine.

A port of the JAX package's ``distributed/seq_parallel.py`` on the port's
single-controller mesh.  The KV cache is cut along its sequence axis over
the mesh axes ``seq_axes``.  Each place computes a *partial* softmax over
its KV slice, with its local max and denominator, and the partials combine
by the log-sum-exp rule: flash-decoding's split-K schedule mapped onto the
places.  Where JAX's shard_map ends in a pmax and two psums over the places,
here each place's (acc, m, l) is handed home (place 0) and combined there:
the max, then the corrected sums.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import (Mesh, NamedSharding, P, Placed,
                                              _spec_axes, block_slices, hand, place)

NEG_INF = -1e30


def _local_partial(q, k, v, start, cache_len, scale, softcap: float = 0.0,
                   window: int = 0):
    """Partial attention over a local KV slice.

    q: (B,H,d); k/v: (B,S_loc,K,d); start: global offset of this slice.
    ``softcap`` and ``window`` as ``models/attention.decode_attention``
    applies them (0: none), for the model's decode; JAX's combine has
    neither.  Returns (acc (B,H,d), m (B,H), l (B,H)), in float32.
    """
    B, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    t = start + torch.arange(k.shape[1], device=q.device)[None, :]
    ok = t < cache_len[:, None]
    if window > 0:
        ok = ok & (t >= cache_len[:, None] - window)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1)                                           # (B,K,G)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def lse_combine(parts) -> torch.Tensor:
    """The (acc, m, l) partials of one query block, in sequence order and
    on one device, combined: the global max, then the corrected sums.
    Returns (B, H, d) in float32."""
    accs, ms, ls = zip(*parts)
    m_glob = torch.stack(ms).amax(0)
    corr = [torch.exp(m - m_glob) for m in ms]
    l_glob = sum(l * c for l, c in zip(ls, corr))
    acc_glob = sum(a * c[..., None] for a, c in zip(accs, corr))
    return acc_glob / torch.clamp_min(l_glob, 1e-30)[..., None]


def make_seq_parallel_decode(mesh: Mesh, seq_axes, kv_spec: P, q_spec: P):
    """A decode attention ``fn(q (B,1,H,d), k_cache, v_cache (B,S,K,d),
    cache_len (B,)) -> (B,1,H,d)`` with the caches cut over ``seq_axes``
    (``kv_spec``'s sequence entry) and ``q`` cut by ``q_spec``.  The caches
    may come as ``Placed`` (by ``kv_spec``) or whole (placed here, from
    place 0); ``q`` and ``cache_len`` come whole on the caller's device and
    the result returns there."""
    axes = seq_axes if isinstance(seq_axes, tuple) else (seq_axes,)
    kv_sh, q_sh = NamedSharding(mesh, kv_spec), NamedSharding(mesh, q_spec)
    if set(a for e in q_spec for a in _spec_axes(e)) & set(axes):
        raise ValueError(f"q_spec {q_spec} cuts over the sequence axes {axes}")

    def fn(q, k_cache, v_cache, cache_len):
        B, _, H, hd = q.shape
        scale = 1.0 / math.sqrt(hd)
        kp = k_cache if isinstance(k_cache, Placed) else place(k_cache, kv_sh)
        vp = v_cache if isinstance(v_cache, Placed) else place(v_cache, kv_sh)
        home = q.device
        # each place's partial, grouped by its output block (places that
        # differ only along the sequence axes share one); a group's members
        # in sequence order, and only the first group of a block is run
        groups: Dict[Tuple, list] = {}
        for i, dev in enumerate(mesh.devices):
            coords = mesh.coords(i)
            rest = tuple(c for a, c in coords.items() if a not in axes)
            q_sl = block_slices(q_sh, q.shape, i)
            g = groups.setdefault(q_sl, {"rest": rest, "members": []})
            if g["rest"] != rest:
                continue
            idx = 0
            for a in axes:
                idx = idx * mesh.shape[a] + coords[a]
            kb = kp.blocks[i]
            qb = hand(q[q_sl][:, 0], 0, i, dev, "seq_q")
            cl = hand(cache_len, 0, i, dev, "seq_q")
            part = _local_partial(qb, kb, vp.blocks[i], idx * kb.shape[1], cl, scale)
            g["members"].append([hand(t, i, 0, home, "seq_partial") for t in part])
        out = torch.empty(q.shape, dtype=q.dtype, device=home)
        for q_sl, g in groups.items():
            out[q_sl] = lse_combine(g["members"])[:, None].to(q.dtype)
        return out

    return fn
