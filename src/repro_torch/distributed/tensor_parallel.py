"""The dense layers' compute split along the model axis (Megatron), inside
one data replica of a placed step; and the placed prefill and decode.

The JAX package has no counterpart of this module: there GSPMD splits the
compute after the ``lshard`` annotations on the activations
(``src/repro/models/attention.py:57-59``, ``layers.py:118``,
``transformer.py:103,111,139,147,162,257``) and the parameters'
in_shardings.  The port has no compiler to do that (``sharding.lshard`` only
checks its names), so the placed steps split the compute themselves, through
hooks that the model's one body calls:

  * a weight that ``param_specs`` puts on the model axis reaches the model
    as :class:`Blocks`, the replica's model places' blocks of it, each on its
    place (``replica_view``); a replicated weight as the replica's own copy
    at its home (model place 0), except inside an attention or MLP whose
    other weights are cut, where each place reads its own copy;
  * column-parallel products (``wq``, ``wk``, ``wv`` by heads, ``wi``/``wg``
    by ff, ``lm_head`` by vocab): each place computes the columns of its
    block; row-parallel products (attention's ``wo`` by heads, the MLP's by
    ff): each place a partial output, the partials summed at home in place
    order (:func:`row_parallel`, the one hook of an attention or MLP body:
    ``models/layers.mlp_fwd``, ``models/attention.self_attention``);
  * attention on each place's own heads: on the card the prefill runs the
    flash kernel with H/M q heads and K/M kv heads, or, where ``kv_heads`` is
    unbound, with the kv heads its q heads read of the K it computed
    (:func:`kv_for_heads`);
  * the vocab-split embedding (:func:`embedding`: each place looks up the ids
    in its range, the partial rows summed) and the vocab-parallel
    cross-entropy (:func:`cross_entropy`: max and sum of exponentials
    combined over the places; no place holds the whole (B, S, V) logits);
  * the experts as ``moe_ffn_local`` places them (``models/moe.py``), each
    place its E/M experts; SSM, xLSTM, norms and the router stay replicated,
    run once at the replica's home;
  * a decode cache whose positions are cut over places (:class:`SeqCache`:
    ``cache_specs``' sequence axis over "model" where ``kv_heads`` is unbound,
    or the data axes' slices of long context) attends by
    ``seq_parallel``'s partial softmax and log-sum-exp combine.

A weight that the data axes cut too (FSDP) is assembled on each place
that computes with it: once a step, or, for a stacked leaf, one layer at a
time (:class:`Gathered`).  A replica's gradients are reduced to the places
that own each block (:func:`reduce_grads`), never formed whole.

A hand-over is counted by ``sharding.hand`` under its kind: ``tp_in`` (an
activation to a place), ``tp_sum`` (a partial home), ``tp_gather`` (a
column block's output home), ``fsdp_gather`` (an FSDP block to a replica's
place), ``grad_reduce`` (a gradient's part to its owner, an FSDP piece's in
the layer's backward), ``seq_q``/``seq_partial``, ``moe``; ``_grad`` after a
kind marks the gradient handed back.  Nothing here reads a knob: the split
follows the specs and the mesh, and at model size 1 nothing is split.
"""
from __future__ import annotations

import contextlib
import math
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.distributed.seq_parallel import _local_partial, lse_combine
from repro_torch.distributed.sharding import (Mesh, NamedSharding, P, Placed, _moved,
                                              _spec_axes, at_place, block_slices,
                                              count_transfer, hand, place, work_scope)

MODEL = "model"
HOOKED = ("attn", "mlp", "shared")   # dicts whose bodies run per place


class _Current(threading.local):
    def __init__(self):
        self.where: Optional[Tuple[int, int]] = None    # (m, M) in a body


_CUR = _Current()


def current() -> Optional[Tuple[int, int]]:
    """(model place m, places M) inside a per-place body, else None."""
    return _CUR.where


# ===========================================================================
# Blocks: one replica's model places' pieces of a tensor
# ===========================================================================
class Blocks:
    """A tensor held by the model places of one data replica: ``tensors[m]``
    on ``devices[m]`` (mesh place ``places[m]``), the m-th cut along ``dim``,
    or (``dim`` None) each place's own value (copies, for a weight).  Place
    0 of the list is the replica's home.  ``x @ blocks`` is the product with
    ``x`` at home: column blocks give their columns back, row blocks their
    partial sums."""

    __slots__ = ("tensors", "places", "devices", "dim")

    def __init__(self, tensors, places, devices, dim):
        self.tensors, self.places = list(tensors), tuple(places)
        self.devices, self.dim = tuple(devices), dim

    def with_tensors(self, tensors, dim="same") -> "Blocks":
        return Blocks(tensors, self.places, self.devices,
                      self.dim if dim == "same" else dim)

    @property
    def n(self) -> int:
        return len(self.tensors)

    @property
    def dtype(self):
        return self.tensors[0].dtype

    @property
    def shape(self) -> torch.Size:
        s = list(self.tensors[0].shape)
        if self.dim is not None:
            s[self.dim] *= self.n
        return torch.Size(s)

    def dim_after_index(self, d: int = 0):
        if self.dim is None:
            return None
        if d == self.dim:
            raise ValueError(f"indexing the cut dimension {d} of {self!r}")
        return self.dim - (d < self.dim)

    def unbind(self, d: int = 0) -> List["Blocks"]:
        nd = self.dim_after_index(d)
        cols = [t.unbind(d) for t in self.tensors]
        return [self.with_tensors([c[i] for c in cols], nd) for i in range(len(cols[0]))]

    def __getitem__(self, i: int) -> "Blocks":
        return self.with_tensors([t[i] for t in self.tensors], self.dim_after_index(0))

    @property
    def T(self) -> "Blocks":
        return self.with_tensors([t.T for t in self.tensors],
                                 None if self.dim is None else 1 - self.dim)

    def to(self, *args, **kw) -> "Blocks":
        return self.with_tensors([t.to(*args, **kw) for t in self.tensors])

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        home, hdev = self.places[0], self.devices[0]
        if self.dim is None:
            return x @ self.tensors[0]
        nd = self.tensors[0].dim()
        if self.dim == nd - 1:                        # column blocks
            return column_parallel(lambda w, x: x @ w, self, x).whole()
        if self.dim != nd - 2:
            raise ValueError(f"x @ blocks cut along dimension {self.dim}")
        k = self.tensors[0].shape[-2]                 # row blocks
        out = None
        for m in range(self.n):
            xm = hand(x[..., m * k:(m + 1) * k], home, self.places[m], self.devices[m], "tp_in")
            with _on(self, m):
                part = xm @ self.tensors[m]
            part = hand(part, self.places[m], home, hdev, "tp_sum")
            out = part if out is None else out + part
        return out

    def whole(self) -> torch.Tensor:
        """The tensor at home: the cuts concatenated, or home's copy."""
        home, hdev = self.places[0], self.devices[0]
        if self.dim is None:
            return self.tensors[0]
        return torch.cat([hand(t, self.places[m], home, hdev, "tp_gather")
                          for m, t in enumerate(self.tensors)], self.dim)

    def __repr__(self):
        return (f"Blocks({tuple(self.shape)}, {self.dtype}, dim={self.dim}, "
                f"places={self.places})")


@contextlib.contextmanager
def _on(b: Blocks, m: int):
    """Run as model place m of ``b``: its memory is charged there and
    :func:`current` reads (m, M)."""
    prev = _CUR.where
    _CUR.where = (m, b.n)
    try:
        with at_place(b.places[m]):
            yield
    finally:
        _CUR.where = prev


def _first_blocks(t) -> Optional[Blocks]:
    for leaf in tree.leaves(t) if isinstance(t, (dict, list, tuple)) else [t]:
        if isinstance(leaf, Blocks):
            return leaf
    return None


def _arg_at(a, b: Blocks, m: int):
    if isinstance(a, Blocks):
        return a.tensors[m]
    if torch.is_tensor(a):
        return hand(a, b.places[0], b.places[m], b.devices[m], "tp_in")
    return a


def row_parallel(body, p, *args):
    """``body(p, *args) -> (out, *rest)``.  Where ``p`` holds
    :class:`Blocks`, ``body`` runs on each model place with that place's
    pieces of ``p`` and of any ``Blocks`` argument (tensor arguments handed
    from home), ``out`` is summed at home in place order and each of
    ``rest`` returned as a ``Blocks`` of the places' values; else ``body``
    runs once."""
    b = _first_blocks(p)
    if b is None:
        return body(p, *args)
    home, hdev = b.places[0], b.devices[0]
    total, rests = None, []
    for m in range(b.n):
        pm = tree.tree_map(lambda w: w.tensors[m] if isinstance(w, Blocks) else w, p)
        with _on(b, m):
            out, *rest = body(pm, *[_arg_at(a, b, m) for a in args])
        out = hand(out, b.places[m], home, hdev, "tp_sum")
        total = out if total is None else total + out
        rests.append(rest)
    return (total, *[b.with_tensors(list(r), None) for r in zip(*rests)])


def column_parallel(body, w, x) -> "Blocks | torch.Tensor":
    """``body(w, x)``; with ``w`` a column-cut :class:`Blocks`, run on each
    place with its block and ``x`` handed from home: the places' outputs,
    cut along their last dimension."""
    if not isinstance(w, Blocks):
        return body(w, x)
    outs = []
    for m in range(w.n):
        xm = _arg_at(x, w, m)
        with _on(w, m):
            outs.append(body(w.tensors[m], xm))
    return w.with_tensors(outs, outs[0].dim() - 1)


def embedding(tokens: torch.Tensor, w) -> torch.Tensor:
    """``F.embedding(tokens, w)``; ``w`` cut by vocab rows: each place looks
    up the ids in its range (others give zero rows), the rows summed at
    home."""
    if not isinstance(w, Blocks):
        return F.embedding(tokens, w)
    if w.dim != 0:
        raise ValueError(f"an embedding cut along dimension {w.dim}")
    home, hdev = w.places[0], w.devices[0]
    n_loc = w.tensors[0].shape[0]
    out = None
    for m in range(w.n):
        ids = _arg_at(tokens, w, m)
        with _on(w, m):
            local = ids - m * n_loc
            ok = (local >= 0) & (local < n_loc)
            rows = F.embedding(local.clamp(0, n_loc - 1), w.tensors[m])
            rows = rows * ok[..., None].to(rows.dtype)
        rows = hand(rows, w.places[m], home, hdev, "tp_sum")
        out = rows if out is None else out + rows
    return out


def cross_entropy(logits: Blocks, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32 of vocab-cut logits (B, S, V/M a
    place): each place's max, the global max at home, each place's sum of
    exponentials and its gold logit (where the label is in its range),
    combined at home."""
    home, hdev = logits.places[0], logits.devices[0]
    v_loc = logits.tensors[0].shape[-1]
    maxes = []
    for m, lg in enumerate(logits.tensors):
        with _on(logits, m):
            mx = lg.detach().float().amax(-1)
        maxes.append(hand(mx, logits.places[m], home, hdev, "tp_sum"))
    gmax = torch.stack(maxes).amax(0)
    total = gold = None
    for m, lg in enumerate(logits.tensors):
        g = _arg_at(gmax, logits, m)
        lab = _arg_at(labels, logits, m)
        with _on(logits, m):
            lg = lg.float()
            s = torch.exp(lg - g[..., None]).sum(-1)
            local = lab.long() - m * v_loc
            ok = (local >= 0) & (local < v_loc)
            gl = lg.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0] * ok
        s = hand(s, logits.places[m], home, hdev, "tp_sum")
        gl = hand(gl, logits.places[m], home, hdev, "tp_sum")
        total = s if total is None else total + s
        gold = gl if gold is None else gold + gl
    nll = gmax + torch.log(total) - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, n_q: int, cfg):
    """The kv heads that this place's ``n_q`` q heads read, where the place
    computed all K (``kv_heads`` unbound: ``wk``/``wv`` replicated) and holds
    1/M of the q heads; else ``k``, ``v`` as they are.  q head h reads kv
    head h // (H / K)."""
    where = current()
    K, H = cfg.n_kv_heads, cfg.n_heads
    if where is None or k.shape[2] != K or n_q == H:
        return k, v
    G = H // K
    first = where[0] * n_q
    lo, hi = first // G, (first + n_q - 1) // G + 1
    kv = torch.arange(first, first + n_q) // G - lo
    if n_q % (hi - lo) == 0 and bool((kv == torch.arange(n_q) // (n_q // (hi - lo))).all()):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = (torch.arange(first, first + n_q, device=k.device) // G)
    return k.index_select(2, idx), v.index_select(2, idx)


def whole(t):
    """``t`` at home: a :class:`Blocks`' pieces joined, else ``t``."""
    return t.whole() if isinstance(t, Blocks) else t


def new_kv_cache(k, n: int, max_seq: int, dtype, cfg):
    """Zeros to hold ``n`` layers' keys (or values) like ``k`` (B, S, K, hd)
    up to ``max_seq`` positions: one tensor; under the split, each model
    place's, by heads where the places hold 1/M of them, else (every place
    computed all K) cut along the positions as ``cache_specs`` lays the
    cache out (:class:`SeqCache`)."""
    if not isinstance(k, Blocks):
        return torch.zeros((n, *k.shape[:1], max_seq, *k.shape[2:]), dtype=dtype,
                           device=k.device)
    B, _, K, hd = k.tensors[0].shape
    seq_cut = K == cfg.n_kv_heads
    if seq_cut and max_seq % k.n:
        raise ValueError(f"a cache of {max_seq} positions over {k.n} places")
    S_loc = max_seq // k.n if seq_cut else max_seq
    blocks = []
    for m in range(k.n):
        with _on(k, m):
            blocks.append(torch.zeros((n, B, S_loc, K, hd), dtype=dtype,
                                      device=k.devices[m]))
    if not seq_cut:
        return k.with_tensors(blocks, 3)
    lo = [m * S_loc for m in range(k.n)]
    return SeqCache(blocks, lo, [(a, a + S_loc) for a in lo], k.places, k.devices,
                    (k.places[0], k.devices[0]), 2)


def write_prefill_kv(cache, i: int, k, S: int) -> None:
    """Layer ``i``'s keys (or values) of a prefill of S positions into the
    cache from :func:`new_kv_cache`, each place writing its own part."""
    if isinstance(cache, SeqCache):
        for m, (b, lo) in enumerate(zip(cache.blocks, cache.lo)):
            hi = min(lo + b.shape[2], S)
            if hi > lo:
                b[i, :, :hi - lo] = k.tensors[m][:, lo:hi]
    elif isinstance(cache, Blocks):
        for c, t in zip(cache.tensors, k.tensors):
            c[i, :, :S] = t
    else:
        cache[i, :, :S] = k


# ===========================================================================
# a decode cache cut along its positions
# ===========================================================================
class SeqCache:
    """A decode cache (L?, B, S, K, hd) whose positions lie on several places:
    ``blocks[j]`` on place ``places[j]`` holds positions ``[lo[j], lo[j] +
    its length)`` (a cut of the sequence, or the whole of it where the
    places hold copies) and attends to ``owned[j]``.  Used from place
    ``home`` (the caller's).  ``cache[i]`` is layer i's cache."""

    def __init__(self, blocks, lo, owned, places, devices, home, seq_dim):
        self.blocks, self.lo, self.owned = list(blocks), list(lo), list(owned)
        self.places, self.devices = list(places), list(devices)
        self.home, self.seq_dim = home, seq_dim

    def __getitem__(self, i: int) -> "SeqCache":
        return SeqCache([b[i] for b in self.blocks], self.lo, self.owned, self.places,
                        self.devices, self.home, self.seq_dim - 1)

    @property
    def size(self) -> int:
        return max(lo + b.shape[self.seq_dim] for lo, b in zip(self.lo, self.blocks))


def seq_write(kc: SeqCache, vc: SeqCache, k: torch.Tensor, v: torch.Tensor,
              pos: int) -> None:
    """One token's keys and values (B, 1, K, hd) written at ``pos`` (the
    last row past the end, as ``transformer._write_kv``) on every place
    that holds that position."""
    at = min(pos, kc.size - 1)
    hp, _ = kc.home
    for j, (kb, vb) in enumerate(zip(kc.blocks, vc.blocks)):
        r = at - kc.lo[j]
        if 0 <= r < kb.shape[kc.seq_dim]:
            kb[:, r] = hand(k[:, 0], hp, kc.places[j], kc.devices[j], "seq_write").to(kb.dtype)
            vb[:, r] = hand(v[:, 0], hp, kc.places[j], kc.devices[j], "seq_write").to(vb.dtype)


def seq_attend(q: torch.Tensor, kc: SeqCache, vc: SeqCache, cfg,
               cache_len: torch.Tensor, window: int) -> torch.Tensor:
    """``decode_attention`` over a cache cut along its positions: each
    place's partial softmax over its owned positions
    (``seq_parallel._local_partial``), combined at home by
    ``seq_parallel.lse_combine``.  q: (B, 1, H, hd) -> (B, 1, H, hd)."""
    hp, hdev = kc.home
    scale = 1.0 / math.sqrt(q.shape[-1])
    parts = []
    for j, (kb, vb) in enumerate(zip(kc.blocks, vc.blocks)):
        a, b = kc.owned[j]
        sl = slice(a - kc.lo[j], b - kc.lo[j])
        dst, dev = kc.places[j], kc.devices[j]
        qj = hand(q[:, 0], hp, dst, dev, "seq_q")
        cl = hand(cache_len, hp, dst, dev, "seq_q")
        with at_place(dst):
            part = _local_partial(qj, kb[:, sl], vb[:, sl], a, cl, scale,
                                  cfg.attn_softcap, window)
        parts.append([hand(t, dst, hp, hdev, "seq_partial") for t in part])
    return lse_combine(parts)[:, None].to(q.dtype)


# ===========================================================================
# one replica's view of placed parameters, and the reduce to the owners
# ===========================================================================
def model_places(mesh: Mesh, home: int, axis: str = MODEL) -> List[int]:
    """The places of ``home``'s replica along ``axis`` (``home`` first when
    it is model place 0)."""
    if axis not in mesh.shape:
        return [home]
    c = mesh.coords(home)
    return [mesh.place_at({**c, axis: m}) for m in range(mesh.shape[axis])]


def _slices_of(pp: Placed) -> list:
    cache = pp.__dict__.setdefault("_slices", {})
    if not cache:
        for j in range(len(pp.blocks)):
            cache[j] = pp.slices(j)
    return cache


def _model_spec(spec, axis: str) -> P:
    return P(*[axis if axis in _spec_axes(e) else None for e in spec])


def model_region(pp: Placed, i: int, axis: str = MODEL) -> Tuple[slice, ...]:
    """The slices of ``pp`` that place ``i`` computes with: its block as
    the model axis alone cuts the leaf."""
    return block_slices(NamedSharding(pp.sharding.mesh, _model_spec(pp.sharding.spec, axis)),
                        pp.shape, i)


def _rel(inner, outer):
    """``inner`` (slices of a leaf) as slices of the block ``outer``."""
    return tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(inner, outer))


def _plan(pp: Placed, i: int, axis: str = MODEL):
    """How place ``i``'s model block of ``pp`` is assembled: (its shape,
    [(the place a piece is read from, where the piece lands in it)]), or
    None where place ``i``'s own block is its model block (no axis but the
    model axis cuts the leaf).  A piece is read from place ``i`` where it
    holds it, else from its first holder of ``i``'s model index."""
    mesh = pp.sharding.mesh
    region = model_region(pp, i, axis)
    slices = _slices_of(pp)
    if slices[i] == region:
        return None
    c = mesh.coords(i)
    done, where = set(), []
    for j in range(mesh.size):
        if axis in c and mesh.coords(j)[axis] != c[axis]:
            continue
        sl = slices[j]
        if sl in done:
            continue
        done.add(sl)
        where.append((i if slices[i] == sl else j, _rel(sl, region)))
    return [s.stop - s.start for s in region], where


def _tiling(shape, where) -> Optional[int]:
    """The one dimension along which the pieces of ``where`` lie end to end
    in order, whole along every other, or None."""
    if len(where) < 2:
        return None
    rels = [rel for _, rel in where]
    dims = [d for d in range(len(shape)) if any(r[d] != rels[0][d] for r in rels)]
    if len(dims) != 1:
        return None
    d = dims[0]
    whole = all(r[e] == slice(0, shape[e]) for r in rels for e in range(len(shape)) if e != d)
    ends = [0] + [r[d].stop for r in rels]
    return d if whole and all(r[d].start == e for r, e in zip(rels, ends)) \
        and ends[-1] == shape[d] else None


def _fill(dst: int, device, shape, where, pieces) -> torch.Tensor:
    """A tensor of ``shape`` on place ``dst`` filled from ``pieces`` (each
    read from its place in ``where``), counted as ``fsdp_gather``: one
    ``cat`` where the pieces tile one dimension (FSDP's cut)."""
    for (src, _), t in zip(where, pieces):
        count_transfer(t, src, dst, "fsdp_gather")
    d = _tiling(shape, where)
    with at_place(dst, forced=True):
        if d is not None:
            return torch.cat([t.to(device) for t in pieces], d)
        out = torch.empty(shape, dtype=pieces[0].dtype, device=device)
        for (_, rel), t in zip(where, pieces):
            out[rel].copy_(t)
    return out


def model_block(pp: Placed, i: int, axis: str = MODEL) -> torch.Tensor:
    """Place ``i``'s block of ``pp`` as the model axis alone cuts it: its
    own block where no other axis cuts the leaf, else assembled on place
    ``i`` from the blocks the data axes cut (FSDP), counted as
    ``fsdp_gather``."""
    plan = _plan(pp, i, axis)
    if plan is None:
        return pp.blocks[i]
    shape, where = plan
    return _fill(i, pp.sharding.mesh.devices[i], shape, where,
                 [pp.blocks[src] for src, _ in where])


class _Assemble(torch.autograd.Function):
    """A layer's model block assembled on place ``dst`` from its pieces
    (``_fill``); the backward hands each piece its part of the gradient, to
    the piece's place, counted as ``grad_reduce``: FSDP's reduce, a layer
    at a time."""

    @staticmethod
    def forward(ctx, dst, device, shape, where, *pieces):
        ctx.back = (dst, shape, where, [t.device for t in pieces])
        return _fill(dst, device, shape, where, pieces)

    @staticmethod
    def backward(ctx, g):
        dst, shape, where, devs = ctx.back
        d = _tiling(shape, where)
        parts = (torch.split(g, [rel[d].stop - rel[d].start for _, rel in where], d)
                 if d is not None else [g[rel] for _, rel in where])
        out = []
        for (src, _), part, dev in zip(where, parts, devs):
            count_transfer(part, dst, src, "grad_reduce")
            if not (g.is_meta and src != dst) and torch.device(dev) == g.device:
                with at_place(dst, forced=True):
                    part = part.clone()     # not a view: the layer's gradient goes
            out.append(_moved(part, dst, src, dev))
        return (None, None, None, None, *out)


class Gathered:
    """A stacked leaf (the layers on its leading axis) that the data axes
    cut too (FSDP, or ``serve_opt``'s expert ff), as one replica reads it:
    for each of its model places (``places``), the pieces of that place's
    model block, each ``(the place it is read from, tensor, where it
    lands)``.  Nothing is assembled here: ``unbind(0)`` gives each layer's
    view, and :func:`assembled` builds a layer's model block on each place
    when the layer runs (again in a remat recompute), released with it.
    ``kind``: "cut" (the model axis cuts dimension ``dim``: a ``Blocks``),
    "copies" (each model place assembles the whole of it) or "home" (one
    tensor, at the replica's home)."""

    __slots__ = ("parts", "shapes", "places", "devices", "kind", "dim")

    def __init__(self, parts, shapes, places, devices, kind, dim=None):
        self.parts, self.shapes = [list(p) for p in parts], [list(s) for s in shapes]
        self.places, self.devices = tuple(places), tuple(devices)
        self.kind, self.dim = kind, dim

    @property
    def tensors(self) -> List[torch.Tensor]:
        return [t for part in self.parts for _, t, _ in part]

    @property
    def dtype(self):
        return self.parts[0][0][1].dtype

    def with_tensors(self, tensors) -> "Gathered":
        it = iter(tensors)
        return Gathered([[(src, next(it), rel) for src, _, rel in part] for part in self.parts],
                        self.shapes, self.places, self.devices, self.kind, self.dim)

    def to(self, *args, **kw) -> "Gathered":
        return self.with_tensors([t.to(*args, **kw) for t in self.tensors])

    def unbind(self, d: int = 0) -> List["Gathered"]:
        if d != 0 or self.dim == 0:
            raise ValueError(f"a stacked leaf unbinds along its layers, not dimension {d}")
        cols = [[(src, t.unbind(0), rel[1:]) for src, t, rel in part] for part in self.parts]
        dim = None if self.dim is None else self.dim - 1
        return [Gathered([[(src, ts[l], rel) for src, ts, rel in part] for part in cols],
                         [s[1:] for s in self.shapes], self.places, self.devices, self.kind, dim)
                for l in range(self.shapes[0][0])]

    def assemble(self):
        """Each model place's block built on its place: a tensor at home
        ("home"), else :class:`Blocks`."""
        out = []
        for m, (part, shape) in enumerate(zip(self.parts, self.shapes)):
            src, t, _ = part[0]
            if len(part) == 1 and src == self.places[m] and list(t.shape) == shape:
                out.append(t)                       # the place's own block
                continue
            where = tuple((src, rel) for src, _, rel in part)
            out.append(_Assemble.apply(self.places[m], self.devices[m], shape, where,
                                       *[t for _, t, _ in part]))
        if self.kind == "home":
            return out[0]
        return Blocks(out, self.places, self.devices, self.dim if self.kind == "cut" else None)

    def __repr__(self):
        return f"Gathered({self.kind}, dim={self.dim}, places={self.places})"


def assembled(t):
    """``t`` (one layer's parameters: a namespace, dicts, lists) with every
    :class:`Gathered` in it assembled; ``t`` itself where it holds none."""
    if isinstance(t, Gathered):
        return t.assemble()
    if isinstance(t, SimpleNamespace):
        d = vars(t)
        new = assembled(d)
        return t if new is d else SimpleNamespace(**new)
    if isinstance(t, dict):
        new = {k: assembled(v) for k, v in t.items()}
        return t if all(new[k] is v for k, v in t.items()) else new
    if isinstance(t, list):
        new = [assembled(v) for v in t]
        return t if all(a is b for a, b in zip(new, t)) else new
    return t


def _cut_dim(pp: Placed, axis: str) -> Optional[int]:
    for d, e in enumerate(pp.sharding.spec):
        if axis in _spec_axes(e):
            return d
    return None


def replica_view(params, mesh: Mesh, home: int, axis: str = MODEL):
    """The parameters (a tree of ``Placed``) as the replica at place
    ``home`` computes with them: a leaf cut along ``axis`` as
    :class:`Blocks` of its model places' blocks, a replicated leaf as the
    block at ``home`` (each place's own copy, as ``Blocks``, inside an
    attention or MLP whose weights are cut).  FSDP cuts are assembled on
    each place (``model_block``): a stacked leaf's (under ``layers``) a
    layer at a time, as :class:`Gathered`; any other once.  At model size 1
    every leaf is the block at ``home``."""
    places = model_places(mesh, home, axis)
    devs = [mesh.devices[i] for i in places]
    split = len(places) > 1

    def leaf(pp, stacked, copies=False):
        d = _cut_dim(pp, axis) if split else None
        at = places if d is not None or copies else [home]
        kind = "cut" if d is not None else "copies" if copies else "home"
        plans = [_plan(pp, i, axis) for i in at]
        if stacked and any(pl is not None for pl in plans):
            parts = [[(i, pp.blocks[i], tuple(slice(0, n) for n in pp.blocks[i].shape))]
                     if pl is None else [(src, pp.blocks[src], rel) for src, rel in pl[1]]
                     for i, pl in zip(at, plans)]
            shapes = [list(pp.blocks[i].shape) if pl is None else pl[0]
                      for i, pl in zip(at, plans)]
            return Gathered(parts, shapes, at, [mesh.devices[i] for i in at], kind, d)
        tensors = [model_block(pp, i, axis) for i in at]
        return tensors[0] if kind == "home" else Blocks(tensors, places, devs, d)

    def walk(t, parent=None, stacked=False):
        if isinstance(t, dict):
            copies = split and parent in HOOKED and any(
                isinstance(v, Placed) and _cut_dim(v, axis) is not None for v in t.values())
            return {k: leaf(v, stacked, copies) if isinstance(v, Placed)
                    else walk(v, k, stacked or k == "layers") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, parent, stacked) for v in t]
        return leaf(t, stacked) if isinstance(t, Placed) else t

    return walk(params)


def view_leaves(view) -> List[torch.Tensor]:
    """Every tensor of a replica view, a Blocks' pieces in place order (a
    Gathered's in its parts' order): the autograd leaves of a step."""
    out = []
    for leaf in tree.leaves(view):
        out.extend(leaf.tensors if isinstance(leaf, (Blocks, Gathered)) else [leaf])
    return out


def with_leaves(view, new: Sequence[torch.Tensor]):
    """``view`` holding ``new`` (in :func:`view_leaves` order)."""
    it = iter(new)
    return tree.tree_map(lambda x: x.with_tensors([next(it) for _ in x.tensors])
                         if isinstance(x, (Blocks, Gathered)) else next(it), view)


def grad_sources(params, view, home: int, axis: str = MODEL):
    """For each leaf of ``params`` (a tree of ``Placed``), where each of the
    gradients that ``replica_view(params, mesh, home)`` yields for it
    (``view_leaves`` order) lies: (its place, the slices of the leaf it
    covers).  A model block's at its place; a Gathered piece's back on the
    place it was read from (``_Assemble``'s backward); a replicated leaf's
    at ``home``, or one partial a model place where each held a copy."""
    out = []
    for pp, v in zip(tree.leaves(params), tree.leaves(view)):
        if isinstance(v, Gathered):
            out.append([(src, _slices_of(pp)[src]) for part in v.parts for src, _, _ in part])
        elif isinstance(v, Blocks):
            out.append([(i, model_region(pp, i, axis)) for i in v.places])
        else:
            out.append([(home, model_region(pp, home, axis))])
    return out


def _inside(region, outer):
    """``region`` as slices of the block ``outer`` that holds it, or None
    where the two do not meet; raises where they overlap in part."""
    if any(r.stop <= o.start or r.start >= o.stop for r, o in zip(region, outer)):
        return None
    if any(r.start < o.start or r.stop > o.stop for r, o in zip(region, outer)):
        raise ValueError(f"block {region} overlaps the gradient of {outer} in part: the "
                         f"optimizer specs must refine the parameter specs")
    return _rel(region, outer)


def owner_blocks(params, owners) -> List[Placed]:
    """float32 zeros for each leaf of ``params``, placed by ``owners`` (a
    ``NamedSharding`` a leaf): the accumulators of :func:`reduce_grads`."""
    out = []
    for pp, sh in zip(tree.leaves(params), owners):
        blocks = []
        for i, dev in enumerate(sh.mesh.devices):
            with at_place(i, forced=True):
                blocks.append(torch.zeros([s.stop - s.start for s in
                                           block_slices(sh, pp.shape, i)],
                                          dtype=torch.float32, device=dev))
        out.append(Placed(blocks, pp.shape, sh))
    return out


def reduce_grads(params, sources, grads: List, owners, acc: Optional[List[Placed]] = None,
                 mb: int = 1) -> Optional[List[Placed]]:
    """A replica's gradients (``grads``, in ``view_leaves`` order, lying
    where ``grad_sources`` says; consumed) reduced to their owners: each
    place, for each leaf, gets the part of every gradient that covers its
    block by ``owners`` (the optimizer block it updates), handed to it
    (``grad_reduce``).  With ``acc`` (from :func:`owner_blocks`) each part
    is added to the place's block as the one-device microbatch loop adds a
    microbatch, ``acc += g.float() / mb``, in the order of ``grads``;
    without, the place's block is the part itself (one replica, one
    microbatch: the sum of the parts where model places held copies), and
    the blocks are returned as ``Placed`` leaves."""
    out, at = [], 0
    for n, (pp, srcs, sh) in enumerate(zip(tree.leaves(params), sources, owners)):
        gs = grads[at:at + len(srcs)]
        grads[at:at + len(srcs)] = [None] * len(srcs)
        at += len(srcs)
        blocks = []
        for i, dev in enumerate(sh.mesh.devices):
            region = block_slices(sh, pp.shape, i)
            total = None
            for (src, reg), g in zip(srcs, gs):
                rel = _inside(region, reg)
                if rel is None:
                    continue
                part = hand(g if region == reg else g[rel], src, i, dev, "grad_reduce")
                with at_place(i, forced=True):
                    if acc is not None:
                        acc[n].blocks[i].add_(part.float() / mb)
                    elif total is None:
                        total = part if part.shape == g.shape else part.clone()
                    else:
                        total = total + part
            if acc is None:
                if total is None:
                    raise ValueError(f"no gradient covers block {region} of {pp!r}")
                blocks.append(total)
        del gs
        if acc is None:
            out.append(Placed(blocks, pp.shape, sh))
    return None if acc is not None else out


# ===========================================================================
# the placed prefill and decode
# ===========================================================================
def _batch_dim(spec, mesh: Mesh, axis: str = MODEL) -> Optional[int]:
    """The dimension a spec cuts over axes other than the model axis (the
    rows of a batch or a cache)."""
    for d, e in enumerate(spec):
        if any(a != axis for a in _spec_axes(e)):
            return d
    return None


class Replicas:
    """Where the replicas of a placed prefill or decode live: one per block
    of rows that ``rows_spec`` cuts a batch of ``n_rows`` into, each at its
    first holder (its home); ``of(i)`` is place i's replica's home."""

    def __init__(self, mesh: Mesh, rows_spec: P, n_rows: int):
        self.mesh = mesh
        sh = NamedSharding(mesh, P(rows_spec[0] if len(rows_spec) else None))
        start = [block_slices(sh, (n_rows,), i)[0] for i in range(mesh.size)]
        first: Dict[int, int] = {}
        for i, sl in enumerate(start):
            first.setdefault(sl.start, i)
        self.homes = [first[r] for r in sorted(first)]
        self._of = [first[sl.start] for sl in start]
        self.rows = {first[sl.start]: sl for sl in start}

    def of(self, i: int) -> int:
        return self._of[i]


def place_batch(batch: Dict, batch_specs: Dict, mesh: Mesh, skip=()):
    """(every key of ``batch`` but ``skip`` placed by ``batch_specs``, a key
    without a spec as ``labels``; its :class:`Replicas`, a block of rows
    each).  Raises where a key's rows are cut apart from the others'."""
    rows = batch_specs.get("labels", next(iter(batch_specs.values())))
    reps = Replicas(mesh, rows, next(iter(batch.values())).shape[0])
    out = {}
    for key, v in batch.items():
        if key in skip:
            continue
        out[key] = place(v, NamedSharding(mesh, batch_specs.get(key, rows)))
        if any(out[key].slices(i)[0] != reps.rows[reps.of(i)] for i in range(mesh.size)):
            raise ValueError(f"batch key {key!r} cut apart on its rows from {rows}")
    return out, reps


def _view_shape(piece) -> List[int]:
    if isinstance(piece, SeqCache):
        s = list(piece.blocks[0].shape)
        s[piece.seq_dim] = piece.size
        return s
    return list(piece.shape)


def _to_placed(pieces: Dict[int, object], spec, reps: Replicas, axis: str = MODEL):
    """A cache leaf from each replica's value (at its home, or each model
    place's: ``Blocks``/``SeqCache``) as a ``Placed`` by ``spec``: each
    place's block, a replica's home value cut and handed to the places that
    hold its parts (``cache_place``)."""
    mesh = reps.mesh
    any_piece = pieces[reps.homes[0]]
    shape = _view_shape(any_piece)
    bd = _batch_dim(spec, mesh, axis)
    if bd is not None:
        shape[bd] *= len(reps.homes)
    sh = NamedSharding(mesh, spec)
    blocks = []
    for i in range(mesh.size):
        h = reps.of(i)
        piece, m = pieces[h], mesh.coords(i).get(axis, 0)
        if isinstance(piece, Blocks):
            blocks.append(piece.tensors[m])
            continue
        if isinstance(piece, SeqCache):
            blocks.append(piece.blocks[m])
            continue
        sl = list(block_slices(sh, shape, i))
        if bd is not None:
            sl[bd] = slice(None)          # the replica's piece holds its rows
        part = piece[tuple(sl)]
        if i == h and part.shape == piece.shape:
            blocks.append(piece)
            continue
        count_transfer(part, h, i, "cache_place")
        with at_place(i, forced=True):
            blocks.append(part.to(mesh.devices[i], copy=True))
    return Placed(blocks, shape, sh)


KV_LEAVES = ("k", "v", "attn_k", "attn_v")


def _seq_group(mesh: Mesh, i: int, axes: Tuple[str, ...]) -> List[int]:
    """The places that differ from place ``i`` only along ``axes``, in
    their row-major order."""
    c = mesh.coords(i)
    out = [dict(c)]
    for a in axes:
        out = [{**o, a: j} for o in out for j in range(mesh.shape[a])]
    return [mesh.place_at(o) for o in out]


def _seq_cut(pp: Placed, p: int, axes) -> SeqCache:
    """Long context: place ``p``'s kv block as the places along ``axes``
    hold it (each the whole sequence, as ``cache_specs`` places it), each
    attending to its 1/n slice of the positions."""
    mesh = pp.sharding.mesh
    group = _seq_group(mesh, p, axes)
    S, n = pp.shape[2], len(group)
    if S % n:
        raise ValueError(f"{S} cache positions over {n} places")
    own = [(j * S // n, (j + 1) * S // n) for j in range(n)]
    return SeqCache([pp.blocks[g] for g in group], [0] * n, own, group,
                    [mesh.devices[g] for g in group], (p, mesh.devices[p]), 2)


def _cache_view(cache: Dict, h: int, kv_seq):
    """The replica at place ``h``'s view of a cache placed by
    ``cache_specs``: kv leaves cut by heads as ``Blocks`` of its model
    places' blocks, cut along the positions as a :class:`SeqCache`; with
    ``kv_seq`` (long context) each place's positions split over the places
    along those axes; every other leaf the block at ``h``."""
    out = {}
    for key, val in cache.items():
        if key not in KV_LEAVES or not isinstance(val, Placed):
            out[key] = tree.tree_map(lambda t: t.blocks[h] if isinstance(t, Placed) else t, val)
            continue
        mesh = val.sharding.mesh
        places = model_places(mesh, h)
        devs = [mesh.devices[i] for i in places]
        d = _cut_dim(val, MODEL) if len(places) > 1 else None
        if d == 3:
            if kv_seq:
                out[key] = Blocks([_seq_cut(val, p, kv_seq) for p in places], places, devs, None)
            else:
                out[key] = Blocks([val.blocks[p] for p in places], places, devs, 3)
        elif d == 2:
            lo = [val.slices(p)[2].start for p in places]
            n = val.blocks[h].shape[2]
            out[key] = SeqCache([val.blocks[p] for p in places], lo,
                                [(a, a + n) for a in lo], places, devs, (h, mesh.devices[h]), 2)
        else:
            out[key] = _seq_cut(val, h, kv_seq) if kv_seq else val.blocks[h]
    return out


def _sync_state(cache: Dict, view: Dict, reps: Replicas, h: int) -> None:
    """After a decode step, every place of replica ``h`` holding a copy of a
    state leaf (not keys or values) gets the replica's new value
    (``cache_sync``)."""
    mesh = reps.mesh
    for key in cache:
        if key in KV_LEAVES or key == "pos":
            continue
        for pp, new in zip(tree.leaves(cache[key]), tree.leaves(view[key])):
            if not isinstance(pp, Placed):
                continue
            for i in range(mesh.size):
                if reps.of(i) != h or pp.blocks[i] is new:
                    continue
                pp.blocks[i].copy_(hand(new, h, i, mesh.devices[i], "cache_sync"))


def _place_params(params, mesh: Mesh, specs):
    return tree.tree_map(lambda x, s: x if isinstance(x, Placed) or s is None
                         else place(x, NamedSharding(mesh, s)), params, specs)


def make_placed_prefill(cfg, mesh: Mesh, param_specs, batch_specs: Dict,
                        cache_specs=None, max_seq: int = 0, replicas: Optional[int] = None):
    """``prefill(params, batch) -> (logits (B, 1, V) at place 0, cache)``:
    the counterpart of the JAX dry run's ``prefill_step`` under
    ``in_shardings`` (``launch/specs.input_specs``).  ``params`` is placed
    by ``param_specs`` on the first call (a tree of ``Placed`` passes); the
    batch comes whole and is cut by ``batch_specs``; each replica runs
    ``transformer.forward`` on its rows with the dense layers split over its
    model places (and the card's attention route, flash, as the one-device
    prefill takes it); the cache comes back placed by ``cache_specs`` (None
    for an encoder, which builds none).  ``replicas`` runs only the last
    that many replicas, as ``make_placed_train_step``'s does (then no cache
    is returned: the dry run reads none)."""
    from repro_torch.models import transformer as tf
    build = not cfg.is_encoder

    def prefill(params, batch):
        params = _place_params(params, mesh, param_specs)
        placed, reps = place_batch(batch, batch_specs, mesh, skip=("labels",))
        home = mesh.devices[0]
        logits, caches = [], {}
        for h in reps.homes[len(reps.homes) - (replicas or len(reps.homes)):]:
            with work_scope("replica"), at_place(h), torch.no_grad():
                view = replica_view(params, mesh, h)
                lg, _, cache = tf.forward(view, cfg, {k: p.blocks[h] for k, p in placed.items()},
                                          build_cache=build, max_seq=max_seq)
                last = (lg.with_tensors([t[:, -1:] for t in lg.tensors]).whole()
                        if isinstance(lg, Blocks) else lg[:, -1:])
                del view, lg
            with work_scope("sink"):
                logits.append(hand(last, h, 0, home, "logits"))
            caches[h] = cache
        out = torch.cat(logits, 0)
        if not build or len(caches) < len(reps.homes):
            return out, None
        first = caches[reps.homes[0]]
        placed_cache = {}
        for key, spec in cache_specs.items():
            if key == "pos":
                placed_cache[key] = first["pos"]
                continue
            leaves = [tree.leaves(caches[h][key]) for h in reps.homes]
            specs = tree.leaves(spec)
            placed_cache[key] = tree.unflatten(first[key], [
                _to_placed({h: leaves[r][j] for r, h in enumerate(reps.homes)}, specs[j], reps)
                for j in range(len(specs))])
        return out, placed_cache

    return prefill


def make_placed_decode(cfg, mesh: Mesh, param_specs, token_spec: P,
                       kv_seq=None, replicas: Optional[int] = None):
    """``decode(params, tokens (B, 1), cache) -> (logits (B, 1, V) at place
    0, cache)``: the counterpart of the JAX dry run's ``serve_step`` under
    ``in_shardings``.  The cache is placed by ``cache_specs`` and updated in
    place (``pos`` advanced); ``params`` as in :func:`make_placed_prefill`.
    Each replica runs ``transformer.decode_step`` on its rows, its dense
    layers split over its model places; keys and values cut by heads attend
    on each place, cut along the positions (``kv_heads`` unbound) by the
    partial-softmax combine over the model places; with ``kv_seq`` (the
    mesh axes ``make_rules`` binds it to at long context) each place's
    positions split again over the places along them
    (``seq_parallel``'s combine).  The replicated state (SSM, conv, xLSTM)
    runs at the replica's home and is copied to the places that hold it.
    ``replicas`` as in :func:`make_placed_prefill` (``pos`` is advanced
    all the same)."""
    from repro_torch.models import transformer as tf
    kv_seq = (kv_seq,) if isinstance(kv_seq, str) else tuple(kv_seq or ())

    def decode(params, tokens, cache):
        params = _place_params(params, mesh, param_specs)
        reps = Replicas(mesh, token_spec, tokens.shape[0])
        tok = place(tokens, NamedSharding(mesh, token_spec))
        home = mesh.devices[0]
        logits = []
        for h in reps.homes[len(reps.homes) - (replicas or len(reps.homes)):]:
            with work_scope("replica"), at_place(h), torch.no_grad():
                view = replica_view(params, mesh, h)
                cv = _cache_view(cache, h, kv_seq)
                lg, cv = tf.decode_step(view, cfg, tok.blocks[h], cv)
                _sync_state(cache, cv, reps, h)
                del view
            with work_scope("sink"):
                logits.append(hand(lg, h, 0, home, "logits"))
        cache["pos"] = cache["pos"] + 1
        return torch.cat(logits, 0), cache

    return decode
