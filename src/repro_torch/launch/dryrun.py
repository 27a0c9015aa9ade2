"""The dry run: every (arch x shape x mesh) cell's placed step on the meta
device, with its memory a place, FLOPs a place and bytes between places.

A port of the JAX package's ``launch/dryrun.py``.  JAX lowers and compiles
each cell on 512 forced host devices and reads ``memory_analysis()``,
``cost_analysis()`` and the collectives in the HLO.  The port has no
compiler: it runs the cell's placed step itself, on tensors of the meta
device (shapes, no storage), over the production mesh of ``["meta"] * n``
places, and counts:

  * ``memory``: the bytes each place holds at its peak.  A
    ``TorchDispatchMode`` holds each storage from its creation until its
    release and charges it to the place whose share of the step made it (the
    place the step runs on, ``sharding.at_place``; a hand-over's copy to its
    destination; an op to the place of its inputs).  All places share the
    one meta device, where a hand-over between two places makes a copy, as
    between two cards.  ``peak_bytes_one_device`` is the peak of the storages
    that one card holding every place would hold (the hand-overs' copies left
    out: on one card they are the same memory).  The count reads operands,
    not threads: on the card, whose autograd runs the backward on a thread
    of its own, it gives each place what it gives on meta;
  * ``flops``: each place's, from ``torch.utils.flop_counter``'s formulas
    (the flash kernel's registered with its custom op), and the total from a
    ``FlopCounterMode`` around the step: the two must agree;
  * ``transfer_bytes`` and ``transfers``: the hand-overs between places by
    kind (``sharding.transfer_counts``), the counterparts of JAX's
    ``collective_bytes`` and ``hlo_collective_ops``;
  * ``arg_bytes_per_device``: JAX's analytic rule (``_arg_bytes``) over the
    same inputs and specs.

Per cell: the production mesh ``(16, 16)`` or ``(2, 16, 16)``
(``launch/mesh.make_production_mesh(devices=["meta"] * n)``), the rules of
``make_rules`` bound, the state or parameters placed by ``param_specs``
(``opt_specs``, ``cache_specs``, ``batch_specs``), then one run of
``make_placed_train_step`` (train), ``tensor_parallel.make_placed_prefill``
or ``make_placed_decode``: a deep cell of alike stacked layers
(``extrapolation_depths``) at three depths, every count continued linearly
to its own depth, exact where the counts are linear in depth, which it
checks (JAX's dry run continues its costs from two depths the same way);
any other at its full depth (``cost_lowering: "meta_full_depth"``).  A cell
``skip_reason`` names writes ``<arch>__<shape>__skip.json``.

Usage (CPU only; imports no JAX):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --single-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced, skip_reason
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import (batch_specs, cache_specs, opt_specs,
                                            param_specs)
from repro_torch.distributed.sharding import (AxisRules, Mesh, NamedSharding, P, Placed,
                                              _spec_axes, at_place, block_slices,
                                              count_transfer, current_mirror, current_place,
                                              current_scope,
                                              place, reset_transfer_counts, set_mesh,
                                              transfer_counts, use_rules)
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.launch.specs import arch_for_cell, input_specs, use_fsdp
from repro_torch.training.train_step import make_placed_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
INT32_SCALAR = 4      # JAX's cache "pos" is an int32 scalar; the port's an int


# ---------------------------------------------------------------------------
# memory and FLOPs a place
# ---------------------------------------------------------------------------
def _tensors(x) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    elif not isinstance(x, (list, tuple)):
        return []
    out = []
    for v in x:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple, dict)):
            out.extend(_tensors(v))
    return out


_aten = torch.ops.aten
# Pointwise ops whose result takes its inputs' shape and promoted dtype.  On
# the meta device they run through Python decompositions (0.1-0.4 ms each,
# most of a dry run's time); where every tensor input has one shape and is
# contiguous (or is 0-dim), their result is made directly, as the kernel
# would make it: a contiguous tensor of that shape (floating dtypes only),
# or, for an in-place op, its first argument.
_POINTWISE = {op.overloadpacket for op in (
    _aten.add.Tensor, _aten.sub.Tensor, _aten.mul.Tensor, _aten.div.Tensor,
    _aten.maximum.default, _aten.minimum.default, _aten.exp.default, _aten.sqrt.default,
    _aten.rsqrt.default, _aten.neg.default, _aten.pow.Tensor_Scalar, _aten.clamp_min.default,
    _aten.clamp_max.default, _aten.where.self, _aten.addcmul.default, _aten.reciprocal.default,
    _aten.tanh.default, _aten.log.default, _aten.add_.Tensor, _aten.sub_.Tensor,
    _aten.mul_.Tensor, _aten.div_.Tensor, _aten.addcmul_.default, _aten.sqrt_.default,
    _aten.exp_.default, _aten.clamp_min_.default, _aten.silu.default,
    _aten.silu_backward.default, _aten.softplus.default, _aten.softplus_backward.default,
    _aten.masked_fill.Scalar)}
# Ops whose result is a contiguous tensor of their (contiguous) first
# argument's shape and dtype, and reductions over listed dimensions.
_SHAPED = {op.overloadpacket for op in (
    _aten.cumsum.default, _aten.tril.default, _aten.triu.default, _aten.flip.default)}
_REDUCE = {_aten.sum.dim_IntList, _aten.mean.dim}


def _broadcast(shapes) -> Optional[torch.Size]:
    """The shape ``shapes`` broadcast to, or None where they do not."""
    first = shapes[0]
    if all(s == first for s in shapes):
        return first
    out = [1] * max(len(s) for s in shapes)
    for s in shapes:
        for i, n in enumerate(s, len(out) - len(s)):
            if n != 1:
                if out[i] not in (1, n):
                    return None
                out[i] = n
    return torch.Size(out)


def _row_major(t: torch.Tensor) -> bool:
    """Whether ``t``'s dimensions of more than one element lie in memory in
    their order (strides falling): a broadcast of it leaves an elementwise
    result's layout to the other operands."""
    st = [s for s, n in zip(t.stride(), t.shape) if n > 1]
    return all(a >= b for a, b in zip(st, st[1:]))


def _plain_result(func, args, kwargs):
    """The result of a ``_POINTWISE`` op on meta tensors, made without its
    decomposition, or None where its inputs are not plain: tensors whose
    shapes broadcast, each with its dimensions in memory order (the
    kernel's result is then contiguous; an in-place op's is its first
    argument, of the result's shape, whatever its layout), of one floating
    dtype (besides a boolean mask), the other arguments Python numbers."""
    if func.overloadpacket in _SHAPED or func in _REDUCE:
        return _plain_shaped(func, args, kwargs)
    if func.overloadpacket not in _POINTWISE or "out" in kwargs:
        return None
    tensors, dtypes = [], set()
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            if not a.is_meta:
                return None
            if a.dtype != torch.bool:
                dtypes.add(a.dtype)
            tensors.append(a)
        elif not isinstance(a, (int, float)):
            return None
    if len(dtypes) != 1 or not next(iter(dtypes)).is_floating_point:
        return None
    shape = _broadcast([t.shape for t in tensors])
    if shape is None:
        return None
    if func._schema.name.endswith("_"):
        return args[0] if args[0].shape == shape else None
    if not all(_row_major(t) for t in tensors):
        return None
    return torch.empty(shape, dtype=dtypes.pop(), device="meta")


def _plain_shaped(func, args, kwargs):
    """The result of a ``_SHAPED`` op or a ``_REDUCE`` reduction (over a
    list of dimensions, no dtype given) of a contiguous meta tensor, made
    without its decomposition: contiguous, its input's dtype; else None."""
    x = args[0]
    if kwargs.get("dtype") is not None or not (x.is_meta and x.is_contiguous()):
        return None
    if func not in _REDUCE:
        if func.overloadpacket is _aten.cumsum and not x.dtype.is_floating_point:
            return None
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    if not dims or len(args) > 3 or not x.dtype.is_floating_point:
        return None
    dims = {d % x.dim() for d in dims}
    shape = [1 if i in dims else n for i, n in enumerate(x.shape) if keep or i not in dims]
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _plain_cat(func, args, kwargs):
    """``cat`` of contiguous meta tensors of one dtype along one dimension,
    made without its decomposition, else None."""
    if func is not _aten.cat.default or kwargs:
        return None
    ts, d = args[0], args[1] if len(args) > 1 else 0
    if not ts or any(not (t.is_meta and t.is_contiguous() and t.dtype == ts[0].dtype
                          and t.dim() == ts[0].dim()) for t in ts):
        return None
    d %= ts[0].dim()
    if any(t.shape[:d] != ts[0].shape[:d] or t.shape[d + 1:] != ts[0].shape[d + 1:] for t in ts):
        return None
    shape = list(ts[0].shape)
    shape[d] = sum(t.shape[d] for t in ts)
    return torch.empty(shape, dtype=ts[0].dtype, device="meta")


class PlaceCount(TorchDispatchMode):
    """Live bytes and FLOPs a place, over every op run inside (see the
    module's docstring for the rules), each also by the step's part
    (``sharding.work_scope``): ``rep_peak`` is the peak a place holds of
    what a replica's own work made (``base`` what it held when the first
    replica began), ``flops_by[scope]`` the FLOPs of each part.  Work that
    stands for alike work elsewhere (``sharding.mirrored``) is charged
    there too.  Plain
    pointwise ops and ``cat`` on meta tensors make their results directly
    (``_plain_result``, ``_plain_cat``), with the metadata the kernels
    give.

    An op is charged to the place of its operands' storages, whichever
    thread runs it (the card's autograd runs the backward on a thread of
    its own, the meta device's on the caller's): a storage made inside is
    where its op was charged, one of ``held`` (a tree of ``Placed``, placed
    before the count began: the parameters and the optimizer state) on its
    block's place.  ``sharding.at_place`` is read where it is set on the
    thread that runs the op: forced (a copy landing on a place), or for an
    op with no operand the count knows.  The step's part is the one
    ``work_scope`` names on the thread that entered the count, and on any
    other thread the one the op's operands were made in."""

    def __init__(self, n_places: int, held=None):
        super().__init__()
        self.n = n_places
        self.where: Dict[int, tuple] = {}     # storage -> (bytes, places, copy, rep, scope)
        self.held_at = {b.untyped_storage()._cdata: i for pp in tree.leaves(held or {})
                        if isinstance(pp, Placed) for i, b in enumerate(pp.blocks)}
        self.thread: Optional[int] = None     # the thread that entered the count
        self.live = [0] * n_places
        self.peak = [0] * n_places
        self.rep_live = [0] * n_places
        self.rep_peak = [0] * n_places
        self.base: Optional[List[int]] = None
        self.one = self.one_peak = 0
        self.mirrored_flops = 0               # charged to places that stood by
        self.flops_by = {None: [0] * n_places, "replica": [0] * n_places,
                         "sink": [0] * n_places}

    @property
    def flops(self) -> List[int]:
        return [sum(v[i] for v in self.flops_by.values()) for i in range(self.n)]

    def __enter__(self):
        if self.thread is None:
            self.thread = threading.get_ident()
        return super().__enter__()

    def _release(self, key: int) -> None:
        nbytes, places, copy, rep, _ = self.where.pop(key)
        for place in places:
            self.live[place] -= nbytes
            if rep:
                self.rep_live[place] -= nbytes
        if not copy:
            self.one -= nbytes

    def _place_of(self, keys) -> int:
        place, forced, _ = current_place()
        if forced:
            return place
        held = [self.where[k][1][0] if k in self.where else self.held_at[k]
                for k in keys if k in self.where or k in self.held_at]
        if not held or place in held:
            return 0 if place is None else place
        return held[0]

    def _scope_of(self, keys) -> Optional[str]:
        if threading.get_ident() == self.thread:
            return current_scope()
        return next((self.where[k][4] for k in keys
                     if k in self.where and self.where[k][4] is not None), None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:                # no storage of its own, no FLOPs
            return func(*args, **kwargs)
        out = _plain_result(func, args, kwargs)
        if out is None:
            out = _plain_cat(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        keys = {t.untyped_storage()._cdata for t in _tensors(args)}
        if kwargs:
            keys.update(t.untyped_storage()._cdata for t in _tensors(kwargs))
        place = self._place_of(keys)
        scope = self._scope_of(keys)
        rep = scope == "replica"
        if rep and self.base is None:
            self.base = list(self.live)
        mirror, others = current_mirror()
        places = (place, *others) if place == mirror else (place,)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = int(fn(*args, **kwargs, out_val=out))
            for p in places:
                self.flops_by[scope][p] += f
            self.mirrored_flops += f * (len(places) - 1)
        _, _, alias = current_place()
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.where or key in keys:    # a view or an in-place result
                continue
            nbytes = st.nbytes()
            self.where[key] = (nbytes, places, alias, rep, scope)
            for p in places:
                self.live[p] += nbytes
                self.peak[p] = max(self.peak[p], self.live[p])
                if rep:
                    self.rep_live[p] += nbytes
                    self.rep_peak[p] = max(self.rep_peak[p], self.rep_live[p])
            if not alias:
                self.one += nbytes
                self.one_peak = max(self.one_peak, self.one)
            weakref.finalize(st, self._release, key)
        return out


# ---------------------------------------------------------------------------
# JAX's analytic bytes a device
# ---------------------------------------------------------------------------
def _arg_bytes(args, in_shardings, mesh_dict) -> int:
    """Analytic per-device bytes of all inputs under their specs (JAX's
    ``dryrun._arg_bytes``: a leaf's bytes over the product of the mesh
    axes its spec names, integer division)."""
    total = 0
    flat_a = tree.leaves(args)
    flat_s = tree.leaves(in_shardings)
    if len(flat_a) != len(flat_s):
        raise ValueError(f"{len(flat_a)} inputs against {len(flat_s)} specs")
    for leaf, spec in zip(flat_a, flat_s):
        if isinstance(leaf, torch.Tensor):
            n, size = leaf.numel(), leaf.element_size()
        else:
            n, size = 1, INT32_SCALAR
        denom = 1
        if isinstance(spec, P):
            for d in spec:
                for a in _spec_axes(d):
                    denom *= mesh_dict.get(a, 1)
        total += n * size // max(denom, 1)
    return total


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def _fsdp_size(cfg, rules: AxisRules, md: Dict[str, int]) -> int:
    if not use_fsdp(cfg):
        return 1
    axes = rules.rules.get("fsdp")
    if not axes:
        return 1
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= md[a]
    return n


def reduced_cell(arch: str, shape_name: str, multi_pod: bool):
    """(cfg, shape, mesh) of a cell cut to test size: ``configs.reduced``,
    at most 8 rows of at most 32 tokens (long_500k keeps its one row, so
    that batch unbinds and ``kv_seq`` binds, as at full size), and a (4, 2)
    mesh, (2, 2, 2) multi-pod, of meta places (the reduced configs' 4 heads
    and 2 kv heads divide over the 2 model places)."""
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 32),
                                global_batch=min(shape.global_batch, 8))
    axes, dims = (("pod", "data", "model"), (2, 2, 2)) if multi_pod else \
        (("data", "model"), (4, 2))
    mesh = Mesh(["meta"] * int(np.prod(dims)), axes, dims)
    return reduced(arch_for_cell(arch, SHAPES[shape_name])), shape, mesh


def cell_specs(arch: str, shape_name: str, multi_pod: bool, moe_local: bool = False,
               serve_opt: bool = False, fsdp_experts_only: bool = False,
               reduce: bool = False, layers: Optional[int] = None):
    """Everything a cell runs with: (mesh, rules dict, shape, cfg, tc, args,
    in_shardings, fsdp size), built as JAX's ``_lower_once`` builds them
    (``reduce``: the cell cut to test size, ``reduced_cell``; ``layers``:
    the model cut to that depth, its posture and specs the cell's)."""
    if reduce:
        cfg, shape, mesh = reduced_cell(arch, shape_name, multi_pod)
    else:
        shape = SHAPES[shape_name]
        cfg = arch_for_cell(arch, shape)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=["meta"] * (512 if multi_pod else 256))
    md = mesh_shape_dict(mesh)
    dp = 1
    for k, v in md.items():
        if k != "model":
            dp *= v
    rules_d = make_rules(cfg, shape, multi_pod=multi_pod, model_size=md.get("model", 1),
                         dp_size=dp)
    if fsdp_experts_only:
        rules_d["fsdp2"] = None
    rules = AxisRules(rules_d)
    model_size, fsdp = md.get("model", 1), _fsdp_size(cfg, rules, md)
    serve_ff = 0
    if serve_opt and shape.kind != "train":
        fsdp, serve_ff = 0, dp
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    with use_rules(rules_d):
        _, args, cfg, tc = input_specs(arch, shape, cfg)
        if shape.kind == "train":
            state, batch = args
            ps = param_specs(state["params"], cfg, rules, model_size, fsdp)
            sspecs = {"params": ps, "opt": opt_specs(state["opt"], ps, cfg, rules, md,
                                                     tc.zero1), "step": P()}
            if "ef_err" in state:
                sspecs["ef_err"] = ps
            in_sh = (sspecs, batch_specs(cfg, shape, rules))
        elif shape.kind == "prefill":
            params, batch = args
            in_sh = (param_specs(params, cfg, rules, model_size, fsdp, serve_ff),
                     batch_specs(cfg, shape, rules))
        else:
            params, tokens, cache = args
            in_sh = (param_specs(params, cfg, rules, model_size, fsdp, serve_ff),
                     rules.spec(("batch", None)),
                     cache_specs(cache, cfg, rules, long_context=shape.name == "long_500k"))
    return mesh, rules_d, shape, cfg, tc, args, in_sh, fsdp


def _meta_place(x: torch.Tensor, sh: NamedSharding) -> Placed:
    """``place(x, sh, src=None)`` of a meta tensor: each place's block made
    on its place (there are no values to copy)."""
    blocks = []
    for i, dev in enumerate(sh.mesh.devices):
        with at_place(i, forced=True):
            b = torch.empty([s.stop - s.start for s in block_slices(sh, x.shape, i)],
                            dtype=x.dtype, device=dev)
        count_transfer(b, None, i, "place")
        blocks.append(b)
    return Placed(blocks, x.shape, sh)


def from_host(t, specs, mesh):
    """A tree of inputs placed by ``specs`` from the host (JAX's inputs
    arrive sharded: no bytes between places); 0-dim leaves and ``None``
    specs stay as they are."""
    def one(x, s):
        if not (isinstance(x, torch.Tensor) and x.dim() and s is not None):
            return x
        sh = NamedSharding(mesh, s)
        return _meta_place(x, sh) if x.is_meta else place(x, sh, src=None)
    return tree.tree_map(one, t, specs)


def prefill_cache_specs(cfg, shape, rules_d):
    """The specs ``cache_specs`` gives the cache a prefill of ``shape``
    builds (None for an encoder), read from the meta cache's shapes."""
    if cfg.is_encoder:
        return None
    from repro_torch.launch.specs import abstract_cache
    return cache_specs(abstract_cache(cfg, shape.global_batch, shape.seq_len), cfg,
                       AxisRules(rules_d))


def moe_dispatch(shape, in_sh) -> Optional[str]:
    """How the cell's placed step runs a MoE's experts: "local" where
    ``param_specs`` cuts them over the model axis (``moe_ffn_local``'s
    layout: each data replica routes its own tokens, each of its model
    places runs its experts), "dense" where every replica holds them whole
    (``moe_ffn``'s dense dispatch of the replica's tokens); None without
    experts."""
    pspecs = in_sh[0]["params"] if shape.kind == "train" else in_sh[0]
    for path, spec in tree.flatten_with_paths(pspecs):
        if tuple(path[-2:]) == ("moe", "wi"):
            return "local" if any("model" in _spec_axes(e) for e in spec) else "dense"
    return None


def _run_step(mesh, rules_d, shape, cfg, tc, args, in_sh,
              replicas: Optional[int] = None, prefill_cache=None,
              holders: Optional[int] = None, owners: Optional[int] = None):
    """The cell's placed step, once, on its meta inputs placed from the
    host (its last ``replicas`` data replicas; all where None; a decode's
    replicated states updated at home and ``holders`` more of the places
    that hold them, the rest counted alike: ``tensor_parallel.run_holders``;
    with ``owners`` 1 the owners that a gradient's block is gathered to
    counted from one: ``tensor_parallel.alike_owners``)."""
    from repro_torch.models import build_model
    with use_rules(rules_d), set_mesh(mesh), tp.alike_owners(owners == 1):
        if shape.kind == "train":
            state, batch = args
            sspecs, bspecs = in_sh
            step = make_placed_train_step(build_model(cfg, device="meta"), tc, mesh,
                                          sspecs, bspecs, replicas=replicas)
            step(from_host(state, sspecs, mesh), batch)
        elif shape.kind == "prefill":
            params, batch = args
            pspecs, bspecs = in_sh
            tp.make_placed_prefill(cfg, mesh, pspecs, bspecs, prefill_cache, shape.seq_len,
                                   replicas=replicas)(from_host(params, pspecs, mesh), batch)
        else:
            params, tokens, cache = args
            pspecs, tspec, cspecs = in_sh
            kv_seq = rules_d.get("kv_seq") if shape.name == "long_500k" else None
            tp.make_placed_decode(cfg, mesh, pspecs, tspec, kv_seq, replicas=replicas,
                                  holders=holders)(
                from_host(params, pspecs, mesh), tokens, from_host(cache, cspecs, mesh))


def _replica_homes(mesh, shape, in_sh) -> List[int]:
    rows = in_sh[1] if shape.kind == "decode" else next(iter(in_sh[1].values()))
    return tp.Replicas(mesh, rows, shape.global_batch).homes


def layer_period(cfg) -> int:
    """The period of the layer pattern (JAX's ``_scan_period``): layers are
    alike modulo it."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.alt_local_global:
        return 2
    return 1


def extrapolation_depths(cfg) -> Optional[tuple]:
    """The depths (2p, 3p, 4p) at which a cell runs to be continued to its
    own, p its ``layer_period``; None where it runs at its full depth: its
    layers not stacked (the ssm family), not alike in its peak (the
    hybrid's shared block, whose application a period does not add the
    same bytes to the peak each time), not whole periods, or no deeper than
    4p."""
    p, L = layer_period(cfg), cfg.n_layers
    if cfg.family in ("ssm", "hybrid") or L % p or L <= 4 * p:
        return None
    return (2 * p, 3 * p, 4 * p)


def _counts(mesh, rules_d, shape, cfg, tc, args, in_sh, check_flops: bool,
            replicas: Optional[int], holders: Optional[int] = None,
            owners: Optional[int] = None) -> Dict:
    """One run of the cell's placed step under ``PlaceCount`` (its last
    ``replicas`` data replicas, the rest counted from them): FLOPs and the
    peak a place, the bytes and hand-overs by kind."""
    homes = _replica_homes(mesh, shape, in_sh)
    run = len(homes) if replicas is None else min(replicas, len(homes))
    pcs = prefill_cache_specs(cfg, shape, rules_d) if shape.kind == "prefill" else None
    count = PlaceCount(mesh.size)
    reset_transfer_counts()
    fc = FlopCounterMode(display=False) if check_flops else contextlib.nullcontext()
    with fc, count:
        _run_step(mesh, rules_d, shape, cfg, tc, args, in_sh, run, pcs, holders, owners)
    moved = transfer_counts()
    flops, peak = count.flops, list(count.peak)
    counted = int(fc.get_total_flops()) if check_flops else None
    if check_flops and sum(flops) - count.mirrored_flops != counted:
        raise RuntimeError(f"FLOPs a place sum to {sum(flops)}, the counter read {counted}")
    extra = (len(homes) - run) / run
    nbytes, ntimes = dict(moved["bytes"]), dict(moved["count"])
    if extra:
        for scope in ("replica", "sink"):
            sc = moved["scoped"].get(scope, {"bytes": {}, "count": {}})
            for k, v in sc["bytes"].items():
                nbytes[k] += round(v * extra)
            for k, v in sc["count"].items():
                ntimes[k] += round(v * extra)
        first = tp.model_places(mesh, homes[-1])
        rep, base = count.flops_by["replica"], count.base or count.live
        for h in homes[:len(homes) - run]:
            for m, p in enumerate(tp.model_places(mesh, h)):
                flops[p] += rep[first[m]]
                peak[p] = max(peak[p], base[p] + count.rep_peak[first[m]])
        for p, f in enumerate(count.flops_by["sink"]):
            flops[p] += round(f * extra)
    return {"flops": flops, "peak": peak, "one_peak": count.one_peak if not extra else None,
            "counted": counted, "bytes": nbytes, "times": ntimes, "homes": len(homes),
            "run": run}


def _extrapolated(runs: List[Dict], depths, L: int) -> Dict:
    """The counts at depth ``L`` from runs at ``depths`` (equally spaced):
    every count goes the same step from one depth to the next (raises
    where one does not: the layers are then not alike in it), and is
    continued to ``L``."""
    step = depths[1] - depths[0]
    k = (L - depths[-1]) // step

    def one(name, vals):
        if any(v is None for v in vals):
            return None
        d = vals[1] - vals[0]
        if any(b - a != d for a, b in zip(vals[1:], vals[2:])):
            raise ValueError(f"dry run: {name} {vals} at depths {depths} is not linear in depth")
        return vals[-1] + d * k

    out = {key: [one(f"{key}[{i}]", [r[key][i] for r in runs])
                 for i in range(len(runs[0][key]))] for key in ("flops", "peak")}
    for key in ("one_peak", "counted"):
        out[key] = one(key, [r[key] for r in runs])
    for key in ("bytes", "times"):
        kinds = sorted(set().union(*(r[key] for r in runs)))
        out[key] = {kd: one(f"{key}[{kd}]", [r[key].get(kd, 0) for r in runs]) for kd in kinds}
    out.update(homes=runs[0]["homes"], run=runs[0]["run"])
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool, moe_local: bool = False,
               serve_opt: bool = False, fsdp_experts_only: bool = False,
               replicas: Optional[int] = 1, check_flops: bool = True,
               reduce: bool = False, holders: Optional[int] = 1,
               owners: Optional[int] = 1) -> Dict:
    """One cell's record (JAX's keys where they have a counterpart).

    ``moe_local``, ``serve_opt`` and ``fsdp_experts_only`` are JAX's
    variants.  ``serve_opt`` and ``fsdp_experts_only`` change the specs as
    JAX's ``_lower_once`` does.  The placed steps have one MoE layout where
    the experts are cut over the model axis, ``moe_ffn_local``'s (each data
    replica runs its own tokens: JAX's dense dispatch over the whole batch
    has no counterpart), so ``moe_local`` selects it whether set or not and
    raises, as JAX's ``moe_ffn_local`` does, where a MoE's experts are not
    cut over the model axis; ``moe_dispatch`` in the record says which ran.
    ``serve_opt``'s expert ff cut over the data axes is assembled on each
    model place (``fsdp_gather``), where GSPMD would split the product.

    The data replicas of a cell are alike (the same shapes on their own
    places), so by default one runs (the last: its results travel to place 0) and
    the others are counted from it: each place of another replica gets the
    FLOPs and the peak of what the run replica's work made on its place of
    the same model index (over what it held before the replicas began: a
    train step's gradient accumulators at each owner among it), and the
    replicas' hand-overs, to place 0 and of their gradients to each chunk's
    owner (``tensor_parallel.reduce_grads``), count once a replica; the
    gather of each block from its chunks runs once a step.
    ``replicas=None`` runs every replica.  Likewise the places that hold
    copies of a decode's replicated states, each updating its own, are
    alike: home and ``holders`` more run, and each further holder is
    charged the last one's work (``sharding.mirrored``: its FLOPs, its
    memory as it runs, its ``state_in``); ``holders=None`` runs every one.
    So are the owners of one block of a gradient as its chunks are gathered
    to them: one puts its block together and stands for the rest
    (``owners=1``; None runs every one).
    ``check_flops`` runs a ``FlopCounterMode`` around the step too, whose
    total must equal the sum of the places' counts (a third more time).
    ``reduce`` runs the cell cut to test size (``reduced_cell``).

    Where the cell's layers are alike modulo their period p
    (``extrapolation_depths``), the step runs at depths 2p, 3p and 4p
    instead of the cell's L, and every count (each place's FLOPs and peak,
    the bytes and hand-overs by kind) is continued linearly to L, as JAX's
    dry run continues its costs from two depths; a count that does not go
    the same step from 2p to 3p as from 3p to 4p raises."""
    t0 = time.perf_counter()
    flags = dict(moe_local=moe_local, serve_opt=serve_opt,
                 fsdp_experts_only=fsdp_experts_only, reduce=reduce)
    spec = cell_specs(arch, shape_name, multi_pod, **flags)
    mesh, rules_d, shape, cfg, tc, args, in_sh, fsdp = spec
    md = mesh_shape_dict(mesh)
    dispatch = moe_dispatch(shape, in_sh)
    if moe_local and dispatch == "dense":
        raise ValueError(f"moe_local: {arch}'s experts are not cut over the model axis "
                         f"of {dict(mesh.shape)}")
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(f"{k}={v}" for k, v in md.items()),
        "multi_pod": multi_pod, "n_devices": mesh.size,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "train_posture": {"optimizer": tc.optimizer, "param_dtype": tc.param_dtype,
                          "remat": tc.remat, "zero1": tc.zero1, "fsdp": fsdp > 1}
        if shape.kind == "train" else None,
        "arg_bytes_per_device": _arg_bytes(args, in_sh, md),
        "moe_dispatch": dispatch,
    }
    L, depths = cfg.n_layers, extrapolation_depths(cfg)
    if depths is None:
        c = _counts(*spec[:7], check_flops, replicas, holders, owners)
        lowering = "meta_full_depth"
    else:
        del spec, args
        runs = [_counts(*cell_specs(arch, shape_name, multi_pod, **flags, layers=d)[:7],
                        check_flops, replicas, holders, owners) for d in depths]
        c = _extrapolated(runs, depths, L)
        lowering = f"meta_extrapolated(depths={list(depths)},L={L})"
    peak, flops = c["peak"], c["flops"]
    if c["run"] < c["homes"]:
        lowering += f"(replicas={c['run']}/{c['homes']}, the rest alike)"
    largest = max(range(mesh.size), key=lambda i: peak[i])
    record.update({
        "memory": {"peak_bytes_largest_place": peak[largest], "largest_place": largest,
                   "peak_bytes_place0": peak[0], "peak_bytes_one_device": c["one_peak"],
                   "peak_bytes_per_place": peak},
        "flops": {"total": sum(flops), "place0": flops[0], "largest_place": max(flops),
                  "per_place": flops, "counted_run": c["counted"]},
        "transfer_bytes": {**c["bytes"], "total": sum(c["bytes"].values())},
        "transfers": c["times"],
        "replicas": {"all": c["homes"], "run": c["run"]},
        "cost_lowering": lowering,
        "seconds": time.perf_counter() - t0,
    })
    gc.collect()
    return record


def run_cells(archs, shapes, meshes, results_dir, force: bool = False,
              reduce: bool = False) -> List[Dict]:
    """Each cell's record as ``<arch>__<shape>__<singlepod|multipod>.json``
    in ``results_dir`` (kept unless ``force``), a failure's traceback beside
    it as ``.err``; a cell ``skip_reason`` names, ``__skip.json``."""
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    summary = []
    for arch in archs:
        for shape_name in shapes:
            reason = skip_reason(get_arch(arch), SHAPES[shape_name])
            if reason:
                fn = results_dir / f"{arch}__{shape_name}__skip.json"
                fn.write_text(json.dumps({"arch": arch, "shape": shape_name,
                                          "skipped": reason}, indent=1))
                print(f"SKIP  {arch:24s} {shape_name:12s} {reason}")
                continue
            for multi_pod in meshes:
                tag = "multipod" if multi_pod else "singlepod"
                fn = results_dir / f"{arch}__{shape_name}__{tag}.json"
                if fn.exists() and not force:
                    print(f"CACHED {arch:24s} {shape_name:12s} {tag}")
                    continue
                try:
                    rec = lower_cell(arch, shape_name, multi_pod, reduce=reduce)
                    fn.write_text(json.dumps(rec, indent=1))
                    mem = rec["memory"]["peak_bytes_largest_place"] / 2 ** 30
                    print(f"OK    {arch:24s} {shape_name:12s} {tag} "
                          f"mem/place={mem:.2f}GiB flops={rec['flops']['total']:.3g} "
                          f"moved={rec['transfer_bytes']['total'] / 2 ** 30:.2f}GiB "
                          f"[{rec['seconds']:.0f}s]")
                    summary.append(rec)
                except Exception as e:              # noqa: BLE001 (recorded, run goes on)
                    (results_dir / f"{fn.name}.err").write_text(traceback.format_exc())
                    print(f"FAIL  {arch:24s} {shape_name:12s} {tag}: {e}")
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true", help="run only the 2x16x16 mesh")
    ap.add_argument("--single-pod", action="store_true", help="run only the 16x16 mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [True] if args.multi_pod else [False] if args.single_pod else [False, True]
    run_cells(archs, shapes, meshes, os.path.abspath(args.results), force=args.force)


if __name__ == "__main__":
    main()
