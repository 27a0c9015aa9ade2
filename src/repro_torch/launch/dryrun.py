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
    out: on one card they are the same memory);
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
or ``make_placed_decode``.  Everything runs at the full depth
(``cost_lowering: "meta_full_depth"``).  A cell ``skip_reason`` names
writes ``<arch>__<shape>__skip.json``.

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
from repro_torch.distributed.sharding import (AxisRules, Mesh, NamedSharding, P, _spec_axes,
                                              current_place, current_scope, place,
                                              reset_transfer_counts, set_mesh,
                                              transfer_counts, use_rules)
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.launch.specs import arch_for_cell, input_specs, use_fsdp
from repro_torch.training.train_step import make_placed_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
INT32_SCALAR = 4      # JAX's cache "pos" is an int32 scalar; the port's an int


# ---------------------------------------------------------------------------
# memory and FLOPs a place
# ---------------------------------------------------------------------------
def _tensors(x, out=None) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (nested lists, tuples
    and dicts)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple, dict)):
                _tensors(v, out)
    elif isinstance(x, dict):
        _tensors(list(x.values()), out)
    return out


class PlaceCount(TorchDispatchMode):
    """Live bytes and FLOPs a place, over every op run inside (see the
    module's docstring for the rules), each also by the step's part
    (``sharding.work_scope``): ``rep_peak`` is the peak a place holds of
    what a replica's own work made (``base`` what it held when the first
    replica began), ``flops_by[scope]`` the FLOPs of each part."""

    def __init__(self, n_places: int):
        super().__init__()
        self.n = n_places
        self.where: Dict[int, tuple] = {}     # storage -> (bytes, place, copy, rep)
        self.live = [0] * n_places
        self.peak = [0] * n_places
        self.rep_live = [0] * n_places
        self.rep_peak = [0] * n_places
        self.base: Optional[List[int]] = None
        self.one = self.one_peak = 0
        self.flops_by = {None: [0] * n_places, "replica": [0] * n_places,
                         "sink": [0] * n_places}

    @property
    def flops(self) -> List[int]:
        return [sum(v[i] for v in self.flops_by.values()) for i in range(self.n)]

    def _release(self, key: int) -> None:
        nbytes, place, copy, rep = self.where.pop(key)
        self.live[place] -= nbytes
        if rep:
            self.rep_live[place] -= nbytes
        if not copy:
            self.one -= nbytes

    def _place_of(self, keys) -> int:
        place, forced, _ = current_place()
        if forced:
            return place
        held = [self.where[k][1] for k in keys if k in self.where]
        if not held or place in held:
            return 0 if place is None else place
        return held[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        keys = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        place = self._place_of(keys)
        scope = current_scope()
        rep = scope == "replica"
        if rep and self.base is None:
            self.base = list(self.live)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops_by[scope][place] += int(fn(*args, **kwargs, out_val=out))
        _, _, alias = current_place()
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.where or key in keys:    # a view or an in-place result
                continue
            nbytes = st.nbytes()
            self.where[key] = (nbytes, place, alias, rep)
            self.live[place] += nbytes
            self.peak[place] = max(self.peak[place], self.live[place])
            if rep:
                self.rep_live[place] += nbytes
                self.rep_peak[place] = max(self.rep_peak[place], self.rep_live[place])
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
    8 rows of at most 32 tokens, and a (4, 2) mesh, (2, 2, 2) multi-pod, of
    meta places (the reduced configs' 4 heads and 2 kv heads divide over
    the 2 model places)."""
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 32), global_batch=8)
    axes, dims = (("pod", "data", "model"), (2, 2, 2)) if multi_pod else \
        (("data", "model"), (4, 2))
    mesh = Mesh(["meta"] * int(np.prod(dims)), axes, dims)
    return reduced(arch_for_cell(arch, SHAPES[shape_name])), shape, mesh


def cell_specs(arch: str, shape_name: str, multi_pod: bool, moe_local: bool = False,
               serve_opt: bool = False, fsdp_experts_only: bool = False,
               reduce: bool = False):
    """Everything a cell runs with: (mesh, rules dict, shape, cfg, tc, args,
    in_shardings, fsdp size), built as JAX's ``_lower_once`` builds them
    (``reduce``: the cell cut to test size, ``reduced_cell``)."""
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


def from_host(t, specs, mesh):
    """A tree of inputs placed by ``specs`` from the host (JAX's inputs
    arrive sharded: no bytes between places); 0-dim leaves and ``None``
    specs stay as they are."""
    return tree.tree_map(lambda x, s: place(x, NamedSharding(mesh, s), src=None)
                         if isinstance(x, torch.Tensor) and x.dim() and s is not None
                         else x, t, specs)


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
              replicas: Optional[int] = None, prefill_cache=None):
    """The cell's placed step, once, on its meta inputs placed from the
    host (its last ``replicas`` data replicas; all where None)."""
    from repro_torch.models import build_model
    with use_rules(rules_d), set_mesh(mesh):
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
            tp.make_placed_decode(cfg, mesh, pspecs, tspec, kv_seq, replicas=replicas)(
                from_host(params, pspecs, mesh), tokens, from_host(cache, cspecs, mesh))


def _replica_homes(mesh, shape, in_sh) -> List[int]:
    rows = in_sh[1] if shape.kind == "decode" else next(iter(in_sh[1].values()))
    return tp.Replicas(mesh, rows, shape.global_batch).homes


def lower_cell(arch: str, shape_name: str, multi_pod: bool, moe_local: bool = False,
               serve_opt: bool = False, fsdp_experts_only: bool = False,
               replicas: Optional[int] = 1, check_flops: bool = True,
               reduce: bool = False) -> Dict:
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
    the same model index (over what it held before
    the replicas began), and the replicas' hand-overs and their sums at
    place 0 count once a replica.  ``replicas=None`` runs every replica.
    ``check_flops`` runs a ``FlopCounterMode`` around the step too, whose
    total must equal the sum of the places' counts (a third more time).
    ``reduce`` runs the cell cut to test size (``reduced_cell``)."""
    t0 = time.perf_counter()
    mesh, rules_d, shape, cfg, tc, args, in_sh, fsdp = cell_specs(
        arch, shape_name, multi_pod, moe_local, serve_opt, fsdp_experts_only, reduce=reduce)
    md = mesh_shape_dict(mesh)
    homes = _replica_homes(mesh, shape, in_sh)
    dispatch = moe_dispatch(shape, in_sh)
    if moe_local and dispatch == "dense":
        raise ValueError(f"moe_local: {arch}'s experts are not cut over the model axis "
                         f"of {dict(mesh.shape)}")
    run = len(homes) if replicas is None else min(replicas, len(homes))
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
    pcs = prefill_cache_specs(cfg, shape, rules_d) if shape.kind == "prefill" else None
    count = PlaceCount(mesh.size)
    reset_transfer_counts()
    fc = FlopCounterMode(display=False) if check_flops else contextlib.nullcontext()
    with fc, count:
        _run_step(mesh, rules_d, shape, cfg, tc, args, in_sh, run, pcs)
    moved = transfer_counts()
    flops, peak = count.flops, list(count.peak)
    counted = int(fc.get_total_flops()) if check_flops else None
    if check_flops and sum(flops) != counted:
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
    largest = max(range(mesh.size), key=lambda i: peak[i])
    record.update({
        "memory": {"peak_bytes_largest_place": peak[largest], "largest_place": largest,
                   "peak_bytes_place0": peak[0],
                   "peak_bytes_one_device": count.one_peak if not extra else None,
                   "peak_bytes_per_place": peak},
        "flops": {"total": sum(flops), "place0": flops[0], "largest_place": max(flops),
                  "per_place": flops, "counted_run": counted},
        "transfer_bytes": {**nbytes, "total": sum(nbytes.values())},
        "transfers": ntimes,
        "replicas": {"all": len(homes), "run": run},
        "cost_lowering": ("meta_full_depth" if not extra else
                          f"meta_full_depth(replicas={run}/{len(homes)}, the rest alike)"),
        "seconds": time.perf_counter() - t0,
    })
    del args, count
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
