"""Train step: loss -> grads (remat/microbatch) -> clip -> optimizer.

A port of the JAX package's ``training/train_step.py``, on one device.
The features, all set by ``TrainConfig``:
  * mixed precision: float32 master parameters, the loss computed on a
    ``compute_dtype`` copy whose gradients flow back through the cast;
  * microbatch gradient accumulation (float32, ``g / mb`` a microbatch);
  * remat policies (none | dots | full) applied to each layer's body;
  * int8 error-feedback gradient compression (``distributed/compression``);
  * the global-norm clip and the learning-rate schedule, read at the step
    before it is incremented.
ZeRO-1 (``zero1``) shards optimizer state over a data-parallel mesh axis:
``make_placed_train_step`` runs the step over a mesh, JAX's ``jax.jit(step,
in_shardings=...)``.  Every family
trains through ``model.loss``: its ``ce`` and ``aux`` are the step's
metrics, the MoE's summed aux reaching the loss as ``aux_weight * aux``;
with microbatches each microbatch's loss holds its aux and the reported
``aux`` is 0, as in the JAX package.  A batch holds ``tokens`` or, for a
model that takes embeddings, ``embeds`` (B, S, d_in), with ``labels`` and
an optional ``mask``; the microbatch split cuts every key.

The state is the JAX package's tree: ``{"params", "opt", "step",
"ef_err"?}``, every layer's weights stacked on a leading L axis (the
xLSTM's blocks a list, the hybrid's shared block unstacked), the step
counters 0-dim int32 tensors on the host (``training/optim.py``).  A step
updates it in place and returns it with its metrics (0-dim float32
tensors: ``lr`` on the host, the rest on the parameters' device); nothing
in a step waits for the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.compression import (ef_amax, ef_compress, ef_compress_block,
                                                 ef_scale)
from repro_torch.distributed.sharding import (Mesh, NamedSharding, Placed, at_place,
                                              count_transfer, hand, place, work_scope)
from repro_torch.models.registry import Model
from repro_torch.models.transformer import params_tree
from repro_torch.training.optim import (adafactor_update_placed, lr_schedule, make_optimizer,
                                        torch_dtype)
from repro_torch.training.rematctx import use_remat


def cast_tree(t, dtype):
    """Every floating leaf of ``t`` (a ``tensor_parallel.Blocks``' or
    ``Gathered``'s pieces too) cast to ``dtype``."""
    def one(x):
        lead = x.tensors[0] if isinstance(x, (tp.Blocks, tp.Gathered)) else x
        return x.to(dtype) if torch.is_floating_point(lead) else x
    return tree.tree_map(one, t)


def init_train_state(model: Model, tc: TrainConfig,
                     seed: Union[int, torch.Generator] = 0) -> Dict:
    """The train state on ``model.device`` (its step counters on the host),
    parameters drawn from ``seed``."""
    params = params_tree(model.init_params(seed, dtype=torch_dtype(tc.param_dtype)))
    opt_init, _ = make_optimizer(tc)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if tc.grad_compression == "int8_ef":
        state["ef_err"] = tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
    return state


def global_norm(t) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree.leaves(t)))


def clip_grads(grads, tc: TrainConfig):
    """(the gradients scaled to the global-norm clip, in float32; the
    norm)."""
    gn = global_norm(grads)
    scale = torch.clamp_max(tc.grad_clip / torch.clamp_min(gn, 1e-9), 1.0)
    return tree.tree_map(lambda g: g.float().mul_(scale), grads), gn


def grad_fn(model: Model, tc: TrainConfig, params, batch):
    """(loss, metrics, the gradients of ``tensor_parallel.view_leaves(params)``
    as a list) of one microbatch, the loss on a ``tc.compute_dtype`` copy
    under ``tc.remat``.  ``params`` is a tree of tensors (its leaves in
    ``tree.leaves`` order) or a placed replica's view of one
    (``tensor_parallel.replica_view``: its compute split as the view is)."""
    leaves = [t.detach().requires_grad_(True) for t in tp.view_leaves(params)]
    with torch.enable_grad():
        p = cast_tree(tp.with_leaves(params, leaves), torch_dtype(tc.compute_dtype))
        with use_remat(tc.remat):
            loss, metrics = model.loss(p, batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def make_train_step(model: Model, tc: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``; its
    ``compute_grads(params, batch) -> (loss, metrics, grads)`` is the
    gradient half alone."""
    _, opt_update = make_optimizer(tc)

    def one_grad(params, batch):
        loss, metrics, grads = grad_fn(model, tc, params, batch)
        return loss, metrics, tree.unflatten(params, grads)

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            return one_grad(params, batch)
        # split the leading batch dim into microbatches, accumulate in f32
        mb = tc.microbatches
        parts = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                 for k, v in batch.items()}
        acc = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(mb):
            loss, _, grads = grad_fn(model, tc, params, {k: v[i] for k, v in parts.items()})
            for a, g in zip(tree.leaves(acc), grads):
                a.add_(g.float() / mb)
            del grads
            loss_acc = loss_acc + loss / mb
        return loss_acc, {"ce": loss_acc, "aux": torch.zeros_like(loss_acc)}, acc

    @torch.no_grad()
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, metrics, grads = compute_grads(state["params"], batch)
        if tc.grad_compression == "int8_ef":
            grads, new_err = ef_compress(grads, state["ef_err"])
        grads, gn = clip_grads(grads, tc)
        lr = lr_schedule(tc, state["step"])
        new_params, new_opt = opt_update(grads, state["opt"], state["params"], lr)
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if tc.grad_compression == "int8_ef":
            new_state["ef_err"] = new_err
        out_metrics = {"loss": loss, "grad_norm": gn, "lr": lr, **metrics}
        return new_state, out_metrics

    train_step.compute_grads = compute_grads
    return train_step


# ===========================================================================
# The step placed over a mesh
# ===========================================================================
def _within(region, base):
    """``region`` (slices of a leaf) as slices of the block at ``base``;
    raises if the region is not inside it."""
    if any(r.start < b.start or r.stop > b.stop for r, b in zip(region, base)):
        raise ValueError(f"optimizer block {region} is not inside the parameter "
                         f"block {base}: the opt specs must refine the param specs")
    return tuple(slice(r.start - b.start, r.stop - b.start) for r, b in zip(region, base))


def place_tree(t, shardings):
    """Every tensor leaf of ``t`` placed by the matching ``NamedSharding``
    leaf of ``shardings``; a ``None`` sharding leaves its leaf as it is, and
    a leaf already placed by its sharding passes unchanged."""
    def one(x, sh):
        if sh is None:
            return x
        if isinstance(x, Placed):
            if x.sharding != sh:
                raise ValueError(f"a leaf placed by {x.sharding}, expected {sh}")
            return x
        return place(x, sh)

    return tree.tree_map(one, t, shardings)


def _share(pp: Placed, regions, kind: str) -> None:
    """Each place's block of ``pp`` completed from the places that updated
    the other regions inside it (``regions[j]``: what place j updated),
    copied straight into it and counted under ``kind``: ZeRO-1's
    hand-over."""
    n = pp.sharding.mesh.size
    bases = [pp.slices(i) for i in range(n)]
    for i in range(n):
        done = {regions[i]}
        for j, r in enumerate(regions):
            if r in done or any(a.start < b.start or a.stop > b.stop
                                for a, b in zip(r, bases[i])):
                continue
            done.add(r)
            dst = pp.blocks[i][_within(r, bases[i])]
            count_transfer(dst, j, i, kind)
            with at_place(i, forced=True):
                dst.copy_(pp.blocks[j][_within(r, bases[j])])


def _distinct(g: Placed):
    """(the first holder, its block) of each distinct block of ``g``, in
    place order."""
    seen = set()
    for i, b in enumerate(g.blocks):
        r = g.slices(i)
        if r not in seen:
            seen.add(r)
            yield i, b


def make_placed_train_step(model: Model, tc: TrainConfig, mesh: Mesh,
                           state_specs, batch_specs, replicas: Optional[int] = None):
    """``train_step(state, batch) -> (state, metrics)`` over ``mesh``: the
    counterpart of JAX's ``jax.jit(step, in_shardings=...)``.

    ``state_specs`` is ``{"params", "opt", "step"}`` of ``P`` trees
    (``distributed/params.param_specs``/``opt_specs``); ``ef_err`` lives as
    the parameters do.  A state of plain tensors is placed on the first call
    (``Placed`` leaves, every place holding its block; the 0-dim step
    counters stay host tensors), and a step updates the blocks in place.
    The batch comes whole and is cut by ``batch_specs``.

    The step: each data replica (a block of the batch's rows, on the first
    place that holds it) runs the loss and its gradient on its rows,
    ``tc.microbatches`` microbatches each, with the dense layers' compute
    split over its model places (``distributed/tensor_parallel.py``: each
    place computes with its own blocks of the weights the model axis cuts;
    no such block is gathered whole; FSDP's cuts over the data places are
    assembled per model block, a stacked leaf's one layer at a time).  Each
    microbatch's gradients are reduced to their owners
    (``tensor_parallel.reduce_grads``): every place gets, of every leaf,
    the part that covers its optimizer block (``opt_specs``' m block for
    AdamW, ZeRO-1's 1/D; else its parameter block) from each replica that
    computed it, and adds it as the one-device loop adds a microbatch,
    ``acc += g.float() / mb`` with mb = replicas x ``tc.microbatches``, in
    the loop's order (replica-major, then microbatch); an FSDP piece's part
    comes back to it in the backward.  No place holds a whole gradient of a
    leaf its specs cut.  The leaf-wide work runs on those blocks: int8
    error feedback's scale is the maximum of the blocks' maxima (exact), each
    place compressing its block against its own ``ef_err`` block; the clip
    norm sums each distinct block's sum of squares in leaf and place order
    at place 0; AdamW and SGD update each place's block (ZeRO-1's hand-over
    of the updated slices after), Adafactor through
    ``optim.adafactor_update_placed`` (its means from partial sums).

    So at model size 1 the loss and each place's gradient block are bit for
    bit the one-device step's at ``microbatches`` = replicas x
    ``tc.microbatches`` (its slice of the whole gradient), and so is int8's
    scale, wherever the device's arithmetic does not depend on the tensors'
    sizes (the CPU); the clip norm is its sum of squares in another order
    (float32, within 1e-6 relative; the same sums where no place cuts a
    leaf), and the update is bit for bit the one-device update of the same
    gradients at the placed step's clip scale (Adafactor's where no place
    cuts the leaf; else within its partial sums' rounding).  At model size
    M > 1 the split sums the row-parallel products' partials (and the
    vocab-parallel cross-entropy's terms, and a copied weight's partial
    gradients) in another order, within float32 rounding of it.  Every byte
    handed between places is counted by kind (``sharding.transfer_counts``).
    ``replicas`` runs only the last that many data replicas (their
    gradients divided as if all ran): the dry run on the meta device, whose
    replicas are alike, runs one (``launch/dryrun.py``); each replica's work
    is marked ``work_scope("replica")``, its reduce to the owners
    ``work_scope("sink")``.  The step's two halves are its attributes:
    ``compute_grads(params, batch) -> (loss, metrics, grads)``, the
    gradients a list of ``Placed`` leaves (each place's reduced block), and
    ``apply_grads(state, loss, metrics, grads) -> (state, metrics)``."""
    _, opt_update = make_optimizer(tc)
    n_replicas = replicas
    devs = mesh.devices
    home = devs[0]
    int8 = tc.grad_compression == "int8_ef"
    owner_specs = tree.leaves(state_specs["opt"]["m"] if tc.optimizer == "adamw"
                              else state_specs["params"])
    owners = [NamedSharding(mesh, s) for s in owner_specs]

    def state_shardings(state):
        specs = dict(state_specs)
        if "ef_err" in state:
            specs.setdefault("ef_err", state_specs["params"])
        if set(specs) != set(state):
            raise ValueError(f"state keys {sorted(state)}, specs for {sorted(specs)}")
        return tree.tree_map(
            lambda x, s: None if len(x.shape) == 0 else NamedSharding(mesh, s),
            state, specs)

    def compute_grads(params, batch):
        placed, reps = tp.place_batch(batch, batch_specs, mesh)
        replicas = reps.homes
        k = max(tc.microbatches, 1)
        mb = len(replicas) * k
        n_run = len(replicas) if n_replicas is None else n_replicas
        acc = None if mb <= 1 else tp.owner_blocks(params, owners)
        loss_acc = torch.zeros((), dtype=torch.float32, device=home)
        for q in replicas[len(replicas) - n_run:]:
            with work_scope("replica"):
                view = tp.replica_view(params, mesh, q)
            sources = tp.grad_sources(params, view, q)
            share = {key: p.blocks[q] for key, p in placed.items()}
            parts = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                     for key, v in share.items()}
            for j in range(k):
                with work_scope("replica"), at_place(q):
                    loss, metrics, grads = grad_fn(model, tc, view,
                                                   {key: v[j] for key, v in parts.items()})
                with work_scope("sink"):
                    out = tp.reduce_grads(params, sources, grads, owners, acc, mb)
                    del grads
                    if mb <= 1:
                        return (hand(loss, q, 0, home, "metrics"),
                                {key: hand(v, q, 0, home, "metrics")
                                 for key, v in metrics.items()}, out)
                    loss_acc = loss_acc + hand(loss, q, 0, home, "metrics") / mb
            del view
        return loss_acc, {"ce": loss_acc, "aux": torch.zeros_like(loss_acc)}, acc

    def ef_blocks(g: Placed, err: Placed) -> None:
        """int8 error feedback on each place's block of one leaf: the
        scale from the blocks' maxima, each place's ``ef_err`` block
        updated where it owns the slices, then completed from their
        owners."""
        regions = [g.slices(i) for i in range(mesh.size)]
        errs = [err.blocks[i][_within(regions[i], err.slices(i))] for i in range(mesh.size)]
        amax = None
        for i, b in _distinct(g):
            with at_place(i, forced=True):
                m = hand(ef_amax(b, errs[i]), i, 0, home, "ef_scale")
            amax = m if amax is None else torch.maximum(amax, m)
        scale = ef_scale(amax)
        for i, dev in enumerate(devs):
            with at_place(i, forced=True):
                g.blocks[i], new_err = ef_compress_block(
                    g.blocks[i], errs[i], hand(scale, 0, i, dev, "ef_scale"))
                errs[i].copy_(new_err)
            del new_err
        _share(err, regions, "ef_err")

    def clip(grads):
        """(the global norm of the placed gradients, from each distinct
        block's sum of squares in leaf and place order at place 0); every
        block scaled to the clip in float32."""
        total = None
        for g in grads:
            for i, b in _distinct(g):
                with at_place(i, forced=True):
                    s = hand(torch.sum(torch.square(b.float())), i, 0, home, "grad_norm")
                total = s if total is None else total + s
        gn = torch.sqrt(total)
        scale = torch.clamp_max(tc.grad_clip / torch.clamp_min(gn, 1e-9), 1.0)
        scales = [hand(scale, 0, i, dev, "grad_norm") for i, dev in enumerate(devs)]
        for g in grads:
            for i in range(mesh.size):
                with at_place(i, forced=True):
                    g.blocks[i] = g.blocks[i].float() * scales[i]
        return gn

    def update_blockwise(pp: Placed, g: Placed, opt_blocks, opt_step, lr):
        """AdamW or SGD on every place's optimizer block of one leaf (its
        gradient block), then ZeRO-1's hand-over of the updated slices."""
        regions = [g.slices(i) for i in range(mesh.size)]
        ps = [pp.blocks[i][_within(regions[i], pp.slices(i))] for i in range(mesh.size)]
        opt = {"step": opt_step}
        if opt_blocks:
            opt.update(m=opt_blocks[0].blocks, v=opt_blocks[1].blocks)
        opt_update(g.blocks, opt, ps, lr)
        _share(pp, regions, "zero1_params")

    @torch.no_grad()
    def apply_grads(state: Dict, loss, metrics: Dict, grads) -> Tuple[Dict, Dict]:
        """The step's update of the placed ``state`` by what
        ``compute_grads`` returned (its gradients, each place's block, are
        consumed)."""
        p_leaves = tree.leaves(state["params"])
        if int8:
            for g, e in zip(grads, tree.leaves(state["ef_err"])):
                ef_blocks(g, e)
        gn = clip(grads)
        lr = lr_schedule(tc, state["step"])
        opt = state["opt"]
        for n, pp in enumerate(p_leaves):
            g = grads[n]
            grads[n] = None
            if tc.optimizer == "adafactor":
                adafactor_update_placed(g, tree.leaves(opt["vr"])[n], tree.leaves(opt["vc"])[n],
                                        pp, opt["step"], tc, lr)
            else:
                blocks = ((tree.leaves(opt["m"])[n], tree.leaves(opt["v"])[n])
                          if tc.optimizer == "adamw" else ())
                update_blockwise(pp, g, blocks, opt["step"], lr)
            del g
        new_state = {**state, "opt": {**opt, "step": opt["step"] + 1},
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gn, "lr": lr, **metrics}

    @torch.no_grad()
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        state = place_tree(state, state_shardings(state))
        return apply_grads(state, *compute_grads(state["params"], batch))

    train_step.compute_grads = compute_grads
    train_step.apply_grads = apply_grads
    train_step.place_state = lambda state: place_tree(state, state_shardings(state))
    return train_step
