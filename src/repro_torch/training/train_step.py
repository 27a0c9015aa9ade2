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

from typing import Dict, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.compression import ef_compress
from repro_torch.distributed.sharding import (Mesh, NamedSharding, Placed, gather,
                                              hand, place)
from repro_torch.models.registry import Model
from repro_torch.models.transformer import params_tree
from repro_torch.training.optim import lr_schedule, make_optimizer, torch_dtype
from repro_torch.training.rematctx import use_remat


def cast_tree(t, dtype):
    return tree.tree_map(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, t)


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


def make_train_step(model: Model, tc: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``; its
    ``compute_grads(params, batch) -> (loss, metrics, grads)`` is the
    gradient half alone, and ``grad_fn`` the same for one microbatch."""
    _, opt_update = make_optimizer(tc)
    compute_dtype = torch_dtype(tc.compute_dtype)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        with torch.enable_grad():
            p = cast_tree(tree.unflatten(params, leaves), compute_dtype)
            with use_remat(tc.remat):
                loss, metrics = model.loss(p, batch)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, grads))

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            return grad_fn(params, batch)
        # split the leading batch dim into microbatches, accumulate in f32
        mb = tc.microbatches
        parts = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                 for k, v in batch.items()}
        acc = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(mb):
            loss, _, grads = grad_fn(params, {k: v[i] for k, v in parts.items()})
            for a, g in zip(tree.leaves(acc), tree.leaves(grads)):
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
    train_step.grad_fn = grad_fn
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


def _write_back(p: Placed, whole: torch.Tensor) -> None:
    """Every place's block of ``p`` overwritten from ``whole`` (on place
    0)."""
    for i, dev in enumerate(p.sharding.mesh.devices):
        p.blocks[i].copy_(hand(whole[p.slices(i)], 0, i, dev))


def make_placed_train_step(model: Model, tc: TrainConfig, mesh: Mesh,
                           state_specs, batch_specs):
    """``train_step(state, batch) -> (state, metrics)`` over ``mesh``: the
    counterpart of JAX's ``jax.jit(step, in_shardings=...)``.

    ``state_specs`` is ``{"params", "opt", "step"}`` of ``P`` trees
    (``distributed/params.param_specs``/``opt_specs``); ``ef_err`` lives as
    the parameters do.  A state of plain tensors is placed on the first call
    (``Placed`` leaves, every place holding its block; the 0-dim step
    counters stay host tensors), and a step updates the blocks in place.
    The batch comes whole and is cut by ``batch_specs``.

    The step: each data replica (a block of the batch's rows, on the first
    place that holds it) gathers the model-axis blocks of every weight and
    runs ``grad_fn`` on its rows, ``tc.microbatches`` microbatches each; the
    gradients are summed at place 0 in replica order and divided as the
    one-device microbatch loop divides them.  What the one-device step takes
    over a whole leaf (int8 error feedback's scale, the clip norm,
    Adafactor's factored means and scales) runs there on the whole reduced
    leaf; AdamW and SGD then update block by block, each place its
    optimizer block (ZeRO-1: 1/D of a leaf), and the updated parameter
    slices are handed to the places that replicate them.  So the step is
    bit for bit the one-device step at ``microbatches`` = replicas x
    ``tc.microbatches`` wherever the device's arithmetic does not depend on
    the tensors' sizes (the CPU).  The dense layers' compute is not split
    over the model axis: the model axis splits storage.  Every byte handed
    between places is counted (``sharding.transfer_counts``)."""
    one = make_train_step(model, tc)
    grad_fn = one.grad_fn
    _, opt_update = make_optimizer(tc)
    devs = mesh.devices
    home = devs[0]
    int8 = tc.grad_compression == "int8_ef"

    def state_shardings(state):
        specs = dict(state_specs)
        if "ef_err" in state:
            specs.setdefault("ef_err", state_specs["params"])
        if set(specs) != set(state):
            raise ValueError(f"state keys {sorted(state)}, specs for {sorted(specs)}")
        return tree.tree_map(
            lambda x, s: None if len(x.shape) == 0 else NamedSharding(mesh, s),
            state, specs)

    def place_batch(batch):
        rows = batch_specs.get("labels", next(iter(batch_specs.values())))
        out = {k: place(v, NamedSharding(mesh, batch_specs.get(k, rows)))
               for k, v in batch.items()}
        lead = [{k: p.slices(i)[0] for k, p in out.items()} for i in range(mesh.size)]
        replicas = {}
        for i, sl in enumerate(lead):
            if len(set(sl.values())) != 1:
                raise ValueError(f"batch keys cut apart on their rows: {sl}")
            replicas.setdefault(next(iter(sl.values())).start, i)
        return out, [replicas[r] for r in sorted(replicas)]

    def compute_grads(params, batch):
        placed, replicas = place_batch(batch)
        k = max(tc.microbatches, 1)
        mb = len(replicas) * k
        acc, loss_acc = None, torch.zeros((), dtype=torch.float32, device=home)
        for q in replicas:
            full = tree.tree_map(lambda p: gather(p, devs[q], dst=q), params)
            share = {key: p.blocks[q] for key, p in placed.items()}
            parts = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                     for key, v in share.items()}
            for j in range(k):
                loss, metrics, grads = grad_fn(full, {key: v[j] for key, v in parts.items()})
                if mb <= 1:
                    return (hand(loss, q, 0, home),
                            {key: hand(v, q, 0, home) for key, v in metrics.items()},
                            [hand(g, q, 0, home) for g in tree.leaves(grads)])
                gl = tree.leaves(grads)
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=torch.float32, device=home) for g in gl]
                for a, g in zip(acc, gl):
                    a.add_(hand(g.float() / mb, q, 0, home))
                del grads, gl
                loss_acc = loss_acc + hand(loss, q, 0, home) / mb
            del full
        return loss_acc, {"ce": loss_acc, "aux": torch.zeros_like(loss_acc)}, acc

    def update_blockwise(pp: Placed, g, opt_blocks, opt_step, lr):
        """AdamW or SGD on every place's optimizer block of one leaf, then
        ZeRO-1's hand-over of the updated slices."""
        regions = [(opt_blocks[0] if opt_blocks else pp).slices(i) for i in range(mesh.size)]
        bases = [pp.slices(i) for i in range(mesh.size)]
        ps, gs = [], []
        for i, dev in enumerate(devs):
            ps.append(pp.blocks[i][_within(regions[i], bases[i])])
            gs.append(hand(g[regions[i]], 0, i, dev))
        opt = {"step": opt_step}
        if opt_blocks:
            opt.update(m=opt_blocks[0].blocks, v=opt_blocks[1].blocks)
        opt_update(gs, opt, ps, lr)
        del gs
        for i, dev in enumerate(devs):
            done = {regions[i]}
            for j in range(mesh.size):
                r = regions[j]
                if r in done or any(a.start < b.start or a.stop > b.stop
                                    for a, b in zip(r, bases[i])):
                    continue
                done.add(r)
                pp.blocks[i][_within(r, bases[i])].copy_(
                    hand(pp.blocks[j][_within(r, bases[j])], j, i, dev))

    @torch.no_grad()
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        state = place_tree(state, state_shardings(state))
        loss, metrics, grads = compute_grads(state["params"], batch)
        p_leaves = tree.leaves(state["params"])
        if int8:
            err = [gather(e, home) for e in tree.leaves(state["ef_err"])]
            grads, new_err = ef_compress(grads, err)
            for e, whole in zip(tree.leaves(state["ef_err"]), new_err):
                _write_back(e, whole)
            del err, new_err
        grads, gn = clip_grads(grads, tc)
        lr = lr_schedule(tc, state["step"])
        opt = state["opt"]
        for n, pp in enumerate(p_leaves):
            g = grads[n]
            grads[n] = None
            if tc.optimizer == "adafactor":
                vr, vc = tree.leaves(opt["vr"])[n], tree.leaves(opt["vc"])[n]
                whole = [gather(t, home) for t in (pp, vr, vc)]
                opt_update([g], {"vr": [whole[1]], "vc": [whole[2]],
                                 "step": opt["step"]}, [whole[0]], lr)
                for t, w in zip((pp, vr, vc), whole):
                    _write_back(t, w)
            else:
                blocks = ((tree.leaves(opt["m"])[n], tree.leaves(opt["v"])[n])
                          if tc.optimizer == "adamw" else ())
                update_blockwise(pp, g, blocks, opt["step"], lr)
            del g
        new_state = {**state, "opt": {**opt, "step": opt["step"] + 1},
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gn, "lr": lr, **metrics}

    train_step.compute_grads = compute_grads
    train_step.place_state = lambda state: place_tree(state, state_shardings(state))
    return train_step
