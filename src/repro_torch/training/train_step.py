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
ZeRO-1 (``zero1``) shards optimizer state over a data-parallel mesh axis,
which one device does not have (ROADMAP queue 1 item 12g).  Every family
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


def make_train_step(model: Model, tc: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``; its
    ``compute_grads(params, batch) -> (loss, metrics, grads)`` is the
    gradient half alone."""
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
        gn = global_norm(grads)
        scale = torch.clamp_max(tc.grad_clip / torch.clamp_min(gn, 1e-9), 1.0)
        grads = tree.tree_map(lambda g: g.float().mul_(scale), grads)
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
