"""Hand-written optimizers, a port of the JAX package's
``training/optim.py``.

Each optimizer is an (init, update) pair over a tree of tensors (the JAX
package's parameter tree, every layer's weights stacked on a leading L
axis).  The statistics JAX takes over a leaf (Adafactor's factoring, update
clip and parameter scale) are therefore taken over all L layers at once,
as there.  ``update`` writes the new parameters and state into the given
tensors in place and returns them, with the JAX package's arithmetic:
float32 math, cast back to each tensor's dtype.  The step counters are
0-dim int32 tensors on the host, as ``torch.optim`` keeps them: the
schedule and the bias corrections are float32 host math that reaches the
device as kernel arguments, and no step waits for the device.
``adafactor_update_placed`` is Adafactor on a leaf held in blocks over a
mesh's places (``training/train_step.make_placed_train_step``), its global
statistics combined from the places' partial sums.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.sharding import Placed, at_place, hand


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _store(dst: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` written into ``dst`` (cast to its dtype); the stored
    tensor."""
    if value is not dst:
        dst.copy_(value)
    return dst


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params, dtype) -> Dict:
    z = lambda p: _zeros(p.shape, dtype, p)  # noqa: E731
    return {"m": tree.tree_map(z, params), "v": tree.tree_map(z, params),
            "step": _step0()}


def adamw_update(grads, opt_state, params, tc: TrainConfig, lr):
    step = opt_state["step"] + 1
    b1, b2 = tc.beta1, tc.beta2
    c1 = float(1 - torch.pow(b1, step.float()))
    c2 = float(1 - torch.pow(b2, step.float()))
    lr = float(lr)
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(opt_state["m"]), tree.leaves(opt_state["v"])):
        g = g.float()
        m32 = _store(m, m.float().mul_(b1).add_(g, alpha=1 - b1)).float()
        v32 = _store(v, v.float().mul_(b2).addcmul_(g, g, value=1 - b2)).float()
        denom = torch.div(v32, c2).sqrt_().add_(tc.eps)
        delta = torch.div(m32, c1).div_(denom)
        del denom
        p32 = p.float()
        delta.add_(p32, alpha=tc.weight_decay)
        _store(p, p32.add_(delta, alpha=-lr))
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum) — Shazeer & Stern 2018
# ---------------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params, dtype) -> Dict:
    def zrow(p):
        return _zeros(p.shape[:-1] if _factored(p.shape) else p.shape,
                      torch.float32, p)

    def zcol(p):
        return _zeros(p.shape[:-2] + p.shape[-1:] if _factored(p.shape) else (1,),
                      torch.float32, p)

    return {"vr": tree.tree_map(zrow, params), "vc": tree.tree_map(zcol, params),
            "step": _step0()}


def adafactor_update(grads, opt_state, params, tc: TrainConfig, lr):
    step = opt_state["step"] + 1
    beta2 = float(1.0 - step.float() ** -0.8)
    lr = float(lr)
    for p, g, vr, vc in zip(tree.leaves(params), tree.leaves(grads),
                            tree.leaves(opt_state["vr"]), tree.leaves(opt_state["vc"])):
        g = g.float()
        g2 = g.square().add_(1e-30)
        if _factored(p.shape):
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(-2))
            del g2
            denom = ((vr[..., None] / torch.clamp_min(
                vr.mean(-1, keepdim=True)[..., None], 1e-30)) * vc[..., None, :])
            u = g / torch.sqrt(torch.clamp_min(denom, 1e-30))
        else:
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            u = g / torch.sqrt(torch.clamp_min(vr, 1e-30))
        # relative-scale update clipping
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u.div_(torch.clamp_min(rms_u, 1.0))
        p32 = p.float()
        scale = torch.clamp_min(torch.sqrt(torch.mean(torch.square(p32))), 1e-3)
        new_p = p32 - (lr * scale) * u - (lr * tc.weight_decay) * p32
        _store(p, new_p)
    return params, {"vr": opt_state["vr"], "vc": opt_state["vc"], "step": step}


def _leaf_means(pl: Placed, local: Callable, dim: Optional[int]) -> List[torch.Tensor]:
    """Each place's share of a mean over a whole leaf held as ``pl`` is:
    ``local(j)`` is place j's value on its block (its shape), and the mean
    is over dimension ``dim`` (kept, size 1) or over every dimension
    (``dim`` None, 0-dim).  Where place i's block spans ``dim`` (every
    dimension) it is the block's own mean, the one-device arithmetic;
    else the partial sums of the distinct blocks that share its other
    coordinates, each taken on its first holder and handed to place i
    (``adafactor``), summed in the order of their slices, over the size."""
    mesh = pl.sharding.mesh
    regions = [pl.slices(i) for i in range(mesh.size)]
    first: Dict = {}
    for j, r in enumerate(regions):
        first.setdefault(r, j)
    nd = len(pl.shape)
    axes = set(range(nd)) if dim is None else {dim % nd}
    size = 1
    for a in axes:
        size *= pl.shape[a]
    partial: Dict[int, torch.Tensor] = {}
    out = []
    for i, r in enumerate(regions):
        peers = sorted((s for s in first if all(s[a] == r[a] for a in range(nd) if a not in axes)),
                       key=lambda s: [x.start for x in s])
        if peers == [r] and all(r[a].stop - r[a].start == pl.shape[a] for a in axes):
            with at_place(i, forced=True):
                x = local(i)
                out.append(torch.mean(x) if dim is None else x.mean(dim, keepdim=True))
            continue
        total = None
        for s in peers:
            j = first[s]
            if j not in partial:
                with at_place(j, forced=True):
                    x = local(j)
                    partial[j] = x.sum() if dim is None else x.sum(dim, keepdim=True)
            part = hand(partial[j], j, i, mesh.devices[i], "adafactor")
            total = part if total is None else total + part
        with at_place(i, forced=True):
            out.append(total / size)
    return out


def _check_block(name: str, t: Placed, i: int, want) -> None:
    if tuple(t.slices(i)) != tuple(want):
        raise ValueError(f"{name} block {t.slices(i)} of place {i} is not its parameter "
                         f"block's {tuple(want)}: the opt specs must follow the param specs")


def adafactor_update_placed(g: Placed, vr: Placed, vc: Placed, p: Placed, opt_step,
                            tc: TrainConfig, lr) -> None:
    """``adafactor_update`` of one leaf held in blocks over places: each
    place updates its parameter block ``p.blocks[i]`` and its ``vr``/``vc``
    blocks (``opt_specs``: the parameter's spec less the factored-out
    dimension) in place from its gradient block ``g.blocks[i]`` (the same
    slices as its parameter block).  The statistics taken over the whole
    leaf, the row and column means of g^2, the mean of ``vr``, the update's
    RMS and the parameter scale, are combined from partial sums over the
    places that cut the dimensions they run over (``_leaf_means``); where a
    place's block spans them they are the one-device arithmetic, so a leaf
    that no place cuts is updated bit for bit as ``adafactor_update`` does.
    ``opt_step`` is the optimizer's step before this update."""
    step = opt_step + 1
    beta2 = float(1.0 - step.float() ** -0.8)
    lr = float(lr)
    n = p.sharding.mesh.size
    regions = [p.slices(i) for i in range(n)]
    for i in range(n):
        _check_block("gradient", g, i, regions[i])
    g32 = [b.float() for b in g.blocks]
    if _factored(p.shape):
        for i, r in enumerate(regions):
            _check_block("vr", vr, i, r[:-1])
            _check_block("vc", vc, i, r[:-2] + r[-1:])
        g2 = lambda i: g32[i].square().add_(1e-30)  # noqa: E731
        rows = _leaf_means(p, g2, -1)
        cols = _leaf_means(p, g2, -2)
        for i in range(n):
            with at_place(i, forced=True):
                r, c = vr.blocks[i], vc.blocks[i]
                r.copy_(beta2 * r + (1 - beta2) * rows[i].squeeze(-1))
                c.copy_(beta2 * c + (1 - beta2) * cols[i].squeeze(-2))
        del rows, cols
        vr_mean = _leaf_means(vr, lambda i: vr.blocks[i], -1)
        u = []
        for i in range(n):
            with at_place(i, forced=True):
                denom = ((vr.blocks[i][..., None] / torch.clamp_min(vr_mean[i][..., None], 1e-30))
                         * vc.blocks[i][..., None, :])
                u.append(g32[i] / torch.sqrt(torch.clamp_min(denom, 1e-30)))
                del denom
    else:
        u = []
        for i, r in enumerate(regions):
            _check_block("vr", vr, i, r)
            with at_place(i, forced=True):
                v = vr.blocks[i]
                v.copy_(beta2 * v + (1 - beta2) * g32[i].square().add_(1e-30))
                u.append(g32[i] / torch.sqrt(torch.clamp_min(v, 1e-30)))
    del g32
    # relative-scale update clipping
    ms = _leaf_means(p, lambda i: torch.square(u[i]), None)
    p2 = _leaf_means(p, lambda i: torch.square(p.blocks[i].float()), None)
    for i in range(n):
        with at_place(i, forced=True):
            rms_u = torch.sqrt(ms[i] + 1e-30)
            u[i].div_(torch.clamp_min(rms_u, 1.0))
            p32 = p.blocks[i].float()
            scale = torch.clamp_min(torch.sqrt(p2[i]), 1e-3)
            new_p = p32 - (lr * scale) * u[i] - (lr * tc.weight_decay) * p32
            u[i] = None
            _store(p.blocks[i], new_p)


# ---------------------------------------------------------------------------
# SGD (momentum-free, for small ablations)
# ---------------------------------------------------------------------------
def sgd_init(params, dtype) -> Dict:
    return {"step": _step0()}


def sgd_update(grads, opt_state, params, tc: TrainConfig, lr):
    lr = float(lr)
    for p, g in zip(tree.leaves(params), tree.leaves(grads)):
        _store(p, p.float() - lr * g.float())
    return params, {"step": opt_state["step"] + 1}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``TrainConfig`` dtype name."""
    return _DTYPES[name]


def make_optimizer(tc: TrainConfig) -> Tuple[Callable, Callable]:
    dtype = torch_dtype(tc.opt_state_dtype)
    if tc.optimizer == "adamw":
        return (lambda p: adamw_init(p, dtype),
                lambda g, s, p, lr: adamw_update(g, s, p, tc, lr))
    if tc.optimizer == "adafactor":
        return (lambda p: adafactor_init(p, dtype),
                lambda g, s, p, lr: adafactor_update(g, s, p, tc, lr))
    if tc.optimizer == "sgd":
        return (lambda p: sgd_init(p, dtype),
                lambda g, s, p, lr: sgd_update(g, s, p, tc, lr))
    raise ValueError(tc.optimizer)


def lr_schedule(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warmup then inverse-sqrt decay (float32, on ``step``'s
    device: the host, in a train state)."""
    s = torch.clamp_min(torch.as_tensor(step).float(), 1.0)
    warm = tc.learning_rate * s / max(tc.warmup_steps, 1)
    decay = tc.learning_rate * torch.sqrt(max(tc.warmup_steps, 1) / s)
    return torch.where(s < tc.warmup_steps, warm, decay)
