"""Weights and flow state carried into the port as numpy arrays.

A KitNET fitted elsewhere (for example by the JAX package), a flow state
(dense, or a sketch with its scalar ``evict_age``), an LM's parameters and
an LM train state cross as plain dicts of numpy arrays, so the port never
sees another framework's objects:

    net = kitnet_from_arrays({"idx": ..., "W1": ..., ...}, device="cuda")
    state = state_from_arrays({"uni": {...}, "bi": {...}}, device="cuda")
    params = lm_params_from_arrays(cfg, {"embed": ..., "layers": {...}})
    ts = train_state_from_arrays(cfg, tc, {"params": ..., "opt": ..., "step": ...})
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from torch import nn

from repro_torch import tree
from repro_torch.configs.base import HYBRID, SSM, ArchConfig, TrainConfig
from repro_torch.detection.kitnet import KitNet
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Block, Transformer
from repro_torch.training.optim import torch_dtype

PARAM_FIELDS = ("W1", "b1", "W2", "b2", "V1", "c1", "V2", "c2")
KITNET_FIELDS = ("idx", "mask") + PARAM_FIELDS + (
    "norm_min", "norm_max", "out_min", "out_max")


def kitnet_from_arrays(d: Dict[str, np.ndarray],
                       device: DeviceLike = None) -> KitNet:
    """A :class:`KitNet` from the arrays named in ``KITNET_FIELDS``; the
    feature indices ``idx`` must lie in [0, F), F = len(norm_min)."""
    missing = set(KITNET_FIELDS) - set(d)
    if missing:
        raise KeyError(f"KitNET arrays missing {sorted(missing)}")
    dev = resolve_device(device)

    def f32(name):
        return torch.from_numpy(np.array(d[name], np.float32)).to(dev)

    return KitNet(
        idx=torch.from_numpy(np.array(d["idx"], np.int64)).to(dev),
        mask=f32("mask"), params={n: f32(n) for n in PARAM_FIELDS},
        norm_min=f32("norm_min"), norm_max=f32("norm_max"),
        out_min=f32("out_min"), out_max=f32("out_max"))


def kitnet_to_arrays(net: KitNet) -> Dict[str, np.ndarray]:
    """The inverse of :func:`kitnet_from_arrays`."""
    out = {"idx": net.idx, "mask": net.mask, **net.params,
           "norm_min": net.norm_min, "norm_max": net.norm_max,
           "out_min": net.out_min, "out_max": net.out_max}
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def state_from_arrays(nested: Dict, device: DeviceLike = None) -> Dict:
    """A flow state from ``{"uni": {...}, "bi": {...}}`` numpy arrays, plus
    a sketch's scalar ``"evict_age"`` (``rr`` counters as int32, every
    other table and scalar as float32)."""
    dev = resolve_device(device)

    def leaf(k, v):
        return torch.from_numpy(np.array(
            v, np.int32 if k == "rr" else np.float32)).to(dev)

    return {g: ({k: leaf(k, t) for k, t in v.items()} if isinstance(v, dict)
                else leaf(g, v)) for g, v in nested.items()}


def state_to_arrays(state: Dict) -> Dict:
    """The inverse of :func:`state_from_arrays`."""
    def arr(t):
        return t.detach().cpu().numpy()

    return {g: ({k: arr(t) for k, t in v.items()} if isinstance(v, dict)
                else arr(v)) for g, v in state.items()}


def lm_params_from_arrays(cfg: ArchConfig, arrays: Dict,
                          device: DeviceLike = None) -> Transformer:
    """An LM's parameters, of any family, from the JAX package's parameter
    tree as numpy arrays: ``embed`` (V, d), ``final_norm`` (d,), ``lm_head``
    (d, V) unless ``cfg.tie_embeddings``, ``in_proj`` (d_in, d) where the
    model takes embeddings, and the layers.  ``layers`` holds each part
    stacked on a leading L axis: ``ln1``, ``ln2``, ``attn/{wq,wk,wv,wo}`` and
    ``mlp/{wi,wg?,wo}`` or ``moe/{router,wi,wg,wo,shared?/*}`` (attention
    families), or ``ln`` and ``mamba/*`` (hybrid, with ``shared_attn``
    unstacked); the xLSTM's ``blocks`` are a list of ``{ln, cell/*}``.  Every
    weight is stored (d_in, d_out); dtypes are kept."""
    dev = resolve_device(device)

    def part(t, i=None):
        """A weight, or a dict of them, taken at layer ``i`` of its stack
        when ``i`` is given."""
        if isinstance(t, dict):
            return nn.ParameterDict({n: part(w, i) for n, w in t.items()})
        return nn.Parameter(torch.from_numpy(np.array(t if i is None else t[i])).to(dev),
                            requires_grad=False)

    if cfg.family == SSM:
        layers = [Block(ln=part(b["ln"]), cell=part(b["cell"]))
                  for b in arrays["blocks"]]
    else:
        lay = arrays["layers"]
        n = len(lay["ln"] if cfg.family == HYBRID else lay["ln1"])
        layers = [Block(**{name: part(t, i) for name, t in lay.items()})
                  for i in range(n)]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
    shared = arrays.get("shared_attn")
    return Transformer(
        part(arrays["embed"]), part(arrays["final_norm"]), layers,
        None if cfg.tie_embeddings else part(arrays["lm_head"]),
        part(arrays["in_proj"]) if "in_proj" in arrays else None,
        None if shared is None else Block(**{n: part(t) for n, t in shared.items()}))


OPT_KEYS = {"adamw": ("m", "step", "v"), "adafactor": ("step", "vc", "vr"),
            "sgd": ("step",)}


def train_state_from_arrays(cfg: ArchConfig, tc: TrainConfig, arrays: Dict,
                            device: DeviceLike = None) -> Dict:
    """An LM train state (``training.init_train_state``'s layout) from the
    JAX package's train state as numpy arrays: ``params`` (its parameter
    tree, layers stacked on a leading L axis, which the port's train state
    keeps), ``opt`` (``m``/``v``/``step`` for AdamW, ``vr``/``vc``/``step``
    for Adafactor, ``step`` for SGD), ``step``, and ``ef_err`` under int8
    error feedback.  Parameters take ``tc.param_dtype``, AdamW's moments
    ``tc.opt_state_dtype``, Adafactor's and the error float32, on
    ``device``; the steps int32 on the host, where the port's train state
    keeps its counters."""
    dev = resolve_device(device)
    want_opt = OPT_KEYS[tc.optimizer]
    if tuple(sorted(arrays["opt"])) != want_opt:
        raise KeyError(f"{tc.optimizer} state holds {want_opt}, got "
                       f"{tuple(sorted(arrays['opt']))}")
    if ("ef_err" in arrays) != (tc.grad_compression == "int8_ef"):
        raise KeyError(f"ef_err goes with grad_compression='int8_ef', not "
                       f"{tc.grad_compression!r}")
    n_layers = len(arrays["params"]["layers"]["ln1"])
    if n_layers != cfg.n_layers:
        raise ValueError(f"{n_layers} stacked layers for a {cfg.n_layers}-layer "
                         "config")

    def leaves(t, dtype):
        where = "cpu" if dtype == torch.int32 else dev
        return tree.tree_map(
            lambda a: torch.from_numpy(np.array(a)).to(where, dtype), t)

    opt_dtype = {"m": torch_dtype(tc.opt_state_dtype),
                 "v": torch_dtype(tc.opt_state_dtype), "step": torch.int32,
                 "vr": torch.float32, "vc": torch.float32}
    state = {"params": leaves(arrays["params"], torch_dtype(tc.param_dtype)),
             "opt": {k: leaves(v, opt_dtype[k]) for k, v in arrays["opt"].items()},
             "step": leaves(arrays["step"], torch.int32)}
    if "ef_err" in arrays:
        state["ef_err"] = leaves(arrays["ef_err"], torch.float32)
    return state


def train_state_to_arrays(state: Dict) -> Dict:
    """The inverse of :func:`train_state_from_arrays` (bfloat16 leaves as
    float32, which numpy cannot hold)."""
    def arr(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return tree.tree_map(arr, state)
