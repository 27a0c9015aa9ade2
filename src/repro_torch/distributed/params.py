"""Parameter / optimizer-state / batch / cache spec inference.

A port of the JAX package's ``distributed/params.py``.  Specs are derived
from leaf *paths* in the parameter tree (``models/transformer.params_tree``:
name-based rules, Megatron-style TP for attention and MLP, EP for the MoE
experts, replication for norms and small SSM blocks) and expressed in
*logical* axis names resolved through ``AxisRules``.  Every function reads
only each leaf's ``shape`` (and ``ndim``), so a tree on the meta device
(``build_model(cfg, device="meta")``) gives kimi-k2's specs without its
1T parameters.  Paths are the port's ``tree.flatten_with_paths`` paths, the
JAX package's key paths (dict keys, list indices).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import AxisRules, P


def _leaf_logical(path: Tuple, leaf, cfg: ArchConfig, model_size: int,
                  fsdp_size: int = 0, serve_ff_size: int = 0):
    """Logical axis names per dimension for one param leaf.

    ``fsdp_size`` > 0 additionally shards one large *unsharded* dim over the
    DP axes ("fsdp" logical name) — ZeRO-3/FSDP posture for >10B archs; the
    per-dim divisibility is checked here so smaller leaves fall back to
    replication automatically.
    """
    names = list(path)
    last = names[-1]
    stacked = "layers" in names
    ndim = len(leaf.shape)
    nd = ndim - (1 if stacked else 0)
    dims = tuple(leaf.shape[-nd:]) if nd else ()

    def fs(dim_idx, name="fsdp2"):
        """FSDP logical axis if that dim is divisible, else None: 2D leaves
        use 'fsdp2', 3D expert leaves 'fsdp' (separately bindable)."""
        if fsdp_size and dims[dim_idx] % fsdp_size == 0 and \
                dims[dim_idx] >= fsdp_size:
            return name
        return None

    def out(*ax):
        ax = list(ax) + [None] * (nd - len(ax))
        if stacked:
            ax = [None] + ax
        return tuple(ax[:ndim])

    kv_ok = cfg.n_kv_heads * cfg.hd % max(model_size, 1) == 0
    if last == "embed":
        return out("vocab", fs(1))
    if last == "lm_head":
        return out(fs(0), "vocab")
    if last in ("wq",):
        return out(fs(0), "heads")
    if last in ("wk", "wv"):
        return out(fs(0), "kv_heads" if kv_ok else None)
    if last == "wo" and nd == 2 and "attn" in names:
        return out("heads", fs(1))
    if last in ("wi", "wg") and nd == 2:
        return out(fs(0), "ff")
    if last == "wo" and nd == 2:
        return out("ff", fs(1))
    if last in ("wi", "wg") and nd == 3:              # MoE experts (E, d, f)
        if serve_ff_size and dims[2] % serve_ff_size == 0:
            # serving posture: 2D expert sharding (E x f)
            return out("experts", None, "serve_ff")
        return out("experts", fs(1, "fsdp"), None)
    if last == "wo" and nd == 3:                      # (E, f, d)
        if serve_ff_size and dims[1] % serve_ff_size == 0:
            return out("experts", "serve_ff", None)
        return out("experts", fs(1, "fsdp"), None)
    if last == "router":
        return out(None, None)
    # SSM / xLSTM / norms / biases / conv: replicated
    return out()


def param_specs(params, cfg: ArchConfig, rules: AxisRules,
                model_size: int, fsdp_size: int = 0, serve_ff_size: int = 0):
    """A ``P`` tree matching ``params`` (shapes are all it reads)."""
    specs = [rules.spec(_leaf_logical(path, leaf, cfg, model_size, fsdp_size,
                                      serve_ff_size))
             for path, leaf in tree.flatten_with_paths(params)]
    return tree.unflatten(params, specs)


def _shard_over_opt(spec: P, shape, rules: AxisRules, opt_axes,
                    mesh_shape: Dict[str, int]):
    """ZeRO-1: additionally shard an optimizer-state leaf over the DP axis
    along its largest dimension that is unsharded and divisible."""
    opt_size = 1
    for a in opt_axes or ():
        opt_size *= mesh_shape[a]
    if opt_size <= 1:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for d in dims:
        for a in (d if isinstance(d, tuple) else (d,)):
            if a is not None:
                used.add(a)
    if any(a in used for a in opt_axes):   # FSDP already uses the DP axes
        return spec
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if dims[i] is None and shape[i] % opt_size == 0 and shape[i] >= opt_size:
            dims[i] = opt_axes if len(opt_axes) > 1 else opt_axes[0]
            return P(*dims)
    return spec


def opt_specs(opt_state, params_specs, cfg: ArchConfig, rules: AxisRules,
              mesh_shape: Dict[str, int], zero1: bool):
    """Specs for the optimizer-state tree ({m, v, step}, Adafactor's
    {vr, vc, step}, SGD's {step})."""
    opt_axes = rules.rules.get("opt")
    if opt_axes is None:
        zero1 = False
    elif isinstance(opt_axes, str):
        opt_axes = (opt_axes,)

    def like_params(t):
        out = []
        for spec, leaf in zip(tree.leaves(params_specs), tree.leaves(t)):
            if zero1:
                spec = _shard_over_opt(spec, tuple(leaf.shape), rules, opt_axes,
                                       mesh_shape)
            out.append(spec)
        return tree.unflatten(t, out)

    specs = {}
    for k, v in opt_state.items():
        if k == "step":
            specs[k] = P()
        elif k in ("m", "v"):
            specs[k] = like_params(v)
        elif k in ("vr", "vc"):
            # Adafactor's factored moments: the parent param's spec minus
            # the factored-out dimension (vr drops the last, vc the
            # second-to-last), so the factored states stay sharded
            drop = -1 if k == "vr" else -2
            out = []
            for spec, leaf in zip(tree.leaves(params_specs), tree.leaves(v)):
                dims = list(spec)
                if len(dims) >= abs(drop) and len(leaf.shape) == len(dims) - 1:
                    del dims[drop]
                    out.append(P(*dims))
                else:
                    out.append(P())
            specs[k] = tree.unflatten(v, out)
        else:
            specs[k] = tree.tree_map(lambda leaf: P(), v)
    return specs


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rules: AxisRules):
    b = rules.rules.get("batch")
    toks = P(b, None)
    out = {"labels": toks}
    if cfg.embed_inputs:
        out["tokens"] = toks
    else:
        out["embeds"] = P(b, None, None)
    if shape.kind == "decode":
        out = {"tokens": toks}
    return out


def cache_specs(cache, cfg: ArchConfig, rules: AxisRules,
                long_context: bool = False):
    """Specs for the decode cache tree.

    When the arch's KV heads cannot shard over the model axis (K % TP != 0:
    gemma2 K=4, qwen2-vl/kimi/phi K=8, granite K=1), the cache SEQUENCE axis
    shards over "model" instead, and decode attention becomes a
    sequence-parallel partial softmax (``distributed/seq_parallel.py``).
    """
    b = rules.rules.get("batch")
    kvh = rules.rules.get("kv_heads")
    seq = rules.rules.get("batch") if long_context else None
    kv_seq_tp = None if kvh is not None else "model"

    def leaf_spec(path, leaf):
        last = path[-1]
        if last in ("k", "v", "attn_k", "attn_v"):
            # (L_or_apps, B, S, K, hd)
            if long_context:
                return P(None, None, seq, kvh, None)
            return P(None, b, kv_seq_tp, kvh, None)
        if last == "pos":
            return P()
        ndim = len(leaf.shape)
        if last in ("ssm",):
            return P(None, b) if ndim > 1 else P()
        if last == "conv":
            return P(None, b)
        # xlstm states (no leading layer axis): batch-shard dim 0
        if ndim >= 1 and last in ("C", "n", "m", "c", "h"):
            return P(b)
        return P(*([None] * ndim))

    return tree.unflatten(cache, [leaf_spec(p, leaf)
                                  for p, leaf in tree.flatten_with_paths(cache)])
