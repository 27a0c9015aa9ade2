"""Arch- and shape-conditional binding of logical axes to mesh axes.

A copy of the JAX package's ``distributed/mesh_rules.py``.  The
logical-rules indirection keeps arch specialisation in ONE place: e.g.
gemma2-2b has 8 q-heads (< model axis 16) so "heads" binds to None
(attention replicated over TP, FFN still sharded); hubert's vocab 504 is not
divisible by 16 so "vocab" unbinds; long_500k has global_batch 1 so "batch"
unbinds and the KV sequence axis binds to the DP axes instead (sequence
parallelism for the half-megatoken cache).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import PRODUCTION_RULES


def make_rules(cfg: ArchConfig, shape: Optional[ShapeConfig] = None,
               multi_pod: bool = False, model_size: int = 16,
               dp_size: Optional[int] = None) -> Dict:
    dp_axes: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    r = dict(PRODUCTION_RULES)
    r["batch"] = dp_axes
    r["expert_cap"] = dp_axes
    r["opt"] = dp_axes
    r["fsdp"] = dp_axes
    r["fsdp2"] = dp_axes
    r["serve_ff"] = dp_axes
    if cfg.n_heads % model_size:
        r["heads"] = None
    if cfg.n_kv_heads % model_size:
        r["kv_heads"] = None
    if cfg.vocab % model_size:
        r["vocab"] = None
    ff = cfg.d_ff_expert if cfg.is_moe else cfg.d_ff
    if ff and ff % model_size:
        r["ff"] = None
    if cfg.is_moe and cfg.n_experts % model_size:
        r["experts"] = None
    d_inner = cfg.ssm_expand * cfg.d_model
    if d_inner % model_size:
        r["ssm_inner"] = None
    if shape is not None:
        dp = dp_size or (32 if multi_pod else 16)
        if shape.kind == "decode":
            # decode dispatch buffers are tiny (C ~= 8): keep the capacity
            # axis unsharded so it never contends with serve_ff's DP binding
            r["expert_cap"] = None
        if shape.global_batch % dp:
            r["batch"] = None
            r["expert_cap"] = None
            r["opt"] = None
            if shape.kind == "decode":
                # sequence parallelism over the KV cache instead
                r["kv_seq"] = dp_axes
    return r
