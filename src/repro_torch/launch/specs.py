"""Per-cell step functions and meta-device inputs for the dry run.

A port of the JAX package's ``launch/specs.py``.  ``input_specs(arch,
shape)`` returns stand-ins for every input of the cell's step, built on
``torch.device("meta")`` (shapes and dtypes, no storage):
  train_*    -> (train_state, {tokens|embeds, labels})     for train_step
  prefill_*  -> (params, batch)                            for prefill_step
  decode_*   -> (params, tokens (B, 1), cache)             for serve_step

Per-arch training posture (applied automatically, as in the JAX package):
  >100B params : bf16 params, adafactor (factored 2nd moment), remat=full,
                 FSDP param sharding over the DP axes, ZeRO-1
  10-100B      : bf16 params, adamw fp32 moments (ZeRO-1 + FSDP), remat=full
  <10B         : fp32 params, adamw, remat=dots, plain DP+TP
The steps returned here are the one-device ones; ``launch/dryrun.py`` runs
their placed counterparts (``make_placed_train_step``,
``tensor_parallel.make_placed_prefill``/``make_placed_decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import flags
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import params_tree
from repro_torch.training.train_step import init_train_state, make_train_step

LONG_CONTEXT_WINDOW = 4096   # sliding window for zamba2 shared attn @ 500k
META = torch.device("meta")


def arch_for_cell(arch_name: str, shape: ShapeConfig) -> ArchConfig:
    cfg = get_arch(arch_name)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, window=LONG_CONTEXT_WINDOW)
    return cfg


def train_config_for(cfg: ArchConfig) -> TrainConfig:
    n = cfg.param_count()
    override = flags.remat_override()
    if override is not None:
        return dataclasses.replace(_base_tc(n), remat=override)
    return _base_tc(n)


def _base_tc(n: float) -> TrainConfig:
    if n > 100e9:
        return TrainConfig(param_dtype="bfloat16", optimizer="adafactor",
                           remat="full", zero1=True)
    if n > 10e9:
        return TrainConfig(param_dtype="bfloat16", optimizer="adamw",
                           opt_state_dtype="float32", remat="full", zero1=True)
    return TrainConfig(param_dtype="float32", optimizer="adamw", remat="dots")


def use_fsdp(cfg: ArchConfig) -> bool:
    return cfg.param_count() > 10e9


def abstract_state(cfg: ArchConfig, tc: TrainConfig) -> Dict:
    """The train state on the meta device (step counters on the host)."""
    return init_train_state(build_model(cfg, device=META), tc)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict:
    """The parameter tree (layers stacked) on the meta device."""
    return params_tree(build_model(cfg, device=META).init_params(0, dtype=dtype))


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16) -> Dict:
    return tf.init_cache(cfg, batch, max_seq, dtype, device=META)


def batch_struct(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META)}
    out = {"labels": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.embed_inputs:
        out["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    else:
        out["embeds"] = torch.empty((B, S, cfg.d_in), dtype=torch.bfloat16, device=META)
    return out


def input_specs(arch_name: str, shape_name, cfg: ArchConfig = None):
    """(step_fn, abstract_inputs tuple, cfg, tc) for one dry-run cell.

    ``cfg`` overrides the registry config (a cut depth or width); the shape
    is a name of ``SHAPES`` or a ``ShapeConfig`` (a cut one)."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if cfg is None:
        cfg = arch_for_cell(arch_name, shape)
    model = build_model(cfg, device=META)
    tc = train_config_for(arch_for_cell(arch_name, shape))

    if shape.kind == "train":
        state = abstract_state(cfg, tc)
        batch = batch_struct(cfg, shape)
        return make_train_step(model, tc), (state, batch), cfg, tc

    if shape.kind == "prefill":
        params = abstract_params(cfg)
        batch = batch_struct(cfg, shape)

        def prefill_step(params, batch):
            logits, aux, cache = tf.forward(params, cfg, batch,
                                            build_cache=not cfg.is_encoder,
                                            max_seq=shape.seq_len)
            return logits[:, -1:], cache

        return prefill_step, (params, batch), cfg, tc

    params = abstract_params(cfg)
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    batch = batch_struct(cfg, shape)

    def serve_step(params, tokens, cache):
        return tf.decode_step(params, cfg, tokens, cache)

    return serve_step, (params, batch["tokens"], cache), cfg, tc
