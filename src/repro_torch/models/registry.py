"""Model registry: resolves an ArchConfig into the model's functions, on
one device.

The port runs the dense family.  Every other family raises
``NotImplementedError`` naming where ROADMAP.md queues it; nothing else
runs in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.configs.base import (AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
                                      ArchConfig)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf

NOT_PORTED = {
    MOE: "the moe family (models/moe.py) is not ported: ROADMAP queue 1 item 12c",
    HYBRID: "the hybrid family (Mamba2, models/ssm.py) is not ported: "
            "ROADMAP queue 1 item 12d",
    SSM: "the xLSTM family (models/xlstm.py) is not ported: ROADMAP queue 1 "
         "item 12e",
    VLM: "the vlm family (M-RoPE) is not ported: ROADMAP queue 1 item 12f",
    AUDIO: "the audio family (encoder, embedding inputs) is not ported: "
           "ROADMAP queue 1 item 12f",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable
    forward: Callable
    decode_step: Callable
    init_cache: Callable
    loss: Callable


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """The model's functions on ``device`` (``cuda`` unless given; raises
    without a card).  ``init_params(seed_or_generator=0, dtype=float32)``
    draws its parameters on that device; ``loss(params, batch)`` is
    ``transformer.lm_loss``."""
    if cfg.family != DENSE:
        raise NotImplementedError(NOT_PORTED.get(cfg.family, cfg.family))
    dev = resolve_device(device)

    def init_params(seed: Union[int, torch.Generator] = 0, dtype=torch.float32):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return tf.init_params(gen, cfg, dtype)

    return Model(
        cfg=cfg, device=dev, init_params=init_params,
        forward=lambda p, batch, **kw: tf.forward(p, cfg, batch, **kw),
        decode_step=lambda p, tokens, cache: tf.decode_step(p, cfg, tokens, cache),
        init_cache=lambda batch, max_seq, dtype=torch.bfloat16: tf.init_cache(
            cfg, batch, max_seq, dtype, dev),
        loss=lambda p, batch: tf.lm_loss(p, cfg, batch),
    )
