"""Model registry: resolves an ArchConfig of any family into the model's
functions, on one device."""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable
    forward: Callable
    decode_step: Callable
    init_cache: Callable
    loss: Callable


class _MetaGenerator(torch.Generator):
    """A host generator whose draws land on the meta device: parameters
    with shapes and dtypes and no storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """The model's functions on ``device`` (``cuda`` unless given; raises
    without a card).  ``init_params(seed_or_generator=0, dtype=float32)``
    draws its parameters on that device (on ``"meta"``: shapes only, what
    the spec functions of ``distributed/params.py`` read at full width);
    ``loss(params, batch)`` is ``transformer.lm_loss``."""
    dev = resolve_device(device)

    def init_params(seed: Union[int, torch.Generator] = 0, dtype=torch.float32):
        gen = seed
        if dev.type == "meta":
            gen = _MetaGenerator()
        elif not isinstance(seed, torch.Generator):
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
