"""Config registry, copied from the JAX package: one module per assigned
architecture.

``get_arch(name)`` resolves an architecture id (e.g. "gemma2-2b") to its
:class:`ArchConfig`; ``ARCHS`` lists all ids; ``skip_reason`` says which
(arch, shape) cells do not run.  The configs are data: every family is
listed, though ``models.build_model`` runs only the dense one so far.
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, TrainConfig, SHAPES, TRAIN_4K, PREFILL_32K,
    DECODE_32K, LONG_500K, reduced,
)
from repro_torch.configs import (  # noqa: F401
    phi35_moe, kimi_k2, zamba2, granite_20b, gemma2_2b, deepseek_7b,
    starcoder2_15b, hubert_xlarge, qwen2_vl_72b, xlstm_125m,
)

_MODULES = {
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "kimi-k2-1t-a32b": kimi_k2,
    "zamba2-2.7b": zamba2,
    "granite-20b": granite_20b,
    "gemma2-2b": gemma2_2b,
    "deepseek-7b": deepseek_7b,
    "starcoder2-15b": starcoder2_15b,
    "hubert-xlarge": hubert_xlarge,
    "qwen2-vl-72b": qwen2_vl_72b,
    "xlstm-125m": xlstm_125m,
}

ARCHS = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    return _MODULES[name].CONFIG


def skip_reason(cfg: ArchConfig, shape: ShapeConfig):
    """None if runnable, else a human-readable skip reason."""
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only arch: no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return "full-attention arch: O(S^2) at 524k; sub-quadratic required"
    return None
