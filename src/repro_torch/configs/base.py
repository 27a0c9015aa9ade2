"""Architecture and input-shape configuration dataclasses.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of it): every architecture is an :class:`ArchConfig`, every input shape a
:class:`ShapeConfig`, every training run's settings a :class:`TrainConfig`;
all three are frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"   # Mamba2 + shared attention blocks (Zamba2)
SSM = "ssm"         # xLSTM (sLSTM + mLSTM blocks)
AUDIO = "audio"     # encoder-only transformer backbone, stub frontend
VLM = "vlm"         # decoder backbone with M-RoPE, stub vision frontend


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0               # per-expert hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- attention flavour ---
    causal: bool = True
    window: int = 0                    # 0 -> full attention
    alt_local_global: bool = False     # gemma2: even layers local, odd global
    attn_softcap: float = 0.0          # gemma2 attn logit soft-capping
    final_softcap: float = 0.0         # gemma2 final logit soft-capping
    mrope: bool = False                # qwen2-vl multimodal rope (3 sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    rope_theta: float = 10000.0
    # --- SSM / hybrid ---
    ssm_state: int = 0                 # mamba2 state dim
    ssm_heads: int = 0                 # mamba2 heads (0 -> derived)
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0                # hybrid: shared attn block period
    # --- xLSTM ---
    slstm_at: Tuple[int, ...] = ()     # indices of sLSTM blocks; rest mLSTM
    # --- misc ---
    embed_inputs: bool = True          # False -> model consumes embeddings
    embed_scale: bool = False          # gemma2: scale embeddings by sqrt(d)
    d_in: int = 0                      # frontend embedding dim (audio/vlm stub)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                  # mlp activation: silu|gelu|gelu_tanh
    gated_mlp: bool = True             # False: classic 2-matrix MLP (4d)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encoder(self) -> bool:
        return self.family == AUDIO

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameter count N (analytic; matches init exactly)."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d if self.embed_inputs else self.d_in * d
        head = 0 if self.tie_embeddings else self.vocab * d
        per_layer = 0
        if self.family in (DENSE, MOE, AUDIO, VLM):
            attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            nm = 3 if self.gated_mlp else 2
            if self.is_moe:
                ff = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
                ff += self.n_shared_experts * 3 * d * self.d_ff_expert
            else:
                ff = nm * d * self.d_ff
            per_layer = attn + ff + 2 * d  # two rmsnorm gains
            total = self.n_layers * per_layer
        elif self.family == HYBRID:
            total = self.n_layers * (_mamba2_params(self) + 2 * d)
            total += _attn_block_params(self)  # one shared block
        elif self.family == SSM:
            total = 0
            for i in range(self.n_layers):
                total += (_slstm_params(self) if i in self.slstm_at
                          else _mlstm_params(self)) + 2 * d
        else:
            raise ValueError(self.family)
        return total + emb + head + d  # final norm

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts top_k + shared only."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dead = (self.n_experts - self.top_k - self.n_shared_experts)
        return self.param_count() - self.n_layers * dead * 3 * d * self.d_ff_expert


def _mamba2_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nh = cfg.ssm_heads or max(1, d_inner // 64)
    # in_proj -> [z, x, B, C, dt] ; out_proj
    return (d * (2 * d_inner + 2 * cfg.ssm_state + nh)
            + d_inner * d + 2 * nh + d_inner)  # A_log, D, dt_bias-ish


def _attn_block_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d
    return attn + 3 * d * max(cfg.d_ff, 4 * d) + 2 * d


def _mlstm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    d_inner = 2 * d
    return d * d_inner * 2 + d_inner * (3 * d_inner) + 3 * d_inner + d_inner * d


def _slstm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    return 4 * d * d * 2 + 4 * d + 2 * d * int(4 * d * 4 / 3)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer: str = "adamw"           # adamw | adafactor | sgd
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: str = "none"                # none | dots | full
    microbatches: int = 1
    zero1: bool = False                # shard optimizer state over DP axis (a mesh)
    grad_compression: str = "none"     # none | int8_ef
    warmup_steps: int = 100
    seed: int = 0


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != SSM else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        window=min(cfg.window, 64) if cfg.window else 0,
    )
    if cfg.is_moe:
        # capacity_factor high enough that no token ever drops -> decode path
        # is numerically identical to the full pass (tested).
        small.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff_expert=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     capacity_factor=4.0)
    if cfg.family == HYBRID:
        small.update(ssm_state=16, ssm_heads=4, ssm_chunk=16, attn_every=2)
    if cfg.family == SSM:
        small.update(slstm_at=tuple(i for i in cfg.slstm_at if i < 2))
    if cfg.family in (AUDIO, VLM):
        small.update(d_in=64 if cfg.d_in else 0)
    if cfg.mrope:
        small.update(mrope_sections=(4, 6, 6))  # sums to head_dim(32)//2
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **small)
