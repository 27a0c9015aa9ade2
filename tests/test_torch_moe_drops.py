"""PyTorch port against the JAX package: the MoE's dropped token slots over
8 train steps of reduced phi3.5-moe at ``capacity_factor`` 1.0.

JAX's initial train state is carried into the port
(``interop.train_state_from_arrays``); each package then runs its own train
step on the same 8 batches of ``lm_batches`` (float32 compute, AdamW at the
learning rate and warmup of ``chip_smoke.py`` phase ``train_families``: 3e-4,
1).  The port counts each step's dropped slots with ``moe.count_drops()``;
JAX's, which its jitted step does not expose, are recounted from its state
before the step: its forward on the step's batch with ``jax.disable_jit()``
(the layer scan runs in Python) and ``moe_ffn`` wrapped to read the same
routing (``_routing``, ``_dispatch_positions``) before it runs.

Tolerance: per step, the two counts differ by at most DROP_TOL of the
step's token slots (float32 rounding can flip a slot whose top-k
probabilities tie within ~1e-6; none did in the readings below).  ``python
tests/test_torch_moe_drops.py`` prints both packages' counts a step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import lm_batches
from repro_torch.interop import train_state_from_arrays
from repro_torch.models import build_model, moe
from repro_torch.training import make_train_step

torch.set_num_threads(1)
ARCH = "phi3.5-moe-42b-a6.6b"
STEPS, B, S = 8, 8, 64
STEP_KW = dict(learning_rate=3e-4, warmup_steps=1, compute_dtype="float32")
DROP_TOL = 0.01            # of a step's B * S * top_k token slots


def _jax_drops(jm, params, batch) -> int:
    """Dropped slots of JAX's forward on ``batch`` (every MoE layer)."""
    counts = []
    inner = jax_moe.moe_ffn

    def counting(p, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        _, idx, _ = jax_moe._routing(xt, p["router"], cfg)
        C = jax_moe.capacity(cfg, xt.shape[0])
        keep = jax_moe._dispatch_positions(idx, xt.shape[0], cfg.top_k, cfg.n_experts, C)[3]
        counts.append(int(jnp.sum(~keep)))
        return inner(p, x, cfg)

    jax_moe.moe_ffn = counting
    try:
        with jax.disable_jit():
            jm.forward(params, {"tokens": jnp.asarray(batch["tokens"])})
    finally:
        jax_moe.moe_ffn = inner
    return sum(counts)


@functools.lru_cache(maxsize=None)
def drops_both():
    """(port's, JAX's) dropped slots a step, 8 steps each."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCH)), capacity_factor=1.0)
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), capacity_factor=1.0)
    jm, m = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jtc, tc = JaxTrainConfig(**STEP_KW), TrainConfig(**STEP_KW)
    js = jax_init_train_state(jm, jtc, jax.random.PRNGKey(0))
    state = train_state_from_arrays(cfg, tc, jax.tree_util.tree_map(np.asarray, js),
                                    device="cpu")
    jstep, step = jax.jit(jax_make_train_step(jm, jtc)), make_train_step(m, tc)
    port, ref = [], []
    for b in lm_batches(cfg.vocab, B, S, STEPS, seed=3):
        ref.append(_jax_drops(jm, js["params"], b))
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        with moe.count_drops() as dr:
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        port.append(sum(int(d) for d in dr))
    return port, ref, B * S * cfg.top_k * cfg.n_layers


def test_moe_drops_match_jax_step_by_step():
    port, ref, slots = drops_both()
    assert len(port) == len(ref) == STEPS
    assert all(abs(a - b) <= DROP_TOL * slots for a, b in zip(port, ref)), (port, ref)


if __name__ == "__main__":
    port, ref, slots = drops_both()
    for i, (a, b) in enumerate(zip(port, ref)):
        print(f"step {i + 1}: port {a}, jax {b} of {slots} slots")
