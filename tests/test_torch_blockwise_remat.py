"""PyTorch port, blockwise attention's memory plan against the JAX package's.

JAX's ``blockwise_attention`` runs its loop over KV blocks under
``jax.checkpoint``, so no block's scores, probabilities or ``p @ v`` product
is a residual of the backward, whatever remat policy is around the layer.
The port keeps the same plan through ``rematctx.no_residuals``:

  * values: the port's output and its q, k, v gradients against JAX's
    output and ``jax.grad`` of the same function on the same numpy inputs,
    within 1e-5 in float32, under remat "none", "dots" and "full" around
    the call (as the model's layer wraps it), causal and windowed, with and
    without softcap, over a length the blocks do not divide;
  * memory: what the forward leaves the backward, counted on the meta
    device (``launch/dryrun.PlaceCount``) at gemma2-2b's attention widths
    and 4096 tokens, is the output and nothing of a block, under each
    policy;
  * the dry run: a reduced gemma2-2b train cell on the blockwise route (the
    threshold lowered to its 32 tokens, blocks of 8) continued from depths
    4, 6 and 8 equals its run at all 10 layers, and holds less than it
    would with the blocks' products saved.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import rematctx
from repro_torch.launch import dryrun
from repro_torch.models import attention as attn

TOL = 1e-5
B, S, H, K, D, BLOCK = 2, 232, 4, 2, 32, 64        # 232 = 3 blocks of 64 + 40
CASES = [(0, 0.0), (48, 0.0), (48, 30.0), (0, 30.0)]   # (window, softcap)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)   # the cotangent
    return q, k, v, w


@functools.lru_cache(maxsize=None)
def _jax(window, softcap):
    """JAX's output and q, k, v gradients on the case's inputs."""
    q, k, v, w = _inputs(window + int(softcap))
    cfg = dataclasses.replace(jax_reduced(jax_get_arch("gemma2-2b")), attn_softcap=softcap)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def loss(q, k, v):
        out = jax_blockwise(q, k, v, cfg, pos, pos, causal=True, window=window,
                            kv_block=BLOCK)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(t) for t in (out, *grads)]


def _port(q, k, v, w, window, softcap, policy):
    cfg = reduced(get_arch("gemma2-2b"), attn_softcap=softcap)
    pos = torch.arange(S)[None].expand(B, S)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.enable_grad(), rematctx.use_remat(policy):
        body = rematctx.maybe_remat(lambda q, k, v: attn.blockwise_attention(
            q, k, v, cfg, pos, pos, causal=True, window=window, kv_block=BLOCK))
        out = body(*leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    return [t.detach().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("policy", rematctx.POLICIES)
@pytest.mark.parametrize("window,softcap", CASES)
def test_blockwise_and_its_gradients_match_jax(policy, window, softcap):
    want = _jax(window, softcap)
    got = _port(*_inputs(window + int(softcap)), window, softcap, policy)
    for name, g, e in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL, err_msg=name)


def _held_after_forward(policy: str, dtype=torch.bfloat16):
    """(bytes the forward of blockwise attention at gemma2-2b's widths over
    4096 tokens leaves alive for its backward, beside its output; the
    output's bytes; one block's float32 scores), counted on meta."""
    cfg = get_arch("gemma2-2b")
    Bm, Sm, Hm, Km, Dm = 1, 4096, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    count = dryrun.PlaceCount(1)
    with count:
        q = torch.empty(Bm, Sm, Hm, Dm, device="meta", dtype=dtype, requires_grad=True)
        k, v = (torch.empty(Bm, Sm, Km, Dm, device="meta", dtype=dtype, requires_grad=True)
                for _ in range(2))
        pos = torch.empty(Bm, Sm, device="meta", dtype=torch.int64)
        base = count.live[0]
        with torch.enable_grad(), rematctx.use_remat(policy):
            body = rematctx.maybe_remat(lambda q, k, v: attn.blockwise_attention(
                q, k, v, cfg, pos, pos, causal=True, window=cfg.window))
            out = body(q, k, v)
        held = count.live[0] - base
        out.float().sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    return held, out.numel() * out.element_size(), Bm * Hm * Sm * attn.KV_BLOCK * 4


@pytest.mark.parametrize("policy", rematctx.POLICIES)
def test_forward_keeps_no_block_products(policy):
    """Under each policy the forward leaves its backward the output alone
    (q, k, v and the positions were alive before it): no score, probability
    or ``p @ v`` tensor of a block.  Without the repair "none" held all four
    blocks' products (2.50 GB here) and "dots" the scores and ``p @ v`` it
    saves as matrix products (688 MB)."""
    held, out_bytes, block_scores = _held_after_forward(policy)
    assert held == out_bytes, (held, out_bytes)
    assert held < block_scores


def test_no_residuals_checkpoints_only_where_a_gradient_flows(monkeypatch):
    """Outside training (no gradient asked for) ``no_residuals`` runs no
    checkpoint; with a gradient and no remat'ed layer around it, one of its
    own; inside a remat'ed layer none (the layer's is the only one)."""
    calls = []
    real = rematctx.checkpoint
    monkeypatch.setattr(rematctx, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        rematctx.no_residuals(torch.mul, q, q)
    assert calls == []
    with torch.enable_grad():
        out = rematctx.no_residuals(torch.mul, q, q)
    assert calls == [1] and out.requires_grad
    for policy in ("dots", "full"):
        calls.clear()
        with torch.enable_grad(), rematctx.use_remat(policy):
            rematctx.maybe_remat(lambda x: rematctx.no_residuals(torch.mul, x, x))(q)
        assert calls == [1], policy


def _blockwise_cell(monkeypatch):
    """A reduced gemma2-2b train_4k cell of 10 layers whose 32 tokens take
    the blockwise route in blocks of 8; the calls counted."""
    real_reduced, real_blockwise = dryrun.reduced, attn.blockwise_attention
    monkeypatch.setattr(dryrun, "reduced",
                        lambda cfg: dataclasses.replace(real_reduced(cfg), n_layers=10))
    monkeypatch.setattr(attn, "BLOCKWISE_THRESHOLD", 32)
    calls = []

    def blockwise(*a, **kw):
        calls.append(1)
        return functools.partial(real_blockwise, kv_block=8)(*a, **kw)

    monkeypatch.setattr(attn, "blockwise_attention", blockwise)
    return calls


def test_blockwise_train_cell_continued_equals_full_depth(monkeypatch):
    calls = _blockwise_cell(monkeypatch)
    ext = dryrun.lower_cell("gemma2-2b", "train_4k", False, reduce=True, check_flops=False)
    assert calls and ext["train_posture"]["remat"] == "dots"
    with monkeypatch.context() as m:
        m.setattr(dryrun, "extrapolation_depths", lambda cfg: None)
        full = dryrun.lower_cell("gemma2-2b", "train_4k", False, reduce=True,
                                 check_flops=False)
    assert ext["cost_lowering"].startswith("meta_extrapolated(depths=[4, 6, 8],L=10)")
    assert full["cost_lowering"].startswith("meta_full_depth")
    for key in ("memory", "flops", "transfer_bytes", "transfers"):
        assert ext[key] == full[key], key
    # the blocks' products saved (the loop run plainly) hold more at every
    # place, for fewer FLOPs: the backward no longer recomputes them
    monkeypatch.setattr(rematctx, "no_residuals", lambda fn, *a: fn(*a))
    monkeypatch.setattr(dryrun, "extrapolation_depths", lambda cfg: None)
    saved = dryrun.lower_cell("gemma2-2b", "train_4k", False, reduce=True,
                              check_flops=False)
    assert all(a < b for a, b in zip(ext["memory"]["peak_bytes_per_place"],
                                      saved["memory"]["peak_bytes_per_place"]))
    assert ext["flops"]["total"] > saved["flops"]["total"]
