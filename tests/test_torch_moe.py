"""PyTorch port, the attention families beyond dense on the CPU, held
against the JAX package: the MoE family (phi3.5-moe and kimi-k2, whose
reduced config keeps a shared expert and clamps top-8 to top-2), the M-RoPE
VLM (qwen2-vl) and the audio encoder (hubert-xlarge: embedding inputs, no
causal mask, no decode step).  JAX's parameters are carried across with
``interop.lm_params_from_arrays``; inputs are drawn with numpy from a seed.

The tolerances, with the errors measured on this CPU (``python
tests/test_torch_moe.py`` prints them):
  * layers (``apply_mrope``, ``layernorm``): 2e-6 relative to the value,
    tests/test_torch_lm.py's LAYER_TOL (4.8e-7, 7.2e-7);
  * forward logits: 2e-5, the dense bound (3.2e-6 to 5.9e-6); the built
    cache's keys and values 2e-5 (4.1e-6 to 9.2e-6); the MoE aux loss
    1e-5 (4.8e-7, on values about 4); ``Model.loss`` 1e-5 (9.5e-7);
  * prefill + decode against the full forward: 1e-5, the JAX package's own
    bound (tests/test_archs.py; 0 on this CPU);
  * the MoE drop case (``capacity_factor=0.5``: 96 tokens give 192 slots,
    about 48 an expert, and C = 24, so 96 slots drop): expert indices equal
    to JAX's for every token whose top-k margin (the least gap between the
    k+1 largest router probabilities) exceeds 1e-6; where every token's
    does (all do here), the rank within the expert and the keep mask equal
    JAX's exactly, the FFN's output within 2e-5 (6.0e-7), gates 2e-5
    (1.8e-7), aux 1e-5 (0);
  * the engine (phi3.5-moe, float32 cache): every prefill's and decode
    step's logits within 2e-5 (4.1e-6), greedy tokens equal.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch import tree
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch.serve import serve_lm
from repro_torch.models import build_model, layers, moe
from test_torch_lm import (DECODE_TOL, LAYER_TOL, LOGIT_TOL, _compare_engines,
                           _max_err, _rel_err)

AUX_TOL = 1e-5
LOSS_TOL = 1e-5
MARGIN = 1e-6
PHI, KIMI, QWEN, HUBERT = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                           "qwen2-vl-72b", "hubert-xlarge")
ARCHS = (PHI, KIMI, QWEN, HUBERT)


def _pair(arch, **kw):
    """The reduced config's JAX model and parameters, and the port's model
    on the CPU with the same parameters."""
    jcfg, cfg = jax_reduced(jax_get_arch(arch), **kw), reduced(get_arch(arch), **kw)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _inputs(cfg, S, seed=1, B=2):
    """(JAX batch, port batch) of token ids, or of frontend embeddings for
    a model that takes them, with labels."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        x = rng.integers(0, cfg.vocab, (B, S))
        jb, tb = {"tokens": jnp.asarray(x, jnp.int32)}, {"tokens": torch.from_numpy(x)}
    else:
        x = rng.standard_normal((B, S, cfg.d_in)).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}
    labels = rng.integers(0, cfg.vocab, (B, S))
    jb["labels"], tb["labels"] = jnp.asarray(labels, jnp.int32), torch.from_numpy(labels)
    return jb, tb


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _layer_errors():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32) * 3
    pos = rng.integers(0, 8208, (2, 9, 3))
    g, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    return {
        "mrope": _rel_err(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                             1e6, (4, 6, 6)),
                          jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                                 1e6, (4, 6, 6))),
        "layernorm": _rel_err(layers.layernorm(torch.from_numpy(x), torch.from_numpy(g),
                                               torch.from_numpy(b)),
                              jax_layers.layernorm(jnp.asarray(x), jnp.asarray(g),
                                                   jnp.asarray(b))),
    }


def test_mrope_and_layernorm_match_jax():
    for name, err in _layer_errors().items():
        assert err <= LAYER_TOL, (name, err)


def test_mrope_is_rope_on_equal_streams_and_checks_sections():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 5, 2, 32)).astype(np.float32))
    pos = torch.arange(5)[None] + 7
    got = layers.apply_mrope(x, pos[..., None].expand(1, 5, 3), 1e4, (4, 6, 6))
    assert float((got - layers.apply_rope(x, pos, 1e4)).abs().max()) == 0.0
    with pytest.raises(ValueError, match="sum to head_dim"):
        layers.apply_mrope(x, pos[..., None].expand(1, 5, 3), 1e4, (4, 6, 5))


# ---------------------------------------------------------------------------
# forward, cache, loss
# ---------------------------------------------------------------------------
def _forward_errors(arch, S=40):
    jm, jp, m, p = _pair(arch)
    cfg = m.cfg
    jb, tb = _inputs(cfg, S)
    build = not cfg.is_encoder
    fw = {k: v for k, v in tb.items() if k != "labels"}
    jl, ja, jc = jm.forward(jp, {k: v for k, v in jb.items() if k != "labels"},
                            build_cache=build, max_seq=48 if build else 0)
    tl, ta, tc = m.forward(p, fw, build_cache=build, max_seq=48 if build else 0)
    assert tl.shape == (2, S, cfg.vocab) and ta.dtype == torch.float32
    errs = {"logits": _max_err(tl, jl), "aux": abs(float(ta) - float(ja))}
    if build:
        jleaves = jax.tree_util.tree_leaves(jc)
        tleaves = tree.leaves(tc)
        assert [tuple(t.shape) for t in tleaves if torch.is_tensor(t)] == \
            [tuple(j.shape) for j in jleaves if j.ndim]
        errs["cache"] = max(_max_err(t, j) for t, j in zip(tleaves, jleaves)
                            if torch.is_tensor(t))
        assert tc["pos"] == int(jc["pos"]) == S
    jloss, jmet = jm.loss(jp, jb)
    tloss, tmet = m.loss(p, tb)
    errs["loss"] = abs(float(tloss) - float(jloss))
    errs["loss_aux"] = abs(float(tmet["aux"]) - float(jmet["aux"]))
    return errs


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_cache_and_loss_match_jax(arch):
    errs = _forward_errors(arch)
    assert errs["logits"] <= LOGIT_TOL, errs
    assert errs["aux"] <= AUX_TOL and errs["loss_aux"] <= AUX_TOL, errs
    assert errs["loss"] <= LOSS_TOL, errs
    assert errs.get("cache", 0.0) <= LOGIT_TOL, errs


def _decode_error(arch, S=20, Sp=16):
    model = build_model(reduced(get_arch(arch)), device="cpu")
    params = model.init_params(0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, model.cfg.vocab, (2, S)))
    full, _, _ = model.forward(params, {"tokens": toks})
    pre, _, cache = model.forward(params, {"tokens": toks[:, :Sp]},
                                  build_cache=True, max_seq=S)
    errs = [float((pre[:, -1:] - full[:, Sp - 1:Sp]).abs().max())]
    for t in range(Sp, S):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        if t < S - 1:
            errs.append(float((lg - full[:, t:t + 1]).abs().max()))
    return max(errs)


@pytest.mark.parametrize("arch", (PHI, KIMI, QWEN))
def test_prefill_decode_matches_full(arch):
    assert _decode_error(arch) < DECODE_TOL


def test_kimi_reduced_keeps_a_shared_expert():
    cfg = reduced(get_arch(KIMI))
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (4, 2, 1)
    p = build_model(cfg, device="cpu").init_params(0)
    lay = p.layers[0].moe
    assert set(lay) == {"router", "wi", "wg", "wo", "shared"}
    assert set(lay["shared"]) == {"wi", "wg", "wo"}
    assert lay["router"].dtype == torch.float32
    # the bf16 model keeps its router in float32, as JAX's does
    pb = build_model(cfg, device="cpu").init_params(0, dtype=torch.bfloat16)
    assert pb.layers[0].moe["router"].dtype == torch.float32
    assert pb.layers[0].moe["wi"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# MoE dispatch: capacity, drops
# ---------------------------------------------------------------------------
def test_capacity_matches_jax():
    for arch in (PHI, KIMI):
        for cf in (0.5, 1.25, 4.0):
            cfg = dataclasses.replace(get_arch(arch), capacity_factor=cf)
            jcfg = dataclasses.replace(jax_get_arch(arch), capacity_factor=cf)
            for n in (1, 4, 16, 100, 2048, 4096):
                c = moe.capacity(cfg, n)
                assert c == jax_moe.capacity(jcfg, n) and c >= 8 and c % 8 == 0


def _drop_case(arch=PHI, N=96, seed=4):
    """moe_ffn on N random tokens at capacity_factor 0.5, both packages,
    with the first layer's carried weights."""
    jm, jp, m, p = _pair(arch, capacity_factor=0.5)
    cfg = m.cfg
    x = np.random.default_rng(seed).standard_normal((2, N // 2, cfg.d_model)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tlp = p.layers[0].moe
    xt = x.reshape(N, -1)
    jg, ji, _ = jax_moe._routing(jnp.asarray(xt), jlp["router"], m.cfg)
    tg, ti, _ = moe._routing(torch.from_numpy(xt), tlp["router"], cfg)
    probs = torch.softmax(torch.from_numpy(xt) @ tlp["router"], -1)
    top = probs.topk(cfg.top_k + 1, -1).values
    margin = (top[:, :-1] - top[:, 1:]).min(-1).values
    decided = (margin > MARGIN).numpy()
    C = moe.capacity(cfg, N)
    jfe, _, jpos, jkeep = jax_moe._dispatch_positions(ji, N, cfg.top_k, cfg.n_experts, C)
    tfe, _, tpos, tkeep = moe._dispatch_positions(ti, N, cfg.top_k, cfg.n_experts, C)
    with moe.count_drops() as drops:
        ty, ta = moe.moe_ffn(tlp, torch.from_numpy(x), cfg)
    jy, ja = jax_moe.moe_ffn(jlp, jnp.asarray(x), m.cfg)
    return {"decided": decided, "idx": (ti.numpy(), np.asarray(ji)),
            "pos": (tpos.numpy(), np.asarray(jpos)), "keep": (tkeep.numpy(), np.asarray(jkeep)),
            "gates": _max_err(tg, jg), "out": _max_err(ty, jy),
            "aux": abs(float(ta) - float(ja)), "drops": [int(d) for d in drops],
            "C": C}


def test_moe_drops_match_jax():
    r = _drop_case()
    ti, ji = r["idx"]
    assert (ti[r["decided"]] == ji[r["decided"]]).all()
    tkeep, jkeep = r["keep"]
    assert r["drops"] == [int((~tkeep).sum())] and r["drops"][0] > 0
    assert r["gates"] <= LOGIT_TOL
    if r["decided"].all():
        assert (r["pos"][0] == r["pos"][1]).all() and (tkeep == jkeep).all()
        assert r["out"] <= LOGIT_TOL and r["aux"] <= AUX_TOL, r
    # each expert keeps exactly min(its slots, C)
    counts = np.bincount(ti.reshape(-1), minlength=4)
    assert int(tkeep.sum()) == int(np.minimum(counts, r["C"]).sum())


def test_model_with_drops_matches_jax():
    """The whole reduced phi3.5-moe at capacity_factor 0.5: logits and aux
    (decode is not compared: dropping depends on the batch's tokens)."""
    jm, jp, m, p = _pair(PHI, capacity_factor=0.5)
    jb, tb = _inputs(m.cfg, 40, seed=5)
    with moe.count_drops() as drops:
        tl, ta, _ = m.forward(p, {"tokens": tb["tokens"]})
    jl, ja, _ = jm.forward(jp, {"tokens": jb["tokens"]})
    assert sum(int(d) for d in drops) > 0 and len(drops) == m.cfg.n_layers
    assert _max_err(tl, jl) <= LOGIT_TOL
    assert abs(float(ta) - float(ja)) <= AUX_TOL


# ---------------------------------------------------------------------------
# VLM positions, the audio encoder
# ---------------------------------------------------------------------------
def test_vlm_positions_match_jax():
    """Three distinct position streams (B, S, 3), the default t = h = w,
    and the flash route (whose masks read the first stream)."""
    jm, jp, m, p = _pair(QWEN)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, m.cfg.vocab, (2, 12))
    pos = np.stack([np.arange(12) + 3, rng.integers(0, 40, 12), rng.integers(0, 40, 12)],
                   -1)[None].repeat(2, 0)
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                               "positions": jnp.asarray(pos, jnp.int32)})
    tb = {"tokens": torch.from_numpy(toks), "positions": torch.from_numpy(pos)}
    tl, _, _ = m.forward(p, tb)
    assert _max_err(tl, jl) <= LOGIT_TOL
    fl, _, _ = m.forward(p, tb, attn_impl="flash")
    assert float((fl - tl).abs().max()) <= LOGIT_TOL
    bad = pos.copy()
    bad[:, 4, 0] = 0
    with pytest.raises(ValueError, match="arange"):
        m.forward(p, {"tokens": tb["tokens"], "positions": torch.from_numpy(bad)},
                  attn_impl="flash")
    from repro_torch.models import transformer as tf
    assert tuple(tf.default_positions(m.cfg, 2, 5).shape) == (2, 5, 3)


def test_audio_encoder_is_bidirectional_and_has_no_decode():
    jm, jp, m, p = _pair(HUBERT)
    rng = np.random.default_rng(7)
    e = torch.from_numpy(rng.standard_normal((1, 10, m.cfg.d_in)).astype(np.float32))
    base, _, _ = m.forward(p, {"embeds": e})
    e2 = e.clone()
    e2[:, -1] += 1.0
    moved, _, _ = m.forward(p, {"embeds": e2})
    assert float((moved[:, 0] - base[:, 0]).abs().max()) > 1e-3    # no causal mask
    toks = rng.integers(0, m.cfg.vocab, (1, 6))
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert _max_err(tl, jl) <= LOGIT_TOL
    for call, jcall in ((lambda: m.decode_step(p, torch.zeros((1, 1), dtype=torch.long), {}),
                         lambda: jm.decode_step(jp, jnp.zeros((1, 1), jnp.int32), {})),
                        (lambda: m.init_cache(1, 8), lambda: jm.init_cache(1, 8))):
        with pytest.raises(ValueError) as got:
            call()
        with pytest.raises(ValueError) as want:
            jcall()
        assert str(got.value) == str(want.value)


def test_serve_launcher_takes_every_family_on_cpu():
    """``--mode lm --arch``: a MoE model serves; hubert ends in the
    ValueError JAX's launcher ends in (its ServeEngine builds a decode
    cache, which an encoder has none of)."""
    args = argparse.Namespace(arch=PHI, reduced=True, device="cpu", seed=0, slots=2,
                              requests=3, prompt_len=8, max_new=3, max_seq=32)
    rec = serve_lm(args)
    assert rec["requests"] == 3 and rec["tokens"] == 9 and rec["arch"] == PHI + "-reduced"
    with pytest.raises(ValueError, match="audio"):
        serve_lm(argparse.Namespace(**{**vars(args), "arch": HUBERT}))


def test_engine_matches_jax_moe():
    jout, tout, err, _, whole = _compare_engines(PHI, 2, 3, 8, 4, "float32")
    assert err <= LOGIT_TOL, err
    assert whole and tout == jout


if __name__ == "__main__":
    for name, err in _layer_errors().items():
        print(f"{name}: {err:.3g} (tol {LAYER_TOL}, relative)")
    for arch in ARCHS:
        print(f"forward {arch}: " + ", ".join(f"{k} {v:.3g}"
                                             for k, v in _forward_errors(arch).items()))
    for arch in (PHI, KIMI, QWEN):
        print(f"prefill+decode {arch}: {_decode_error(arch):.3g} (tol {DECODE_TOL})")
    r = _drop_case()
    print(f"drop case: C={r['C']}, dropped {r['drops']}, all decided "
          f"{bool(r['decided'].all())}, out {r['out']:.3g}, gates {r['gates']:.3g}, "
          f"aux {r['aux']:.3g}")
    print("engine phi3.5-moe f32:", _compare_engines(PHI, 2, 3, 8, 4, "float32")[2:])
