"""PyTorch port, the LM serving path on the CPU, held against the JAX
package: configs, layers, the dense transformer's forward (JAX parameters
carried across with ``interop.lm_params_from_arrays``), prefill + decode
against the full forward, the ``ServeEngine`` token for token, and the
``--mode lm`` launcher.

Inputs are drawn with numpy from a seed and handed to both packages.  The
tolerances, with the errors measured on this CPU (``python
tests/test_torch_lm.py`` prints them):
  * layers: 2e-6 relative to the value, about 16 float32 ulps (rmsnorm and
    rope 2.7e-7, softcap 2.5e-7, mlp 2.8e-7);
  * forward logits: 2e-5 (gemma2-2b 1.2e-6 at S=96, deepseek-7b 4.3e-6);
  * prefill + decode vs full forward: 1e-5, the JAX package's own bound
    (tests/test_archs.py; 3.3e-7);
  * engine with float32 caches: every prefill's and decode step's logits
    within 2e-5 (3.5e-6); with the default bfloat16 cache within 4e-3
    (8.5e-4): both packages round the same float32 keys and values to
    bfloat16, and a value that differs by a float32 ulp can round to the
    neighbouring bfloat16 (2^-8 apart); greedy tokens equal wherever the
    JAX side's top-2 margin exceeds the tolerance (one row in the gemma2-2b
    case is within it; its tokens agree all the same).  Where such a near
    tie goes the other way, the comparison stops there.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES
from repro.configs import skip_reason as jax_skip_reason
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models.lm_engine import Request as JaxRequest
from repro.models.lm_engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced, skip_reason
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import build_model, layers
from repro_torch.models.lm_engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
LAYER_TOL = 2e-6        # relative: about 16 float32 ulps
LOGIT_TOL = 2e-5
DECODE_TOL = 1e-5
BF16_CACHE_TOL = 4e-3


def _pair(arch):
    """The reduced config's JAX model and parameters, and the port's model
    on the CPU with the same parameters."""
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    arrays = jax.tree_util.tree_map(np.asarray, jp)
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_arrays(cfg, arrays, device="cpu")


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _rel_err(a, b) -> float:
    """Max abs error relative to the value (at least 1)."""
    b = np.asarray(b, np.float32)
    return float((np.abs(np.asarray(a, np.float32) - b) / np.maximum(np.abs(b), 1)).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_configs_equal_jax():
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        for mk, jmk in ((get_arch, jax_get_arch),
                        (lambda a: reduced(get_arch(a)),
                         lambda a: jax_reduced(jax_get_arch(a)))):
            cfg, jcfg = mk(arch), jmk(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.active_param_count() == jcfg.active_param_count()
        for name in SHAPES:
            assert skip_reason(get_arch(arch), SHAPES[name]) == jax_skip_reason(
                jax_get_arch(arch), JAX_SHAPES[name])


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_arch(a).family != "dense"])
def test_build_model_refuses_unported_families(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(reduced(get_arch(arch)), device="cpu")


def test_entry_points_need_a_card_by_default(monkeypatch):
    cfg = reduced(get_arch("gemma2-2b"))
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, batch_slots=1, max_seq=16)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _layer_errors():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32) * 3
    gain = rng.standard_normal(32).astype(np.float32) * 0.1
    pos = rng.integers(0, 8208, (2, 9))
    tx = torch.from_numpy(x)
    errs = {
        "rmsnorm": _rel_err(layers.rmsnorm(tx, torch.from_numpy(gain)),
                            jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(gain))),
        "rope": _rel_err(layers.apply_rope(tx, torch.from_numpy(pos), 10000.0),
                         jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        "softcap": _rel_err(layers.softcap(tx * 20, 30.0),
                            jax_layers.softcap(jnp.asarray(x) * 20, 30.0)),
    }
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    for gated, act in ((True, "silu"), (True, "gelu_tanh"), (False, "gelu_tanh"),
                       (False, "gelu")):
        p = {"wi": rng.standard_normal((64, 96)).astype(np.float32) / 8,
             "wo": rng.standard_normal((96, 64)).astype(np.float32) / 10}
        if gated:
            p["wg"] = rng.standard_normal((64, 96)).astype(np.float32) / 8
        got = layers.mlp_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(h), act)
        want = jax_layers.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(h), act)
        errs[f"mlp_{'gated' if gated else 'classic'}_{act}"] = _rel_err(got, want)
    return errs


def test_layers_match_jax():
    for name, err in _layer_errors().items():
        assert err <= LAYER_TOL, (name, err)


def test_rope_freqs_and_init_distributions():
    np.testing.assert_allclose(layers.rope_freqs(256, 10000.0).numpy(),
                               np.asarray(jax_layers.rope_freqs(256, 10000.0)),
                               rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 400, 300, torch.float32)
    e = layers.embed_init(gen, 500, 200, torch.float32)
    assert w.shape == (400, 300) and not w.requires_grad
    assert abs(float(w.std()) - 0.05) < 0.001
    assert abs(float(e.std()) - 0.02) < 0.0005


# ---------------------------------------------------------------------------
# forward, prefill + decode
# ---------------------------------------------------------------------------
def _forward_error(arch, S):
    jm, jp, m, p = _pair(arch)
    toks = np.random.default_rng(1).integers(0, m.cfg.vocab, (2, S))
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, S, m.cfg.vocab)
    flash, _, _ = m.forward(p, {"tokens": torch.from_numpy(toks)}, attn_impl="flash")
    return _max_err(tl, jl), float((flash - tl).abs().max())


@pytest.mark.parametrize("arch,S", [("gemma2-2b", 96), ("deepseek-7b", 48)])
def test_forward_matches_jax(arch, S):
    """gemma2 at S=96, so that the reduced window of 64 bites."""
    err, flash_err = _forward_error(arch, S)
    assert err <= LOGIT_TOL, err
    assert flash_err <= LOGIT_TOL, flash_err


def _decode_error(arch, S, Sp):
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


@pytest.mark.parametrize("arch,S,Sp", [("deepseek-7b", 20, 16), ("gemma2-2b", 20, 16),
                                       ("gemma2-2b", 96, 80)])
def test_prefill_decode_matches_full(arch, S, Sp):
    assert _decode_error(arch, S, Sp) < DECODE_TOL


def test_forward_positions_and_impl_checks():
    model = build_model(reduced(get_arch("deepseek-7b")), device="cpu")
    params = model.init_params(0)
    toks = torch.arange(6)[None]
    base, _, _ = model.forward(params, {"tokens": toks})
    shifted, _, _ = model.forward(params, {"tokens": toks,
                                           "positions": torch.arange(6)[None] + 3})
    # RoPE attention depends on relative positions only
    assert float((base - shifted).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="unknown attn_impl"):
        model.forward(params, {"tokens": toks}, attn_impl="sdpa")
    # the kernel's masks are those of arange(S) + c per row: shifted
    # positions take the flash route and give the plain route's logits
    flash, _, _ = model.forward(params, {"tokens": toks,
                                         "positions": torch.arange(6)[None] + 3},
                                attn_impl="flash")
    assert float((flash - shifted).abs().max()) < 1e-4
    two = torch.cat([toks, toks + 1])
    rows = torch.stack([torch.arange(6) + 3, torch.arange(6) + 7])
    flash2, _, _ = model.forward(params, {"tokens": two, "positions": rows},
                                 attn_impl="flash")
    plain2, _, _ = model.forward(params, {"tokens": two, "positions": rows},
                                 attn_impl="plain")
    assert float((flash2 - plain2).abs().max()) < 1e-4
    # other positions raise on the flash route
    for pos in (torch.tensor([[0, 2, 1, 3, 4, 5]]), torch.tensor([[0, 1, 1, 2, 3, 4]])):
        with pytest.raises(ValueError, match="arange"):
            model.forward(params, {"tokens": toks, "positions": pos}, attn_impl="flash")


# ---------------------------------------------------------------------------
# serving engine
# ---------------------------------------------------------------------------
def _recording(fn, log, pick):
    """``fn`` (a forward or decode step) logging the logits it returns,
    ``pick`` (last position of a prefill, every slot of a decode step)."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append(np.asarray(pick(out[0]), np.float32))
        return out
    return wrapped


def _last(logits):
    return logits[:, -1]


def _first(logits):
    return logits[:, 0]


def _engine_logs(arch, slots, n_req, prompt_len, max_new, cache_dtype):
    jm, jp, m, p = _pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, m.cfg.vocab, prompt_len) for _ in range(n_req)]
    jlog, tlog = [], []
    jeng = JaxServeEngine(jm, jp, batch_slots=slots, max_seq=64,
                          cache_dtype=getattr(jnp, cache_dtype))
    jeng.model = dataclasses.replace(jm, forward=_recording(jm.forward, jlog, _last))
    jeng._decode = _recording(jeng._decode, jlog, _first)
    teng = ServeEngine(m, p, batch_slots=slots, max_seq=64, device="cpu",
                       cache_dtype=getattr(torch, cache_dtype))
    teng.model = dataclasses.replace(
        m, forward=_recording(m.forward, tlog, _last),
        decode_step=_recording(m.decode_step, tlog, _first))
    for rid, pr in enumerate(prompts):
        jeng.submit(JaxRequest(rid=rid, prompt=jnp.asarray(pr, jnp.int32),
                               max_new=max_new))
        teng.submit(Request(rid=rid, prompt=torch.from_numpy(pr), max_new=max_new))
    return jeng.run(), teng.run(), jlog, tlog


def _compare_engines(arch, slots, n_req, prompt_len, max_new, cache_dtype):
    """Max logit error over the engine's calls (prefills and decode steps,
    in order), the rows where the JAX side's top-2 margin is within the
    tolerance, and the calls compared.  Greedy tokens must be equal on every
    other row.  Where a near tie went the other way, the two engines feed
    different tokens from there on, so the comparison stops at that call."""
    tol = BF16_CACHE_TOL if cache_dtype == "bfloat16" else LOGIT_TOL
    jout, tout, jlog, tlog = _engine_logs(arch, slots, n_req, prompt_len,
                                          max_new, cache_dtype)
    assert len(jlog) == len(tlog)
    err, near_ties, compared = 0.0, 0, 0
    for jl, tl in zip(jlog, tlog):
        err = max(err, _max_err(tl, jl))
        compared += 1
        top2 = np.sort(jl, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) <= tol
        near_ties += int(tie.sum())
        same = jl.argmax(-1) == tl.argmax(-1)
        assert same[~tie].all()
        if not same.all():
            break
    return jout, tout, err, near_ties, compared == len(jlog)


ENGINE_CASES = [
    ("deepseek-7b", 1, 1, 12, 6),        # tests/test_serving.py, one slot
    ("gemma2-2b", 3, 5, 8, 4),           # three slots, five requests
]


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,slots,n_req,prompt_len,max_new", ENGINE_CASES)
def test_engine_matches_jax(arch, slots, n_req, prompt_len, max_new, cache_dtype):
    jout, tout, err, _, whole = _compare_engines(arch, slots, n_req, prompt_len,
                                                 max_new, cache_dtype)
    assert err <= (BF16_CACHE_TOL if cache_dtype == "bfloat16" else LOGIT_TOL), err
    assert len(tout) == n_req and all(len(v) == max_new for v in tout.values())
    if whole:
        assert tout == jout


def test_engine_stats_and_shared_pos():
    model = build_model(reduced(get_arch("gemma2-2b")), device="cpu")
    eng = ServeEngine(model, model.init_params(0), batch_slots=2, max_seq=64,
                      device="cpu")
    for rid, n in enumerate((5, 9, 7)):
        eng.submit(Request(rid=rid, prompt=torch.arange(1, n + 1), max_new=3))
    out = eng.run()
    assert sorted(out) == [0, 1, 2] and all(len(v) == 3 for v in out.values())
    st = eng.stats
    assert st["prefills"] == 3 and st["prefill_tokens"] == 21
    assert st["decode_tokens"] == 6
    # the third request joined when pos was 9 + 2 steps, and pos is shared
    assert eng.cache["pos"] == 11 + 2


def test_serve_launcher_lm_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["requests"] == 3 and rec["tokens"] == 12
    assert rec["arch"] == "gemma2-2b-reduced" and rec["launches"]["flash_attention"] == 0


if __name__ == "__main__":
    for name, err in _layer_errors().items():
        print(f"{name}: {err:.3g} (tol {LAYER_TOL}, relative)")
    for arch, S in (("gemma2-2b", 96), ("deepseek-7b", 48)):
        err, flash_err = _forward_error(arch, S)
        print(f"forward {arch} S={S}: vs JAX {err:.3g}, flash plain vs dense "
              f"{flash_err:.3g} (tol {LOGIT_TOL})")
    for arch, S, Sp in (("deepseek-7b", 20, 16), ("gemma2-2b", 20, 16), ("gemma2-2b", 96, 80)):
        print(f"prefill+decode {arch} S={S} Sp={Sp}: {_decode_error(arch, S, Sp):.3g} "
              f"(tol {DECODE_TOL})")
    for case in ENGINE_CASES:
        for dt, tol in (("bfloat16", BF16_CACHE_TOL), ("float32", LOGIT_TOL)):
            jout, tout, err, ties, whole = _compare_engines(*case, dt)
            print(f"engine {case} {dt} cache: logits {err:.3g} (tol {tol}), "
                  f"near ties {ties}, all calls compared {whole}, tokens "
                  f"equal {tout == jout}")
