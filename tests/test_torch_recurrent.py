"""PyTorch port, the recurrent families on the CPU, held against the JAX
package: the hybrid (zamba2: Mamba2 layers and a shared attention block)
and the xLSTM (xlstm-125m: mLSTM and sLSTM blocks).  JAX's parameters are
carried across with ``interop.lm_params_from_arrays``; inputs are drawn
with numpy from a seed.

The reduced zamba2 has ``ssm_chunk=16``, so S = 5, 12 and 40 run the three
chunk regimes of ``mamba2_fwd``: S < 8 (one chunk of 8, zero-``dt``
padding), 8 <= S < chunk (one chunk of S), and S > chunk (three chunks of 16
with a carried state, padded from 40 to 48).  The mLSTM runs at S = 40 with
``ssm_chunk=16`` (padded to 48 with log_i = -1e30).

The tolerances, with the errors measured on this CPU (``python
tests/test_torch_recurrent.py`` prints them):
  * one Mamba2 layer, output and both states: 1e-5 (1.4e-6 to 2.4e-6);
    one sLSTM step, every carry: 1e-5 (4.8e-7);
  * forward logits: 2e-5, the dense bound (zamba2 5.5e-6 to 6.7e-6, xLSTM
    9.2e-6 and 1.2e-5); the built
    cache (the hybrid's keys, values and Mamba2 states, the xLSTM's cell
    states) 2e-5 (4.5e-6 to 1.1e-5); ``Model.loss`` 1e-5 (9.5e-7);
  * prefill + decode against the full forward: 1e-4, the JAX package's own
    bound for these families (tests/test_archs.py:56; 2.6e-6 to 3.6e-6);
  * the engine with float32 caches (so that the splice of each family's
    cache is covered): every prefill's and decode step's logits within 2e-5
    (zamba2 6.8e-6, xLSTM 1.1e-5), greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import lm_engine as jax_lm_engine
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xlstm
from repro_torch import tree
from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model, ssm, xlstm
from repro_torch.models.lm_engine import _splice_cache
from test_torch_lm import LOGIT_TOL, _compare_engines, _max_err
from test_torch_moe import LOSS_TOL, _inputs, _pair

RECURRENT_DECODE_TOL = 1e-4
LAYER_TOL = 1e-5
ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _mamba2_errors(S):
    """One Mamba2 layer of the reduced zamba2 (chunk 16) on both packages,
    from a zero state and from a random one."""
    jm, jp, m, p = _pair(ZAMBA)
    cfg = m.cfg
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mamba"])
    tlp = p.layers[0].mamba
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
          for k, v in ssm.mamba2_init_state(cfg, 2).items()}
    errs = {}
    for name, state in (("zero", None), ("state", st)):
        jo, jst = jax_ssm.mamba2_fwd(
            jlp, jnp.asarray(u), m.cfg,
            None if state is None else {k: jnp.asarray(v) for k, v in state.items()})
        to, tst = ssm.mamba2_fwd(
            tlp, torch.from_numpy(u), cfg,
            None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
        errs[name] = max(_max_err(to, jo), _max_err(tst["ssm"], jst["ssm"]),
                         _max_err(tst["conv"], jst["conv"]))
    return errs


@pytest.mark.parametrize("S", [5, 12, 40])
def test_mamba2_layer_matches_jax(S):
    for name, err in _mamba2_errors(S).items():
        assert err <= LAYER_TOL, (S, name, err)


def test_segsum_is_the_difference_of_cumulative_sums():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32))
    got = ssm._segsum(x)
    want = np.asarray(jax_ssm._segsum(jnp.asarray(x.numpy())))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    assert _max_err(got.numpy()[fin], want[fin]) <= 1e-6


def _slstm_step_error():
    """One sLSTM step from a random carry: the recurrent term reshaped to
    (B, 4d) before the split, so the gates interleave per head."""
    jm, jp, m, p = _pair(XLSTM)
    cfg = m.cfg
    i = cfg.slstm_at[0]
    jcell, tcell = jp["blocks"][i]["cell"], p.layers[i].cell
    rng = np.random.default_rng(8)
    B, d = 3, cfg.d_model
    carry = [rng.standard_normal((B, d)).astype(np.float32) for _ in range(3)]
    carry.append(rng.standard_normal((B, d)).astype(np.float32) * 2)
    carry[1] = np.abs(carry[1]) + 0.5
    wx = rng.standard_normal((B, 4 * d)).astype(np.float32)
    jc, _ = jax_xlstm._slstm_step(jcell, cfg.n_heads, tuple(map(jnp.asarray, carry)),
                                  jnp.asarray(wx))
    tc = xlstm._slstm_step(tcell, cfg.n_heads, tuple(map(torch.from_numpy, carry)),
                           torch.from_numpy(wx))
    return max(_max_err(t, j) for t, j in zip(tc, jc))


def test_slstm_step_matches_jax():
    assert _slstm_step_error() <= LAYER_TOL


def test_float32_leaves_stay_float32():
    for arch, where in ((ZAMBA, lambda p: p.layers[0].mamba),
                        (XLSTM, lambda p: p.layers[0].cell),
                        (XLSTM, lambda p: p.layers[1].cell)):
        cfg = reduced(get_arch(arch))
        part = where(build_model(cfg, device="cpu").init_params(0, dtype=torch.bfloat16))
        f32 = {n for n, w in part.items() if w.dtype == torch.float32}
        want = {"A_log", "D", "dt_bias"} if "A_log" in part else (
            {"w_if", "b_if"} if "w_if" in part else {"w_gates", "r_gates", "b_gates"})
        assert f32 == want, (arch, f32)


# ---------------------------------------------------------------------------
# forward, cache, loss
# ---------------------------------------------------------------------------
def _forward_errors(arch, S, **kw):
    jm, jp, m, p = _pair(arch, **kw)
    jb, tb = _inputs(m.cfg, S)
    jl, ja, jc = jm.forward(jp, {"tokens": jb["tokens"]}, build_cache=True,
                            max_seq=S + 8)
    tl, ta, tc = m.forward(p, {"tokens": tb["tokens"]}, build_cache=True,
                           max_seq=S + 8)
    tleaves, jleaves = tree.leaves(tc), jax.tree_util.tree_leaves(jc)
    assert [tuple(t.shape) for t in tleaves if torch.is_tensor(t)] == \
        [tuple(j.shape) for j in jleaves if j.ndim]
    assert tc["pos"] == int(jc["pos"]) == S and float(ta) == float(ja) == 0.0
    jloss, _ = jm.loss(jp, jb)
    tloss, _ = m.loss(p, tb)
    return {"logits": _max_err(tl, jl),
            "cache": max(_max_err(t, j) for t, j in zip(tleaves, jleaves)
                         if torch.is_tensor(t)),
            "loss": abs(float(tloss) - float(jloss))}


FORWARD_CASES = [(ZAMBA, 5, {}), (ZAMBA, 12, {}), (ZAMBA, 40, {}),
                 (XLSTM, 40, {"ssm_chunk": 16}), (XLSTM, 12, {})]


@pytest.mark.parametrize("arch,S,kw", FORWARD_CASES)
def test_forward_cache_and_loss_match_jax(arch, S, kw):
    errs = _forward_errors(arch, S, **kw)
    assert errs["logits"] <= LOGIT_TOL and errs["cache"] <= LOGIT_TOL, errs
    assert errs["loss"] <= LOSS_TOL, errs


def _decode_error(arch, S=20, Sp=16, **kw):
    model = build_model(reduced(get_arch(arch), **kw), device="cpu")
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


@pytest.mark.parametrize("arch,S,Sp", [(ZAMBA, 20, 16), (ZAMBA, 44, 37),
                                       (XLSTM, 20, 16)])
def test_prefill_decode_matches_full(arch, S, Sp):
    assert _decode_error(arch, S, Sp) < RECURRENT_DECODE_TOL


def test_init_cache_layouts_match_jax():
    for arch in (ZAMBA, XLSTM):
        jm = jax_build_model(jax_reduced(jax_get_arch(arch)))
        m = build_model(reduced(get_arch(arch)), device="cpu")
        jc = jm.init_cache(3, 24, jnp.bfloat16)
        tc = m.init_cache(3, 24, torch.bfloat16)
        jleaves = [j for j in jax.tree_util.tree_leaves(jc) if j.ndim]
        tleaves = [t for t in tree.leaves(tc) if torch.is_tensor(t)]
        assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in tleaves] == \
            [(tuple(j.shape), str(j.dtype)) for j in jleaves], arch
        assert all(_max_err(t.float(), np.asarray(j, np.float32)) == 0
                   for t, j in zip(tleaves, jleaves))


# ---------------------------------------------------------------------------
# the engine's splice, the engine
# ---------------------------------------------------------------------------
def _random_like(t, rng):
    return rng.standard_normal(t.shape).astype(np.float32)


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_splice_cache_matches_jax(arch):
    """A batch-1 cache into slot 2 of a 4-slot cache, both packages, from
    the same numbers: the hybrid's (L or apps, B, ...) leaves at their
    second axis, the xLSTM's batch-leading states at their first, pos the
    larger."""
    m = build_model(reduced(get_arch(arch)), device="cpu")
    rng = np.random.default_rng(9)
    big, one = m.init_cache(4, 16, torch.float32), m.init_cache(1, 16, torch.float32)
    big_np = tree.tree_map(lambda t: _random_like(t, rng) if torch.is_tensor(t) else t, big)
    one_np = tree.tree_map(lambda t: _random_like(t, rng) if torch.is_tensor(t) else t, one)
    big_np["pos"], one_np["pos"] = 5, 9
    to_t = lambda t: torch.from_numpy(t) if isinstance(t, np.ndarray) else t  # noqa: E731
    to_j = lambda t: jnp.asarray(t) if isinstance(t, np.ndarray) else jnp.int32(t)  # noqa: E731
    got = _splice_cache(tree.tree_map(to_t, big_np), tree.tree_map(to_t, one_np), 2)
    want = jax_lm_engine._splice_cache(tree.tree_map(to_j, big_np),
                                       tree.tree_map(to_j, one_np), 2)
    assert got["pos"] == int(want["pos"]) == 9
    gl = [t for t in tree.leaves(got) if torch.is_tensor(t)]
    wl = [w for w in jax.tree_util.tree_leaves(want) if w.ndim]
    assert len(gl) == len(wl) and all(np.array_equal(g.numpy(), np.asarray(w))
                                      for g, w in zip(gl, wl))


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_engine_matches_jax(arch):
    jout, tout, err, _, whole = _compare_engines(arch, 3, 5, 8, 4, "float32")
    assert err <= LOGIT_TOL, err
    assert len(tout) == 5 and all(len(v) == 4 for v in tout.values())
    if whole:
        assert tout == jout


def _full_width_xlstm_readings(S=2048, n_dec=16):
    """xlstm-125m at full width (``python tests/test_torch_recurrent.py
    --full-width``, about a minute): how far rounding alone moves it, the
    basis of chip_smoke.py's XLSTM_REF_TOL.  The JAX package's and the
    port's prefill + decode against their own full forward, the port
    against JAX with the same weights, a one-ulp nudge of the embeddings,
    and the logit error of three decode-state faults."""
    from repro_torch.interop import lm_params_from_arrays
    cfg = get_arch(XLSTM)
    jm = jax_build_model(jax_get_arch(XLSTM))
    jp = jm.init_params(jax.random.PRNGKey(0))
    p = lm_params_from_arrays(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    m = build_model(cfg, device="cpu")
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (1, S + n_dec))
    tt, jt = torch.from_numpy(toks), jnp.asarray(toks, jnp.int32)
    out = {}
    jfull = np.asarray(jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(jp, jt)[0])
    _, _, jc = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, build_cache=True))(
        jp, jt[:, :S])
    dec = jax.jit(jm.decode_step)
    rows = []
    for i in range(n_dec):
        lg, jc = dec(jp, jt[:, S + i:S + i + 1], jc)
        rows.append(np.asarray(lg[0, 0]))
    out["jax decode vs its full forward"] = _max_err(np.stack(rows), jfull[0, S:])

    def port_decode(fault=None):
        full, _, _ = m.forward(p, {"tokens": tt})
        _, _, cache = m.forward(p, {"tokens": tt[:, :S]}, build_cache=True)
        if fault == "C zeroed":
            cache["states"][0]["C"].zero_()
        if fault == "a block's state reset":
            cache["states"][5] = m.init_cache(1, 8)["states"][5]
        rows = []
        for i in range(n_dec):
            t = S + i + (1 if fault == "a token skipped" and 0 < i < n_dec - 1 else 0)
            lg, cache = m.decode_step(p, tt[:, t:t + 1], cache)
            rows.append(lg[0, 0])
        return _max_err(torch.stack(rows), full[0, S:]), full

    out["port decode vs its full forward"], full = port_decode()
    out["port vs jax, full forward"] = _max_err(full, jfull)
    sign = torch.from_numpy(np.random.default_rng(2).choice([-1.0, 1.0], p.embed.shape)
                            .astype(np.float32))
    emb = p.embed.detach().clone()
    with torch.no_grad():
        p.embed.mul_(1 + sign * 2.0 ** -23)
        out["one-ulp embedding nudge"] = _max_err(m.forward(p, {"tokens": tt})[0], full)
        p.embed.copy_(emb)
    for fault in ("C zeroed", "a block's state reset", "a token skipped"):
        out[f"fault: {fault}"] = port_decode(fault)[0]
    return out


if __name__ == "__main__":
    import sys
    if "--full-width" in sys.argv:
        for name, err in _full_width_xlstm_readings().items():
            print(f"xlstm-125m full width, {name}: {err:.3g}")
        sys.exit(0)
    for S in (5, 12, 40):
        print(f"mamba2 layer S={S}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in _mamba2_errors(S).items()) + f" (tol {LAYER_TOL})")
    print(f"slstm step: {_slstm_step_error():.3g} (tol {LAYER_TOL})")
    for arch, S, kw in FORWARD_CASES:
        print(f"forward {arch} S={S} {kw}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in _forward_errors(arch, S, **kw).items()))
    for arch, S, Sp in ((ZAMBA, 20, 16), (ZAMBA, 44, 37), (XLSTM, 20, 16)):
        print(f"prefill+decode {arch} S={S} Sp={Sp}: {_decode_error(arch, S, Sp):.3g} "
              f"(tol {RECURRENT_DECODE_TOL})")
    for arch in (ZAMBA, XLSTM):
        _, _, err, ties, whole = _compare_engines(arch, 3, 5, 8, 4, "float32")
        print(f"engine {arch} f32: logits {err:.3g} (tol {LOGIT_TOL}), near ties "
              f"{ties}, all calls compared {whole}")
