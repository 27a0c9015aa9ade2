"""PyTorch port, training of the families beyond dense on the CPU, held
against the JAX package's train step: the MoE (phi3.5-moe; kimi-k2, whose
reduced config keeps a shared expert), the hybrid Mamba2 (zamba2), the
xLSTM (xlstm-125m: a list of blocks), the M-RoPE VLM (qwen2-vl) and the
audio encoder (hubert, trained on frontend ``embeds``), each at its reduced
config: the parameter tree, three train steps, every leaf's gradient, the
gradient rules at a tie and under a capacity drop, the depth check of
``interop.train_state_from_arrays`` and checkpoints across the two
packages.  The options (bfloat16, microbatches, remat, Adafactor, int8
error feedback) and the fault loop are in
``test_torch_train_families_options.py``.

JAX's train state is carried into the port with
``interop.train_state_from_arrays``; both packages then take the same numpy
batches (token ids from ``lm_batches``; hubert: seeded normal ``embeds``).
The tolerances, with the errors measured on this CPU (``python
tests/test_torch_train_families.py`` prints them):
  * parameter tree: key paths, shapes and dtypes equal to JAX's
    ``init_params`` (float32 and bfloat16 parameters); JAX's values through
    the port's ``Transformer`` and back equal bit for bit; the port's
    values in JAX's loss against the port's loss 1e-5 relative (7.1e-8);
  * three train steps in float32 compute: loss and MoE aux 1e-5 relative
    (2.2e-7; aux 1.1e-7); grad norm 1e-5 (3.6e-7) but for the xLSTM from
    step 2 on, 5e-5 (6.5e-6, 1.3e-5): AdamW's first step divides g by
    |g| + eps, so the port's and JAX's states after it differ where g is
    near eps, and the xLSTM carries that into the next gradient; JAX
    continued from the port's state after step 1 gives the port's grad
    norms within 1e-5 (1.9e-7, 1.5e-6;
    ``test_xlstm_grad_norm_gap_is_the_carried_state``).  Parameters within
    tests/test_torch_training.py's envelope: atol 1e-5 + rtol 1e-5 but
    for at most 1e-4 of them (1.0e-5), every one within 2 * sum(lr) (1.4e-4
    of 4e-3);
  * every leaf's gradient (each layer's slice of a stacked leaf) against
    JAX's: 1e-5 of the leaf's largest (6.0e-6); finite, and nonzero but
    for hubert's ``embed`` under ``embeds`` input, zero in JAX too;
  * the sLSTM's h = o c / max(n, 1e-6) at a tie n = 1e-6: the gradient
    split as JAX splits it, 1e-6 relative (3.0e-7);
  * the MoE drop case (``capacity_factor=0.5``; every token's top-k
    margin past 1e-6): gradients of the input and every weight 2e-5 of
    the largest (3.0e-7);
  * checkpoints: bit for bit across the packages, and the next step's
    loss and grad norm as the train steps'.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models import xlstm as jax_xlstm
from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import lm_batches
from repro_torch.interop import (lm_params_from_arrays, train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.models import build_model, moe, xlstm
from repro_torch.models import transformer as tf
from repro_torch.training import CheckpointManager, init_train_state, make_train_step
from test_torch_training import F32_SHARE, F32_TOL, _flat, _jbatch, _np, _rel, _tbatch

PHI, KIMI, ZAMBA, XLSTM, QWEN, HUBERT = (
    "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "zamba2-2.7b", "xlstm-125m",
    "qwen2-vl-72b", "hubert-xlarge")
ARCHS = (PHI, KIMI, ZAMBA, XLSTM, QWEN, HUBERT)
STEP_KW = dict(compute_dtype="float32", learning_rate=1e-3, warmup_steps=2)
B, S = 8, 32
XLSTM_GN_TOL = 5e-5
GRAD_TOL = 1e-5
TIE_TOL = 1e-6
DROP_GRAD_TOL = 2e-5
MARGIN = 1e-6
# zero by design: hubert's token embedding, under embeds input
ZERO_BY_DESIGN = {HUBERT: {"embed"}}


def _pair(arch, **kw):
    return (jax_build_model(jax_reduced(jax_get_arch(arch), **kw)),
            build_model(reduced(get_arch(arch), **kw), device="cpu"))


def _batches(cfg, n, seed=1, seq=S):
    """``n`` numpy batches of ``lm_batches``' tokens and labels; for a model
    that takes embeddings, seeded normal ``embeds`` (B, seq, d_in) with the
    labels."""
    rng = np.random.default_rng(100 + seed)
    out = []
    for b in lm_batches(cfg.vocab, B, seq, n, seed=seed):
        if not cfg.embed_inputs:
            b = {"embeds": rng.standard_normal((B, seq, cfg.d_in)).astype(np.float32),
                 "labels": b["labels"]}
        out.append(b)
    return out


_RUNS = {}


def jax_run(arch, n=3, **kw):
    """JAX's train state before and after each of ``n`` steps, its metrics
    and its jitted step, for ``arch`` reduced under ``STEP_KW`` + ``kw``
    (one compile per case a process)."""
    key = (arch, n, tuple(sorted(kw.items())))
    if key not in _RUNS:
        kw = {**STEP_KW, **kw}
        jm, m = _pair(arch)
        jtc = JaxTrainConfig(**kw)
        js = jax_init_train_state(jm, jtc, jax.random.PRNGKey(0))
        step = jax.jit(jax_make_train_step(jm, jtc))
        batches = _batches(m.cfg, n)
        states, metrics = [_np(js)], []
        for b in batches:
            js, met = step(js, _jbatch(b))
            states.append(_np(js))
            metrics.append({k: float(v) for k, v in met.items()})
        _RUNS[key] = (TrainConfig(**kw), m, batches, states, metrics, step)
    return _RUNS[key]


def param_errors(state, want_state):
    """(max abs error, share past atol 1e-5 + rtol 1e-5) of the parameters."""
    got, want = _flat(train_state_to_arrays(state["params"])), _flat(want_state["params"])
    d = np.abs(got - want)
    return float(d.max()), float((d > F32_TOL + F32_TOL * np.abs(want)).mean())


def port_steps(arch, **kw):
    """The port's steps from JAX's initial state, chained; per step its
    metrics' relative errors and the parameters' errors against JAX."""
    tc, m, batches, states, metrics, _ = jax_run(arch, **kw)
    state = train_state_from_arrays(m.cfg, tc, states[0], device="cpu")
    step = make_train_step(m, tc)
    out = []
    for i, b in enumerate(batches):
        state, met = step(state, _tbatch(b))
        assert set(met) == set(metrics[i])
        assert float(met["lr"]) == metrics[i]["lr"] and int(state["step"]) == i + 1
        out.append({"loss": _rel(met["loss"], metrics[i]["loss"]),
                    "grad_norm": _rel(met["grad_norm"], metrics[i]["grad_norm"]),
                    "aux": abs(float(met["aux"]) - metrics[i]["aux"])
                    / max(abs(metrics[i]["aux"]), 1.0),
                    "params": param_errors(state, states[i + 1]),
                    "two_sum_lr": 2 * sum(mt["lr"] for mt in metrics[:i + 1])})
    return out, state, met


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------
def _jax_paths(t):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_matches_jax_init(arch):
    jm, m = _pair(arch)
    for jdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), dtype=jdt))
        got = tf.params_tree(m.init_params(0, dtype=dt))
        assert tree.key_paths(got) == _jax_paths(want)
        for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
    # JAX's values through the port's Transformer and back, bit for bit
    jp = _np(jm.init_params(jax.random.PRNGKey(0)))
    params = lm_params_from_arrays(m.cfg, jp, device="cpu")
    back = tf.params_tree(params)
    for g, w in zip(tree.leaves(back), jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(g.numpy(), w)
    assert _tree_loss_error(arch) <= F32_TOL
    # the tree's views give the Transformer's forward bit for bit
    fw = {k: v for k, v in _tbatch(_batches(m.cfg, 1, seed=2)[0]).items() if k != "labels"}
    assert torch.equal(m.forward(back, fw)[0], m.forward(params, fw)[0])


def _tree_loss_error(arch) -> float:
    """The port's own parameter tree in JAX's loss against the port's loss
    (relative): each leaf means the same in both packages."""
    jm, m = _pair(arch)
    ptree = tf.params_tree(m.init_params(3))
    batch = _batches(m.cfg, 1, seed=2)[0]
    jtree = jax.tree_util.tree_map(jnp.asarray, train_state_to_arrays(ptree))
    want, _ = jax.jit(jm.loss)(jtree, _jbatch(batch))
    got, _ = m.loss(ptree, _tbatch(batch))
    return _rel(got, want)


def test_params_tree_views_share_storage():
    """``_as_params`` reads each layer as views of the stacked leaves (no
    copy), the xLSTM's blocks and the hybrid's shared block as they are."""
    for arch in (ZAMBA, XLSTM, PHI):
        _, m = _pair(arch)
        t = tf.params_tree(m.init_params(0))
        p = tf._as_params(t)
        if "blocks" in t:
            assert p.layers[1].cell["w_gates"] is t["blocks"][1]["cell"]["w_gates"]
        else:
            for i, lp in enumerate(p.layers):
                assert tree.key_paths(vars(lp)) == tree.key_paths(t["layers"])
                for view, leaf in zip(tree.leaves(vars(lp)), tree.leaves(t["layers"])):
                    assert view._base is leaf and torch.equal(view, leaf[i])
        if "shared_attn" in t:
            assert p.shared_attn.attn["wq"] is t["shared_attn"]["attn"]["wq"]


# ---------------------------------------------------------------------------
# train steps against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    errs, _, _ = port_steps(arch)
    for i, e in enumerate(errs):
        gn_tol = XLSTM_GN_TOL if arch == XLSTM and i > 0 else F32_TOL
        assert e["loss"] <= F32_TOL and e["aux"] <= F32_TOL, (i, e)
        assert e["grad_norm"] <= gn_tol, (i, e)
        pmax, share = e["params"]
        assert pmax <= e["two_sum_lr"] and share <= F32_SHARE, (i, e)


def _xlstm_gap():
    """The port's grad norms at steps 2 and 3 against JAX's continued from
    the port's own state after step 1 (relative errors)."""
    tc, m, batches, states, _, jstep = jax_run(XLSTM)
    state = train_state_from_arrays(m.cfg, tc, states[0], device="cpu")
    step = make_train_step(m, tc)
    state, _ = step(state, _tbatch(batches[0]))
    js = jax.tree_util.tree_map(jnp.asarray, train_state_to_arrays(state))
    errs = []
    for b in batches[1:]:
        js, jmet = jstep(js, _jbatch(b))
        state, met = step(state, _tbatch(b))
        errs.append(_rel(met["grad_norm"], jmet["grad_norm"]))
    return errs


def test_xlstm_grad_norm_gap_is_the_carried_state():
    assert max(_xlstm_gap()) <= F32_TOL


@pytest.mark.parametrize("arch", (PHI, QWEN))
def test_train_step_leaves_no_reference_cycle(arch):
    """A step frees its gradients and compute-dtype copies when it returns:
    nothing of it waits in a reference cycle for the garbage collector (a
    recursive closure in ``tree.unflatten`` once held every tree it built,
    GiBs on the card)."""
    _, m = _pair(arch)
    tc = TrainConfig(**STEP_KW)
    state, step = init_train_state(m, tc, 0), make_train_step(m, tc)
    batch = _tbatch(_batches(m.cfg, 1)[0])
    step(state, batch)                      # first-call set-up out of the way
    gc.collect()
    gc.disable()
    try:
        step(state, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not held, [tuple(t.shape) for t in held]


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _grad_errors(arch):
    """The port's and JAX's gradients of one loss at the reduced config, S=20
    (the hybrid's Mamba2 pads it to two chunks of 16 with dt = 0): per leaf
    the max error relative to the leaf's largest, the leaves (each layer's
    slice of a stacked leaf) that are zero or not finite, and those zero in
    JAX."""
    jm, m = _pair(arch)
    jp = jm.init_params(jax.random.PRNGKey(0))
    batch = _batches(m.cfg, 1, seed=5, seq=20)[0]
    jg = _np(jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(jp, _jbatch(batch)))
    params = tree.tree_map(lambda a: torch.from_numpy(a.copy()), _np(jp))
    _, _, tg = make_train_step(m, TrainConfig(**STEP_KW)).compute_grads(params, _tbatch(batch))
    errs, bad, jzero = {}, [], []
    for key, g, w in zip(tree.key_paths(tg), tree.leaves(tg), jax.tree_util.tree_leaves(jg)):
        g = g.numpy()
        errs[key] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        stacked = key.startswith("layers/")
        rows = g.reshape(g.shape[0], -1) if stacked else g.reshape(1, -1)
        wrows = w.reshape(rows.shape)
        for i in range(rows.shape[0]):
            name = f"{key}[{i}]" if stacked else key
            if not (np.isfinite(rows[i]).all() and np.abs(rows[i]).max() > 0):
                bad.append(name)
            if not np.abs(wrows[i]).max() > 0:
                jzero.append(name)
    return errs, bad, jzero


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_a_gradient(arch):
    errs, bad, jzero = _grad_errors(arch)
    assert max(errs.values()) <= GRAD_TOL, errs
    assert set(bad) == set(jzero) == ZERO_BY_DESIGN.get(arch, set()), (bad, jzero)


def _tie_errors():
    """One sLSTM step at n_new == 1e-6 exactly (no input: i_raw = -200; no
    forgetting: f_raw = 50, m = 0): the gradient of h's sum by the carry
    and the input, against JAX's."""
    jm, m = _pair(XLSTM)
    cfg = m.cfg
    i = cfg.slstm_at[0]
    jcell = jm.init_params(jax.random.PRNGKey(0))["blocks"][i]["cell"]
    tcell = {k: torch.from_numpy(np.array(v)) for k, v in jcell.items()}
    Bt, d = 3, cfg.d_model
    rng = np.random.default_rng(4)
    wx = np.concatenate([np.full((Bt, d), -200.0), np.full((Bt, d), 50.0),
                         rng.standard_normal((Bt, 2 * d))], -1).astype(np.float32)
    carry = [rng.standard_normal((Bt, d)).astype(np.float32),
             np.full((Bt, d), 1e-6, np.float32), np.zeros((Bt, d), np.float32),
             np.zeros((Bt, d), np.float32)]

    def jfn(c, x):
        return jax_xlstm._slstm_step(jcell, cfg.n_heads, c, x)[0][2].sum()

    jgc, jgx = jax.grad(jfn, argnums=(0, 1))(tuple(map(jnp.asarray, carry)), jnp.asarray(wx))
    tcarry = [torch.from_numpy(c).requires_grad_(True) for c in carry]
    twx = torch.from_numpy(wx).requires_grad_(True)
    n_new = xlstm._slstm_step(tcell, cfg.n_heads, tuple(tcarry), twx)[1]
    assert bool((n_new == torch.tensor(1e-6)).all())        # the tie
    h = xlstm._slstm_step(tcell, cfg.n_heads, tuple(tcarry), twx)[2]
    grads = torch.autograd.grad(h.sum(), tcarry + [twx])
    return max(_rel_max(g, w) for g, w in zip(grads, list(jgc) + [jgx]))


def _rel_max(got: torch.Tensor, want) -> float:
    """Max error relative to the largest of ``want``."""
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30))


def test_slstm_tie_splits_the_gradient_as_jax():
    assert _tie_errors() <= TIE_TOL


def _drop_grad_error():
    """One MoE FFN at ``capacity_factor=0.5`` (half the token slots drop):
    the gradients of sum(y * r) + aux by the input and every weight against
    JAX's, relative to each one's largest; the drops counted under autograd
    hold no graph."""
    jcfg = jax_reduced(jax_get_arch(PHI), capacity_factor=0.5)
    cfg = reduced(get_arch(PHI), capacity_factor=0.5)
    jp = jax_moe.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)

    def jfn(p, x):
        y, aux = jax_moe.moe_ffn(p, x, jcfg)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    probs = torch.softmax(tx.reshape(-1, cfg.d_model) @ tp["router"], -1).detach()
    top = probs.topk(cfg.top_k + 1, -1).values
    assert float((top[:, :-1] - top[:, 1:]).min()) > MARGIN
    with moe.count_drops() as drops:
        y, aux = moe.moe_ffn(tp, tx, cfg)
    assert len(drops) == 1 and int(drops[0]) > 0 and not drops[0].requires_grad
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [tx] + list(tp.values()))
    return max(_rel_max(g, w) for g, w in zip(grads, [jgx] + [jgp[k] for k in tp]))


def test_moe_drop_gradients_match_jax():
    assert _drop_grad_error() <= DROP_GRAD_TOL


# ---------------------------------------------------------------------------
# the train state's depth, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", (ZAMBA, XLSTM, PHI))
def test_train_state_from_arrays_checks_depth_per_family(arch):
    """The depth is read where the family keeps its layers; the arrays are
    copies, which a step updating the state in place leaves as they were
    (as JAX's arrays are)."""
    _, m = _pair(arch)
    tc = TrainConfig()
    state = init_train_state(m, tc, 0)
    arrays = train_state_to_arrays(state)
    before = [a.copy() for a in tree.leaves(arrays)]
    make_train_step(m, tc)(state, _tbatch(_batches(m.cfg, 1)[0]))
    assert all(np.array_equal(a, b) for a, b in zip(tree.leaves(arrays), before))
    back = train_state_from_arrays(m.cfg, tc, arrays, device="cpu")
    assert tree.key_paths(back) == tree.key_paths(arrays)
    deeper = dataclasses.replace(m.cfg, n_layers=m.cfg.n_layers + 1)
    with pytest.raises(ValueError, match="layers for a"):
        train_state_from_arrays(deeper, tc, arrays, device="cpu")


@pytest.mark.parametrize("arch", (XLSTM, ZAMBA))
def test_jax_checkpoint_restores_in_port_and_back(arch, tmp_path):
    """A checkpoint JAX wrote after one step restores in the port (the
    xLSTM's list leaves named by index, ``params/blocks/0/cell/wq``), and
    one the port wrote restores in JAX; each gives the other's next step."""
    tc, m, batches, states, metrics, jstep = jax_run(arch)
    js = jax.tree_util.tree_map(jnp.asarray, states[1])
    JaxCheckpointManager(str(tmp_path / "jax")).save(1, js)
    target = train_state_from_arrays(m.cfg, tc, states[0], device="cpu")
    state, rstep = CheckpointManager(str(tmp_path / "jax")).restore(target)
    assert rstep == 1
    if arch == XLSTM:
        assert "params/blocks/0/cell/wq" in tree.key_paths(state)
    for a, b in zip(tree.leaves(train_state_to_arrays(state)),
                    jax.tree_util.tree_leaves(states[1])):
        assert np.array_equal(a, b)
    step = make_train_step(m, tc)
    state, met = step(state, _tbatch(batches[1]))
    assert _rel(met["loss"], metrics[1]["loss"]) <= F32_TOL
    CheckpointManager(str(tmp_path / "port")).save(2, state)
    restored, rstep = JaxCheckpointManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: js))
    assert rstep == 2
    for a, b in zip(jax.tree_util.tree_leaves(_np(restored)),
                    tree.leaves(train_state_to_arrays(state))):
        assert np.array_equal(a, b)
    _, jmet = jstep(restored, _jbatch(batches[2]))
    state, met = step(state, _tbatch(batches[2]))
    assert _rel(met["loss"], jmet["loss"]) <= F32_TOL
    assert _rel(met["grad_norm"], jmet["grad_norm"]) <= F32_TOL


if __name__ == "__main__":
    # the readings behind the tolerances in the module docstring
    for arch in ARCHS:
        errs, _, _ = port_steps(arch)
        for i, e in enumerate(errs):
            print(f"{arch} step {i + 1}: loss {e['loss']:.2e} grad norm {e['grad_norm']:.2e} "
                  f"aux {e['aux']:.2e} params max {e['params'][0]:.2e} "
                  f"share {e['params'][1]:.2e} (2 sum lr {e['two_sum_lr']:.1e})")
        g, bad, jzero = _grad_errors(arch)
        print(f"{arch} gradients: worst {max(g.values()):.2e} ({max(g, key=g.get)}), "
              f"zero here {bad}, in JAX {jzero}")
    print("port tree in JAX's loss:", {a: f"{_tree_loss_error(a):.2e}" for a in ARCHS})
    print(f"xlstm grad norm from the port's step-1 state: {_xlstm_gap()}")
    print(f"slstm tie gradient: {_tie_errors():.2e}")
    print(f"moe drop gradients: {_drop_grad_error():.2e}")
