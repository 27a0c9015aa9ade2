"""PyTorch port, LM training on the CPU, held against the JAX package:
``lm_batches`` and ``Prefetcher``, ``cross_entropy`` and ``lm_loss``, the
schedule, the three optimizers and ``ef_compress`` on a carried tree, the
train step (float32 and bfloat16 compute, microbatches, int8 error
feedback), remat, checkpoints across the two packages, the fault loop and
the launcher.

JAX's train state is carried into the port with
``interop.train_state_from_arrays``; both packages then take the same
numpy batches.  The tolerances, with the errors measured on this CPU
(``python tests/test_torch_training.py`` prints them):
  * optimizer updates and ``ef_compress`` on a tree whose four stacked
    layers differ in scale by 10^4, relative to the larger of the value and
    the step's lr: 1e-6 (AdamW 5.2e-7, SGD 0, ef 0); Adafactor 2e-5
    (6.9e-6: its means over a whole stacked leaf sum in another order);
  * three train steps, float32 compute: loss and grad norm 1e-5 relative
    (2.4e-7, 3.1e-7); parameters within atol 1e-5 + rtol 1e-5 (5.3e-6)
    but for at most 1e-4 of them, which stay within 2 * sum(lr): AdamW's
    first steps divide g by |g| + eps, so a gradient near eps carries its
    relative error into the update (none past here; on an H100 against
    this CPU, 6.1e-6 of them, by up to 3.1e-5);
  * bfloat16 compute: loss 1e-4 relative (2.0e-5), grad norm 5e-3
    (1.1e-3); bfloat16 products round differently in the two packages, so
    an update can flip sign: every parameter within 2 * sum(lr) of JAX's
    (2.1e-3 of 4e-3), at most 5% of them past 1e-4 (1.3%);
  * int8 error feedback: loss as float32; a gradient within an ulp of a
    rounding boundary quantises one step apart, so the grad norm to 1e-4
    (2.2e-5), every parameter within 2 * sum(lr) (6.2e-4) and at most 0.1%
    past 1e-5 (0.04%);
  * remat none/dots/full: 1e-5 (the JAX package's own bound,
    tests/test_training.py; equal here);
  * resume after injected failures: rtol 1e-5, atol 1e-6 (the JAX
    package's, tests/test_fault_tolerance.py).
"""
import argparse
import collections
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.data import Prefetcher as JaxPrefetcher, lm_batches as jax_lm_batches
from repro.distributed.compression import ef_compress as jax_ef_compress
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tf
from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro.training import optim as jax_optim
from repro_torch import tree
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.distributed.compression import ef_compress
from repro_torch.interop import (lm_params_from_arrays, train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.training import (CheckpointManager, init_train_state,
                                  make_train_step, optim, use_remat)
from repro_torch.training.fault import (FailureInjector, StragglerMonitor,
                                        resilient_loop)

UPDATE_TOL = 1e-6
ADAFACTOR_TOL = 2e-5
EF_GN_TOL = 1e-4
F32_TOL = 1e-5
BF16_LOSS_TOL, BF16_GN_TOL, BF16_SHARE = 1e-4, 5e-3, 0.05
EF_SHARE = 1e-3
F32_SHARE = 1e-4
LAYER_SCALES = (1e-3, 1e-1, 1.0, 10.0)      # the four stacked layers' scales
STEP_KW = dict(learning_rate=1e-3, warmup_steps=2)
STEP_CASES = {"f32": dict(compute_dtype="float32"), "bf16": {},
              "mb4": dict(compute_dtype="float32", microbatches=4),
              "int8_ef": dict(compute_dtype="float32", grad_compression="int8_ef")}


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _flat(arrays) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree_util.tree_leaves(arrays)])


def _pair(arch="gemma2-2b"):
    return (jax_build_model(jax_reduced(jax_get_arch(arch))),
            build_model(reduced(get_arch(arch)), device="cpu"))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_lm_batches_bitwise_and_prefetcher_order():
    for args in ((512, 4, 16, 5, 0), (256000, 8, 128, 2, 3), (97, 3, 7, 4, 11)):
        got, want = list(lm_batches(*args)), list(jax_lm_batches(*args))
        assert len(got) == len(want) == args[3]
        for g, w in zip(got, want):
            for k in ("tokens", "labels"):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    items = list(range(50))
    assert list(Prefetcher(iter(items), depth=3)) == list(JaxPrefetcher(iter(items))) == items
    assert list(Prefetcher(iter(items), transform=lambda x: 2 * x)) == [2 * x for x in items]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 11, 97)).astype(np.float32)
    labels = rng.integers(0, 97, (3, 11)).astype(np.int32)
    fmask = (rng.random((3, 11)) > 0.4).astype(np.float32)
    for mask in (None, fmask, fmask > 0, np.zeros_like(fmask)):
        want = jax_tf.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None else jnp.asarray(mask))
        got = tf.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
        assert _rel(got, want) <= UPDATE_TOL or abs(float(got) - float(want)) < 1e-7


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-7b"])
def test_lm_loss_matches_jax(arch):
    jm, m = _pair(arch)
    jp = jm.init_params(jax.random.PRNGKey(0))
    params = lm_params_from_arrays(m.cfg, _np(jp), device="cpu")
    b = next(lm_batches(m.cfg.vocab, 4, 24, 1, seed=2))
    b["mask"] = (np.random.default_rng(1).random((4, 24)) > 0.3).astype(np.float32)
    for batch in ({k: b[k] for k in ("tokens", "labels")}, b):
        want, wm = jm.loss(jp, _jbatch(batch))
        for p in (params, tf.params_tree(params)):
            got, gm = m.loss(p, _tbatch(batch))
            assert _rel(got, want) < F32_TOL and _rel(gm["ce"], wm["ce"]) < F32_TOL
            assert float(gm["aux"]) == float(wm["aux"]) == 0.0


def _grads_tree(params):
    """A Transformer's ``.grad``s as the JAX package's tree."""
    grad = lambda d: {n: w.grad for n, w in d.items()}  # noqa: E731
    return tf.params_tree(SimpleNamespace(
        embed=params.embed.grad, final_norm=params.final_norm.grad,
        lm_head=None if params.lm_head is None else params.lm_head.grad,
        layers=[SimpleNamespace(ln1=b.ln1.grad, ln2=b.ln2.grad, attn=grad(b.attn),
                                mlp=grad(b.mlp)) for b in params.layers]))


def test_lm_loss_gives_every_parameter_a_gradient():
    """A Transformer made trainable with requires_grad_, and the JAX tree:
    every parameter (wq/wk/wv included) gets a finite, nonzero gradient,
    the same in both forms."""
    _, m = _pair()
    params = m.init_params(0)
    assert not any(p.requires_grad for p in params.parameters())   # serving
    params.requires_grad_(True)
    batch = _tbatch(next(lm_batches(m.cfg.vocab, 2, 16, 1, seed=0)))
    loss, _ = m.loss(params, batch)
    loss.backward()
    for name, p in params.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    like = tf.params_tree(params)
    leaves = [t.clone().requires_grad_(True) for t in tree.leaves(like)]
    loss2, _ = m.loss(tree.unflatten(like, leaves), batch)
    assert float(loss2.detach()) == float(loss.detach())
    grads = torch.autograd.grad(loss2, leaves)
    for g, w in zip(grads, tree.leaves(_grads_tree(params))):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# schedule, optimizers, compression
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    for warm in (1, 4, 100):
        tc, jtc = TrainConfig(warmup_steps=warm), JaxTrainConfig(warmup_steps=warm)
        for s in (0, 1, 2, 3, 4, 5, 17, 99, 100, 101, 1000):
            got = optim.lr_schedule(tc, torch.tensor(s, dtype=torch.int32))
            want = jax_optim.lr_schedule(jtc, jnp.int32(s))
            assert got.dtype == torch.float32 and float(got) == float(want), (warm, s)


def _carried_tree(seed: int):
    """A parameter tree of reduced gemma2-2b's shapes whose four stacked
    layers differ in scale (LAYER_SCALES), so statistics over a stacked
    leaf differ from each layer's own."""
    rng = np.random.default_rng(seed)
    jm, _ = _pair()
    shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                    jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    scales = np.asarray(LAYER_SCALES, np.float32)

    def draw(shape):
        a = rng.normal(0, 1, shape).astype(np.float32)
        if len(shape) >= 2 and shape[0] == len(scales):
            a *= scales.reshape((-1,) + (1,) * (len(shape) - 1))
        return a

    return jax.tree_util.tree_map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))


def _layerwise(fn, *trees):
    """``fn`` applied to each stacked layer apart (the statistics a
    per-layer implementation would take) and restacked."""
    lay = [t["layers"] for t in trees]
    per = [fn(*[jax.tree_util.tree_map(lambda a: a[i:i + 1], t) for t in lay])
           for i in range(len(LAYER_SCALES))]
    return jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *per)


def _update_err(want, got, lr: float) -> float:
    """Max error relative to the larger of the value and one step's size
    (an updated value near 0 is the difference of two of that size)."""
    want, got = _flat(want), _flat(got)
    return float((np.abs(got - want) / np.maximum(np.abs(want), lr)).max())


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_updates_match_jax(name):
    params_np = _carried_tree(0)
    jtc, tc = (JaxTrainConfig(optimizer=name, weight_decay=0.1),
               TrainConfig(optimizer=name, weight_decay=0.1))
    jinit, jupd = jax_optim.make_optimizer(jtc)
    pinit, pupd = optim.make_optimizer(tc)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    js = jinit(jp)
    pp = tree.tree_map(lambda a: torch.from_numpy(a.copy()), params_np)
    ps = pinit(pp)
    tol = ADAFACTOR_TOL if name == "adafactor" else UPDATE_TOL
    for k in range(3):
        g = _carried_tree(10 + k)
        lr = 1e-2 * (k + 1)
        jp, js = jupd(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jnp.float32(lr))
        pp, ps = pupd(tree.tree_map(torch.from_numpy, g), ps, pp,
                      torch.tensor(lr, dtype=torch.float32))
        err = _update_err(_np(jp), train_state_to_arrays(pp), lr)
        assert err < tol, (name, k, err)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(_np(js))[0],
                                tree.leaves(train_state_to_arrays(ps))):
            # relative to the leaf's largest value: a moment is a sum of two
            # terms that can cancel
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol * np.abs(a).max(),
                                       err_msg=str(path))
    if name == "adafactor":
        # the stacked norm gains are factored over (L, d), as in JAX
        assert tuple(ps["vr"]["layers"]["ln1"].shape) == (len(LAYER_SCALES),)
        # a per-layer update (the leaf's statistics taken layer by layer)
        # lands far outside the tolerance
        p0, g0 = _carried_tree(0), _carried_tree(10)
        lay = _layerwise(lambda p, g: _np(jupd(g, jinit(p), p, jnp.float32(1e-2))[0]),
                         p0, g0)
        whole = _np(jupd(g0, jinit(p0), p0, jnp.float32(1e-2))[0])["layers"]
        assert np.abs(_flat(lay) - _flat(whole)).max() > 100 * UPDATE_TOL


def test_ef_compress_matches_jax_per_stacked_leaf():
    g, e = _carried_tree(3), jax.tree_util.tree_map(lambda a: 1e-3 * a, _carried_tree(4))
    want_g, want_e = jax_ef_compress(jax.tree_util.tree_map(jnp.asarray, g),
                                     jax.tree_util.tree_map(jnp.asarray, e))
    got_g, got_e = ef_compress(tree.tree_map(torch.from_numpy, g),
                               tree.tree_map(torch.from_numpy, e))
    for got, want in ((got_g, want_g), (got_e, want_e)):
        np.testing.assert_allclose(_flat(train_state_to_arrays(got)), _flat(_np(want)),
                                   rtol=UPDATE_TOL, atol=0)
    # one scale per stacked leaf: a per-layer scale quantises the small
    # layers far more finely
    lay = _layerwise(lambda a, b: _np(jax_ef_compress(a, b)[0]), g, e)
    assert np.abs(_flat(lay) - _flat(_np(want_g)["layers"])).max() > 1e-3


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------
_RUNS = {}


def _step_run(case: str, n: int = 3):
    """JAX's train state before and after each of ``n`` steps of ``case``,
    and the metrics (one jit compile per case for the module)."""
    if case not in _RUNS:
        kw = {**STEP_KW, **STEP_CASES[case]}
        jm, m = _pair()
        jtc = JaxTrainConfig(**kw)
        js = jax_init_train_state(jm, jtc, jax.random.PRNGKey(0))
        step = jax.jit(jax_make_train_step(jm, jtc))
        batches = list(lm_batches(m.cfg.vocab, 8, 32, n, seed=1))
        states, metrics = [_np(js)], []
        for b in batches:
            js, met = step(js, _jbatch(b))
            states.append(_np(js))
            metrics.append({k: float(v) for k, v in met.items()})
        _RUNS[case] = (TrainConfig(**kw), m, batches, states, metrics, step)
    return _RUNS[case]


def _check_step(case, state, met, want_state, want_met, lrs):
    got_p = _flat(train_state_to_arrays(state["params"]))
    want_p = _flat(want_state["params"])
    d = np.abs(got_p - want_p)
    if case == "bf16":
        assert _rel(met["loss"], want_met["loss"]) < BF16_LOSS_TOL
        assert _rel(met["grad_norm"], want_met["grad_norm"]) < BF16_GN_TOL
        assert d.max() <= 2 * sum(lrs) and (d > 1e-4).mean() <= BF16_SHARE
    else:
        assert _rel(met["loss"], want_met["loss"]) < F32_TOL
        assert _rel(met["grad_norm"], want_met["grad_norm"]) < (
            EF_GN_TOL if case == "int8_ef" else F32_TOL)
        share = EF_SHARE if case == "int8_ef" else F32_SHARE
        assert d.max() <= 2 * sum(lrs)
        assert (d > F32_TOL + F32_TOL * np.abs(want_p)).mean() <= share, d.max()
    assert float(met["lr"]) == want_met["lr"]
    assert int(state["step"]) == int(want_state["step"])


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    tc, m, batches, states, metrics, _ = _step_run(case)
    state = train_state_from_arrays(m.cfg, tc, states[0], device="cpu")
    step = make_train_step(m, tc)
    lrs = []
    for i, b in enumerate(batches):
        state, met = step(state, _tbatch(b))
        lrs.append(metrics[i]["lr"])
        _check_step(case, state, met, states[i + 1], metrics[i], lrs)
        assert set(met) == set(metrics[i])
    if case == "mb4":
        assert float(met["aux"]) == 0.0 and float(met["ce"]) == float(met["loss"])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_agree():
    """Loss and gradients equal under none/dots/full; the backward recomputes
    no forward op under none, the layers' elementwise ops but no product
    under dots, and the products too under full."""
    _, m = _pair("deepseek-7b")
    b = _tbatch(next(lm_batches(m.cfg.vocab, 4, 16, 1, seed=3)))
    out, ops = {}, {}
    for remat in ("none", "dots", "full"):
        tc = TrainConfig(remat=remat, compute_dtype="float32")
        step = make_train_step(m, tc)
        state = init_train_state(m, tc, 0)
        out[remat] = step.compute_grads(state["params"], b)
        leaves = [p.requires_grad_(True) for p in tree.leaves(state["params"])]
        with use_remat(remat):
            loss, _ = m.loss(tree.unflatten(state["params"], leaves), b)
        with _CountOps() as count:
            torch.autograd.grad(loss, leaves)
        aten = torch.ops.aten
        ops[remat] = (count.n[aten.mm.default] + count.n[aten.bmm.default],
                      count.n[aten.rsqrt.default])
    for remat in ("dots", "full"):
        assert abs(float(out["none"][0]) - float(out[remat][0])) < F32_TOL
        for g, w in zip(tree.leaves(out[remat][2]), tree.leaves(out["none"][2])):
            torch.testing.assert_close(g, w, rtol=F32_TOL, atol=1e-7)
    assert ops["none"][1] == 0 and ops["dots"][1] == ops["full"][1] > 0, ops
    assert ops["none"][0] == ops["dots"][0] < ops["full"][0], ops


def test_microbatch_equivalence():
    _, m = _pair("deepseek-7b")
    b = _tbatch(next(lm_batches(m.cfg.vocab, 8, 16, 1, seed=2)))
    outs = {}
    for mb in (1, 4):
        tc = TrainConfig(microbatches=mb)
        state, met = make_train_step(m, tc)(init_train_state(m, tc, 0), b)
        outs[mb] = (float(met["loss"]), tree.leaves(state["params"])[0])
    assert abs(outs[1][0] - outs[4][0]) < 1e-3
    torch.testing.assert_close(outs[1][1], outs[4][1], rtol=1e-3, atol=1e-5)


def _losses(tc, n, arch="deepseek-7b"):
    _, m = _pair(arch)
    state, step = init_train_state(m, tc, 0), make_train_step(m, tc)
    losses = []
    for b in lm_batches(m.cfg.vocab, 8, 32, n, seed=1):
        state, met = step(state, _tbatch(b))
        losses.append(float(met["loss"]))
    return losses


def test_loss_decreases():
    losses = _losses(TrainConfig(learning_rate=1e-3, warmup_steps=2), 20)
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]


def test_grad_compression_converges():
    losses = _losses(TrainConfig(learning_rate=1e-3, grad_compression="int8_ef",
                                 warmup_steps=2), 15)
    assert losses[-1] < losses[0] - 0.15, losses[:3] + losses[-3:]


def test_train_state_arrays_round_trip_and_checks():
    _, m = _pair()
    for kw in ({}, {"optimizer": "adafactor"}, {"optimizer": "sgd"},
               {"grad_compression": "int8_ef"}):
        tc = TrainConfig(**kw)
        state = init_train_state(m, tc, 0)
        arrays = train_state_to_arrays(state)
        back = train_state_from_arrays(m.cfg, tc, arrays, device="cpu")
        assert tree.key_paths(back) == tree.key_paths(state)
        for a, b in zip(tree.leaves(back), tree.leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(KeyError):
        train_state_from_arrays(m.cfg, TrainConfig(optimizer="sgd"), arrays, device="cpu")
    with pytest.raises(KeyError):
        train_state_from_arrays(m.cfg, TrainConfig(), arrays, device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _small_state(**kw):
    _, m = _pair("deepseek-7b")
    return m, TrainConfig(**kw), init_train_state(m, TrainConfig(**kw), 0)


def _assert_states_equal(a, b):
    assert tree.key_paths(a) == tree.key_paths(b)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    m, tc, state = _small_state()
    b = _tbatch(next(lm_batches(m.cfg.vocab, 4, 16, 1)))
    state, _ = make_train_step(m, tc)(state, b)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state)
    restored, rstep = mgr.restore(state)
    assert rstep == 1
    _assert_states_equal(restored, state)


def test_checkpoint_gc_and_latest(tmp_path):
    _, _, state = _small_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_snapshots_a_copy(tmp_path):
    _, _, state = _small_state()
    before = tree.tree_map(torch.clone, state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, state)
    for t in tree.leaves(state["params"]):      # the next step, in place
        t.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    _assert_states_equal(mgr.restore(state)[0], before)


def test_checkpoint_ignores_uncommitted(tmp_path):
    _, _, state = _small_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    shutil.copytree(os.path.join(tmp_path, "step_1"), os.path.join(tmp_path, "step_2"))
    os.remove(os.path.join(tmp_path, "step_2", "COMMIT"))
    assert mgr.latest_step() == 1


def test_jax_checkpoint_restores_in_port_and_back(tmp_path):
    """A checkpoint JAX wrote after one step restores in the port, and one
    the port wrote restores in JAX; each gives the other's next step."""
    tc, m, batches, states, metrics, jstep = _step_run("f32")
    jm, _ = _pair()
    js = jax.tree_util.tree_map(jnp.asarray, states[1])
    JaxCheckpointManager(str(tmp_path / "jax")).save(1, js)
    target = train_state_from_arrays(m.cfg, tc, states[0], device="cpu")
    state, rstep = CheckpointManager(str(tmp_path / "jax")).restore(target)
    assert rstep == 1
    for a, b in zip(tree.leaves(train_state_to_arrays(state)),
                    jax.tree_util.tree_leaves(states[1])):
        assert np.array_equal(a, b)
    state, met = make_train_step(m, tc)(state, _tbatch(batches[1]))
    _check_step("f32", state, met, states[2], metrics[1], [metrics[1]["lr"]])

    CheckpointManager(str(tmp_path / "port")).save(2, state)
    restored, rstep = JaxCheckpointManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: js))
    assert rstep == 2
    for a, b in zip(jax.tree_util.tree_leaves(_np(restored)),
                    tree.leaves(train_state_to_arrays(state))):
        assert np.array_equal(a, b)
    _, jmet = jstep(restored, _jbatch(batches[2]))
    state, met = make_train_step(m, tc)(state, _tbatch(batches[2]))
    assert _rel(met["loss"], jmet["loss"]) < F32_TOL
    assert _rel(met["grad_norm"], jmet["grad_norm"]) < F32_TOL


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def _fault_setup():
    _, m = _pair("gemma2-2b")
    tc = TrainConfig(learning_rate=1e-3)
    batches = [_tbatch(b) for b in lm_batches(m.cfg.vocab, 4, 16, 12, seed=4)]
    return m, tc, make_train_step(m, tc), batches


def test_resume_after_injected_failures(tmp_path):
    m, tc, step, batches = _fault_setup()
    ref = init_train_state(m, tc, 0)
    for b in batches:
        ref, _ = step(ref, b)
    ckpt = CheckpointManager(str(tmp_path / "ft"), keep=3)
    out = resilient_loop(step, init_train_state(m, tc, 0), batches, ckpt,
                         ckpt_every=2, injector=FailureInjector(fail_at=[3, 7, 7]),
                         max_restarts=5)
    assert out["restarts"] >= 2
    assert out["completed"] == len(batches)
    for a, b in zip(tree.leaves(out["state"]["params"]), tree.leaves(ref["params"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_too_many_failures_raises(tmp_path):
    m, tc, step, batches = _fault_setup()

    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError):
        resilient_loop(step, init_train_state(m, tc, 0), batches,
                       CheckpointManager(str(tmp_path / "ft2")),
                       injector=AlwaysFail([]), max_restarts=3)


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=3.0)
    flagged = [i for i, dt in enumerate([1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.05])
               if mon.record(i, dt)]
    assert flagged == [4]
    assert 0.8 < mon.ewma < 1.3


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_cpu_reduced(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    train_launcher.main(["--arch", "gemma2-2b", "--reduced", "--steps", "4",
                         "--batch", "4", "--seq", "16", "--ckpt-every", "2",
                         "--device", "cpu", "--ckpt-dir", str(ckpt)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(kv.split("=") for kv in line.split())
    assert list(fields) == ["steps", "restarts", "stragglers", "loss", "tokens/s"]
    assert fields["steps"] == "4" and fields["restarts"] == "0"
    assert np.isfinite(float(fields["loss"])) and float(fields["tokens/s"]) > 0
    assert CheckpointManager(str(ckpt)).all_steps() == [0, 2, 4]


def test_launcher_mesh_raises(tmp_path):
    args = train_launcher.parser().parse_args(
        ["--arch", "gemma2-2b", "--reduced", "--mesh", "1x1", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="10c"):
        train_launcher.train_lm(args)
    with pytest.raises(NotImplementedError):
        train_launcher.train_lm(argparse.Namespace(**{**vars(args), "mesh": "2x4"}))



@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                                  "zamba2-2.7b", "xlstm-125m", "qwen2-vl-72b",
                                  "hubert-xlarge"])
def test_training_refuses_other_families(arch, tmp_path):
    """Only the dense family trains: the state, the step and the launcher
    refuse the others, naming ROADMAP queue 1 item 12h."""
    m = build_model(reduced(get_arch(arch)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12h"):
        init_train_state(m, TrainConfig())
    with pytest.raises(NotImplementedError, match="item 12h"):
        make_train_step(m, TrainConfig())
    args = train_launcher.parser().parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 12h"):
        train_launcher.train_lm(args)
    assert not any(tmp_path.iterdir())

if __name__ == "__main__":
    # the readings behind the tolerances in the module docstring
    for case in STEP_CASES:
        tc, m, batches, states, metrics, _ = _step_run(case)
        state = train_state_from_arrays(m.cfg, tc, states[0], device="cpu")
        step = make_train_step(m, tc)
        for i, b in enumerate(batches):
            state, met = step(state, _tbatch(b))
            d = np.abs(_flat(train_state_to_arrays(state["params"]))
                       - _flat(states[i + 1]["params"]))
            print(f"{case} step {i + 1}: loss rel {_rel(met['loss'], metrics[i]['loss']):.2e} "
                  f"grad norm rel {_rel(met['grad_norm'], metrics[i]['grad_norm']):.2e} "
                  f"params max abs {d.max():.2e}, share past 1e-4 {(d > 1e-4).mean():.4f}, "
                  f"past 1e-5 {(d > 1e-5).mean():.5f}")
