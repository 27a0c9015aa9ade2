"""PyTorch port, the LM stack placed over a mesh, on the CPU: the
single-controller mesh of ``distributed/sharding.py`` with its places on
``devices=["cpu"] * n``.

  * ``place``/``gather``/``named_shardings``/``lshard`` and
    ``launch/mesh.py``;
  * the placed train step (``training/train_step.make_placed_train_step``)
    on reduced deepseek-7b with 4 kv heads, batch 8 x 16, for AdamW with and
    without ZeRO-1, SGD, Adafactor and int8 error feedback, against the
    one-device step at ``microbatches`` = the data size: bit for bit over 3
    steps at (2,1); at (2,4), (2,2) and (1,2), where the model axis splits
    the dense layers' compute, in float32 each step's loss and gradients
    within SPLIT_TOL and its update bit for bit (``_hold_split_step``); each
    place holds only its block; its step-1 loss within JAX's envelope (1e-3
    x max(1, loss), tests/test_distributed.py) of JAX's single-device jitted
    step with the weights carried across;
  * local MoE dispatch (``moe_ffn_local``) against the dense dispatch
    (forward 1e-4, gradients 1e-3, tests/test_moe_dispatch.py's config and
    bounds) on (2,4) places, with and without the FSDP gather, and against
    JAX's ``moe_ffn_local`` itself on 8 forced host devices at a capacity
    factor where slots drop (1e-4): the per-place capacity is JAX's;
  * sequence-parallel decode against both packages' ``decode_attention``
    and JAX's ``make_seq_parallel_decode`` (1e-4, B=2, H=4, K=2, S=64,
    D=32, cache_len [40, 64] over 8 places);
  * a checkpoint saved on (4,2) restored on (2,2) with swapped specs, bit
    for bit;
  * the launcher's ``--mesh 2x2``: its line, its checkpoint restored on 1x1,
    its loss and its 4 steps' update against the one-device launcher's at
    ``--microbatches 2`` (bf16 compute: LAUNCHER_LOSS_TOL and
    LAUNCHER_UPDATE_TOL); ``--mesh 2x1``'s checkpoints bit for bit with the
    one-device launcher's;
  * ``count_drops`` under remat (a call counted once, dense and local
    dispatch) and remat's first call leaving no cycle that holds a step's
    compute copies.
JAX runs on 8 forced host devices in one subprocess (the test process keeps
one).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models.attention import decode_attention as jax_decode_attention
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.configs import ShapeConfig, TrainConfig, get_arch, reduced
from repro_torch.data import lm_batches
from repro_torch.distributed import flags
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import batch_specs, opt_specs, param_specs
from repro_torch.distributed.seq_parallel import make_seq_parallel_decode
from repro_torch.distributed.sharding import (AxisRules, Mesh, NamedSharding, P,
                                              Placed, gather, logical_spec, lshard,
                                              named_shardings, place,
                                              reset_transfer_counts,
                                              transfer_counts, use_rules)
from repro_torch.interop import train_state_from_arrays
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_shape_dict)
from repro_torch.models import build_model, moe
from repro_torch.models.attention import decode_attention
from repro_torch.training import CheckpointManager, init_train_state, make_train_step
from repro_torch.distributed.compression import ef_compress
from repro_torch.training.optim import lr_schedule, make_optimizer
from repro_torch.training.train_step import (clip_grads, global_norm,
                                             make_placed_train_step)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 4), (2, 2), (2, 1), (1, 2))
VARIANTS = {"adamw": {}, "adamw_zero1": {"zero1": True}, "sgd": {"optimizer": "sgd"},
            "adafactor": {"optimizer": "adafactor"},
            "int8_ef": {"grad_compression": "int8_ef"}}
STEP_KW = dict(learning_rate=1e-3, warmup_steps=2)
B, S = 8, 16
JAX_LOSS_TOL = 1e-3                 # tests/test_distributed.py:70-71
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)   # chip_smoke phase train_resume's envelope
MOE_FWD_TOL, MOE_GRAD_TOL = 1e-4, 1e-3   # tests/test_moe_dispatch.py
MOE_JAX_TOL = 1e-4
DECODE_TOL = 1e-4                   # tests/test_distributed.py:106
DROP_CF = 0.5                       # a capacity factor at which slots drop
SP = dict(B=2, H=4, K=2, S=64, D=32, cache_len=(40, 64))
# --mesh 2x2 against one device in the launcher's bf16 compute, 4 AdamW steps:
# the final loss within JAX's envelope (1e-3 x max(1, loss),
# tests/test_distributed.py), and each leaf's update (step 4 less step 0)
# within 25% of the one-device update in norm.  AdamW moves a parameter by
# about lr whatever the size of its gradient, so where a bf16 partial sum
# rounds a small gradient the other way its update turns over: measured 3-10%
# (final_norm, 128 values, the most); a model block left without its update,
# or another block's, is >= 70%.
LAUNCHER_LOSS_TOL = 1e-3
LAUNCHER_UPDATE_TOL = 0.25


def _cfg():
    return reduced(get_arch("deepseek-7b"), n_kv_heads=4)


def _batches(vocab, n=3, seed=5):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in lm_batches(vocab, B, S, n, seed=seed)]


def _placed_step(model, tc, D, M):
    mesh = make_host_mesh(D, M)
    shp = ShapeConfig("t", S, B, "train")
    rules_d = make_rules(model.cfg, shp, model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    state = init_train_state(model, tc, 0)
    ps = param_specs(state["params"], model.cfg, rules, M)
    os_ = opt_specs(state["opt"], ps, model.cfg, rules, mesh_shape_dict(mesh), tc.zero1)
    step = make_placed_train_step(model, tc, mesh, {"params": ps, "opt": os_, "step": P()},
                                  batch_specs(model.cfg, shp, rules))
    return step, state, rules_d


@functools.lru_cache(maxsize=None)
def _model():
    return build_model(_cfg(), device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(variant: str, D: int):
    """3 one-device steps at microbatches = D: (metrics, final state)."""
    m = _model()
    tc = TrainConfig(**STEP_KW, **VARIANTS[variant], microbatches=D)
    state, step, mets = init_train_state(m, tc, 0), make_train_step(m, tc), []
    for b in _batches(m.cfg.vocab):
        state, met = step(state, b)
        mets.append(met)
    return mets, state


# ---------------------------------------------------------------------------
# specs, places and meshes
# ---------------------------------------------------------------------------
def test_place_gather_and_transfer_counts():
    mesh = Mesh(["cpu"] * 8, ("data", "model"), (4, 2))
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    reset_transfer_counts()
    p = place(t, NamedSharding(mesh, P("data", "model")))
    assert transfer_counts()["between_places"] == 7 * 8 * 4     # 7 blocks of 8
    for i in range(8):
        c = mesh.coords(i)
        want = t[2 * c["data"]:2 * c["data"] + 2, 4 * c["model"]:4 * c["model"] + 4]
        assert torch.equal(p.blocks[i], want)
    reset_transfer_counts()
    assert torch.equal(gather(p, "cpu"), t)
    assert transfer_counts()["between_places"] == 7 * 8 * 4
    rep = place(t, NamedSharding(mesh, P(None, "model")))      # copies over data
    assert len({b.data_ptr() for b in rep.blocks}) == 8
    reset_transfer_counts()
    assert torch.equal(gather(rep, "cpu", dst=3), t)             # place 3 holds half
    assert transfer_counts()["between_places"] == 32 * 4
    with pytest.raises(ValueError, match="divide"):
        place(torch.zeros(6, 8), NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError):
        place(t, NamedSharding(mesh, P("pod")))
    with pytest.raises(ValueError):
        place(t, NamedSharding(mesh, P("data", "data")))


def test_specs_shardings_lshard_and_meshes():
    assert tuple(P(("data",), ("pod", "data"), (), None)) == ("data", ("pod", "data"), None, None)
    tree_ = {"a": P("data", None), "b": None, "c": [P(), P("model")]}
    sh = named_shardings(make_host_mesh(2, 4), tree_)
    assert sh["b"] is None and isinstance(sh["a"], NamedSharding)
    assert sh["c"][1].spec == P("model") and sh["a"].mesh.shape == {"data": 2, "model": 4}
    assert tree.leaves(tree_)[0] == P("data", None)               # a spec is a leaf
    x = torch.zeros(2, 3)
    assert lshard(x, "batch") is x                                # no rules: no check
    assert logical_spec(["batch", None]) == P(None, None)
    with use_rules({"batch": ("data",), "heads": "model"}):
        assert lshard(x, "batch", "heads") is x
        assert logical_spec(["batch", "heads", None]) == P("data", "model", None)
        with pytest.raises(ValueError):
            lshard(x, "batch")
    with pytest.raises(RuntimeError, match="devices="):
        make_production_mesh()
    mp = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert mesh_shape_dict(mp) == {"pod": 2, "data": 16, "model": 16}
    assert mesh_shape_dict(make_production_mesh(devices=["cpu"] * 256)) == {
        "data": 16, "model": 16}
    hm = make_host_mesh()
    assert hm.devices == (torch.device("cpu"),) * 8 and mesh_shape_dict(hm) == {
        "data": 2, "model": 4}
    mesh = object()
    with flags.use_local_moe_dispatch(mesh, "data"), flags.use_scan_unroll(), \
            flags.use_remat_override("full"):
        assert flags.moe_dispatch() == (mesh, ("data",), "model")
        assert flags.scan_unroll() and flags.remat_override() == "full"
    assert flags.moe_dispatch() is None and not flags.scan_unroll()
    assert flags.remat_override() is None


# ---------------------------------------------------------------------------
# the placed train step
# ---------------------------------------------------------------------------
def _whole(state):
    """A placed state gathered to the CPU (host leaves copied)."""
    return tree.tree_map(lambda t: gather(t, "cpu") if isinstance(t, Placed) else t.clone(),
                         state)


def _one_device_update(tc, state, grads):
    """The one-device step's update (``train_step``'s body after its
    gradients) of ``state`` by ``grads``: (the new state, grad norm)."""
    if tc.grad_compression == "int8_ef":
        grads, err = ef_compress(grads, tree.leaves(state["ef_err"]))
        state["ef_err"] = tree.unflatten(state["ef_err"], err)
    grads, gn = clip_grads(grads, tc)
    lr = lr_schedule(tc, state["step"])
    opt = {k: tree.leaves(v) if k != "step" else v for k, v in state["opt"].items()}
    params, opt = make_optimizer(tc)[1](grads, opt, tree.leaves(state["params"]), lr)
    return {**state, "params": tree.unflatten(state["params"], params),
            "opt": {**state["opt"], "step": opt["step"]}, "step": state["step"] + 1}, gn


def _hold_split_step(variant, D, M):
    """Model size > 1: the dense layers' compute is split over the model
    places, which sums the row-parallel partials (and the vocab-parallel
    cross-entropy's terms) in another order than one device does.  float32
    compute (bf16 would round each partial: the split's design, as
    Megatron's bf16 sums).  Each of 3 steps, from the placed state gathered:
    the loss, and the gradients at the scale the optimizer takes them (the
    clip's), within SPLIT_TOL of the one-device step's at microbatches = D;
    the placed update (int8 EF, clip, optimizer, ZeRO-1) bit for bit with
    the one-device update of those same gradients.  (Not the parameters of
    two separate runs: where |g| is below AdamW's eps its update moves a
    parameter by lr |g| / eps, so a gradient's 1e-9 rounding moves it by
    1e-5, and int8's rounding edges by a quantisation step.)"""
    m = _model()
    tc = TrainConfig(**STEP_KW, **VARIANTS[variant], compute_dtype="float32")
    step, state, rules_d = _placed_step(m, tc, D, M)
    ref_tc = dataclasses.replace(tc, microbatches=D)
    ref = make_train_step(m, ref_tc)
    with use_rules(rules_d):
        state = step.place_state(state)
        for b in _batches(m.cfg.vocab):
            whole = _whole(state)
            loss, _, grads = step.compute_grads(state["params"], b)
            wloss, _, wgrads = ref.compute_grads(whole["params"], b)
            torch.testing.assert_close(loss, wloss, **SPLIT_TOL)
            scale = min(1.0, tc.grad_clip / float(global_norm(wgrads)))   # the clip's
            for g, w in zip(grads, tree.leaves(wgrads)):
                torch.testing.assert_close(g * scale, w * scale, **SPLIT_TOL)
            want, gn = _one_device_update(ref_tc, whole, [g.clone() for g in grads])
            state, met = step(state, b)
            assert torch.equal(met["grad_norm"], gn) and torch.equal(met["loss"], loss)
            for (path, got), w in zip(tree.flatten_with_paths(state), tree.leaves(want)):
                g = gather(got, "cpu") if isinstance(got, Placed) else got
                assert torch.equal(g, w), path


@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_placed_step_bitwise_with_one_device(variant, mesh):
    """At model size 1 the placed step is the one-device step at
    microbatches = D bit for bit over 3 steps; past it, ``_hold_split_step``."""
    D, M = mesh
    if M > 1:
        return _hold_split_step(variant, D, M)
    m = _model()
    tc = TrainConfig(**STEP_KW, **VARIANTS[variant])
    step, state, rules_d = _placed_step(m, tc, D, M)
    want_mets, want = _reference(variant, D)
    with use_rules(rules_d):
        for b, want_met in zip(_batches(m.cfg.vocab), want_mets):
            state, met = step(state, b)
            assert met.keys() == want_met.keys()
            for k in met:
                assert torch.equal(met[k], want_met[k]), k
    for path, got in tree.flatten_with_paths(state):
        ref = tree.flatten_with_paths(want)
        w = dict(ref)[path]
        g = gather(got, "cpu") if isinstance(got, Placed) else got
        assert torch.equal(g, w), path


def test_each_place_holds_only_its_block():
    """(2,2) with ZeRO-1: a parameter block is the leaf cut by its spec's
    model axis, copies across the data places; an m or v block of a leaf
    ZeRO-1 cuts is 1/D of the parameter block (1/(D M) of the leaf where
    the model axis cuts it too), and no two places share storage."""
    D, M = 2, 2
    m = _model()
    step, state, _ = _placed_step(m, TrainConfig(**STEP_KW, zero1=True), D, M)
    state = step.place_state(state)
    cut_by_zero = 0
    for pp, mm, vv in zip(*(tree.leaves(t) for t in (state["params"], state["opt"]["m"],
                                                      state["opt"]["v"]))):
        full = pp.shape.numel() * 4
        model_cut = 2 if "model" in pp.sharding.spec else 1
        for i in range(D * M):
            assert pp.blocks[i].numel() * 4 * model_cut == full
            assert pp.blocks[i].dtype == torch.float32
        zero = "data" in mm.sharding.spec
        cut_by_zero += zero
        for t in (mm, vv):
            for i in range(D * M):
                assert t.blocks[i].numel() * 4 * model_cut * (D if zero else 1) == full
        ptrs = {b.data_ptr() for t in (pp, mm, vv) for b in t.blocks}
        assert len(ptrs) == 3 * D * M
    assert cut_by_zero == len(tree.leaves(state["params"]))


def test_placed_step_loss_within_jax_envelope_of_single_device():
    """JAX's state carried into the port: the step-1 loss of the placed
    step (2,4), ZeRO-1, bf16 compute, against JAX's single-device jitted
    step on the same batch."""
    jm = jax_build_model(jax_reduced(jax_get_arch("deepseek-7b"), n_kv_heads=4))
    jtc = JaxTrainConfig(zero1=True)
    jstate = jax_init_train_state(jm, jtc, jax.random.PRNGKey(0))
    b = next(iter(lm_batches(_cfg().vocab, B, S, 1, seed=5)))
    _, jmet = jax.jit(jax_make_train_step(jm, jtc))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    ref = float(jmet["loss"])
    m = _model()
    tc = TrainConfig(zero1=True)
    step, _, rules_d = _placed_step(m, tc, 2, 4)
    state = train_state_from_arrays(m.cfg, tc, jax.tree_util.tree_map(np.asarray, jstate),
                                    device="cpu")
    with use_rules(rules_d):
        _, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(met["loss"]) - ref) < JAX_LOSS_TOL * max(1.0, ref), (float(met["loss"]), ref)


# ---------------------------------------------------------------------------
# local MoE dispatch and sequence-parallel decode
# ---------------------------------------------------------------------------
def _moe_cfg(cf: float):
    return dataclasses.replace(reduced(get_arch("kimi-k2-1t-a32b")), n_experts=8,
                               top_k=2, capacity_factor=cf, n_shared_experts=1)


def _moe_params(seed=0, cfg=None):
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg or _moe_cfg(8.0), torch.float32)
    return {k: (v.detach() if torch.is_tensor(v) else {kk: vv.detach() for kk, vv in v.items()})
            for k, v in p.items()}


def _moe_run(p, x, cfg, mesh=None, fsdp=None):
    leaves = [t.clone().requires_grad_(True) for t in tree.leaves(p)]
    xx = x.clone().requires_grad_(True)
    rules = {"batch": ("data",), "experts": "model", "expert_cap": ("data",),
             "ff": None, "fsdp": fsdp}
    with torch.enable_grad(), use_rules(rules), moe.count_drops() as drops:
        if mesh is None:
            y, aux = moe.moe_ffn(tree.unflatten(p, leaves), xx, cfg)
        else:
            with flags.use_local_moe_dispatch(mesh, ("data",), "model"):
                y, aux = moe.moe_ffn(tree.unflatten(p, leaves), xx, cfg)
        grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, leaves + [xx])
    return y.detach(), aux.detach(), grads, [int(d) for d in drops]


@pytest.mark.parametrize("fsdp", [None, ("data",)], ids=["ep", "ep_fsdp"])
def test_local_dispatch_matches_dense(fsdp):
    cfg = _moe_cfg(8.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32) * 0.5)
    p = _moe_params(0, cfg)
    y, _, g, d = _moe_run(p, x, cfg)
    reset_transfer_counts()
    yl, _, gl, dl = _moe_run(p, x, cfg, make_host_mesh(2, 4), fsdp)
    assert transfer_counts()["between_places"] > 0
    assert float((yl - y).abs().max()) <= MOE_FWD_TOL
    assert max(float((a - b).abs().max()) for a, b in zip(gl, g)) <= MOE_GRAD_TOL
    assert d == dl == [0] and len(dl) == 1


@pytest.fixture(scope="module")
def jax_mesh_outputs(tmp_path_factory):
    """JAX on 8 forced host devices: moe_ffn_local on (2,4) at a capacity
    factor where slots drop (its weights, x and outputs), the dense dispatch
    on the same inputs, and make_seq_parallel_decode over 8 places."""
    d = tmp_path_factory.mktemp("jax_mesh")
    rng = np.random.default_rng(7)
    sp = SP
    inputs = {"x": rng.standard_normal((4, 16, _moe_cfg(DROP_CF).d_model)).astype(np.float32) * 0.5,
              "q": rng.standard_normal((sp["B"], 1, sp["H"], sp["D"])).astype(np.float32),
              "kc": rng.standard_normal((sp["B"], sp["S"], sp["K"], sp["D"])).astype(np.float32),
              "vc": rng.standard_normal((sp["B"], sp["S"], sp["K"], sp["D"])).astype(np.float32),
              "cache_len": np.asarray(sp["cache_len"], np.int32)}
    np.savez(d / "in.npz", **inputs)
    code = textwrap.dedent(f"""
        import dataclasses, numpy as np, jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P, NamedSharding
        from repro.configs import get_arch, reduced
        from repro.models import moe as moe_mod
        from repro.distributed import flags
        from repro.distributed.sharding import use_rules, set_mesh
        from repro.distributed.seq_parallel import make_seq_parallel_decode
        d = dict(np.load({str(d / 'in.npz')!r}))
        cfg = dataclasses.replace(reduced(get_arch("kimi-k2-1t-a32b")), n_experts=8,
                                  top_k=2, capacity_factor={DROP_CF}, n_shared_experts=1)
        p = moe_mod.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
        x = jnp.asarray(d["x"])
        y_dense, aux_dense = moe_mod.moe_ffn(p, x, cfg)
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        rules = {{"batch": ("data",), "experts": "model", "expert_cap": ("data",),
                  "ff": None, "fsdp": None}}
        pspec = {{"router": P(), "wi": P("model", None, None), "wg": P("model", None, None),
                  "wo": P("model", None, None), "shared": {{"wi": P(), "wg": P(), "wo": P()}}}}
        with use_rules(rules), flags.use_local_moe_dispatch(mesh, ("data",), "model"), \\
                set_mesh(mesh):
            p_sh = jax.tree_util.tree_map(
                lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), p, pspec)
            x_sh = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
            y_loc, aux_loc = jax.jit(lambda a, b: moe_mod.moe_ffn(a, b, cfg))(p_sh, x_sh)
        mesh8 = jax.make_mesh((8,), ("data",))
        kv_spec = P(None, "data", None, None)
        fn = make_seq_parallel_decode(mesh8, ("data",), kv_spec, P(None, None, None, None))
        with set_mesh(mesh8):
            sp = fn(jnp.asarray(d["q"]),
                    jax.device_put(jnp.asarray(d["kc"]), NamedSharding(mesh8, kv_spec)),
                    jax.device_put(jnp.asarray(d["vc"]), NamedSharding(mesh8, kv_spec)),
                    jnp.asarray(d["cache_len"]))
        flat = {{"p/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}}
        np.savez({str(d / 'out.npz')!r}, y_loc=np.asarray(y_loc), aux_loc=np.asarray(aux_loc),
                 y_dense=np.asarray(y_dense), aux_dense=np.asarray(aux_dense),
                 seq_parallel=np.asarray(sp), **flat)
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = dict(np.load(d / "out.npz"))
    params = {}
    for k, v in res.items():
        if k.startswith("p/"):
            node, parts = params, k[2:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(v)
    return inputs, res, params


def test_local_dispatch_matches_jax_where_slots_drop(jax_mesh_outputs):
    """Each data place routes its 32 tokens at its own capacity C_loc =
    capacity(32) (JAX's), so its drops differ from the dense dispatch's of
    64 tokens: the port's local output is JAX's local output, and differs
    from both packages' dense output."""
    inputs, res, p = jax_mesh_outputs
    cfg = _moe_cfg(DROP_CF)
    x = torch.from_numpy(inputs["x"])
    y, aux, _, drops = _moe_run(p, x, cfg, make_host_mesh(2, 4))
    yd, auxd, _, drops_d = _moe_run(p, x, cfg)
    assert float((yd - torch.from_numpy(res["y_dense"])).abs().max()) <= MOE_JAX_TOL
    assert float((y - torch.from_numpy(res["y_loc"])).abs().max()) <= MOE_JAX_TOL
    assert abs(float(aux) - float(res["aux_loc"])) <= MOE_JAX_TOL
    assert drops[0] > 0 and drops_d[0] > 0 and drops != drops_d
    assert float((y - yd).abs().max()) > 1e-2


def test_seq_parallel_decode_matches_dense(jax_mesh_outputs):
    inputs, res, _ = jax_mesh_outputs
    q, kc, vc = (torch.from_numpy(inputs[k]) for k in ("q", "kc", "vc"))
    cl = torch.from_numpy(inputs["cache_len"]).long()
    cfg = reduced(get_arch("deepseek-7b"))
    mesh = Mesh(["cpu"] * 8, ("data",))
    kv_spec = P(None, "data", None, None)
    fn = make_seq_parallel_decode(mesh, ("data",), kv_spec, P(None, None, None, None))
    reset_transfer_counts()
    got = fn(q, place(kc, NamedSharding(mesh, kv_spec)),
             place(vc, NamedSharding(mesh, kv_spec)), cl)
    assert transfer_counts()["between_places"] > 0
    want = decode_attention(q, kc, vc, cfg, cl, window=0)
    jwant = np.asarray(jax_decode_attention(
        jnp.asarray(inputs["q"]), jnp.asarray(inputs["kc"]), jnp.asarray(inputs["vc"]),
        jax_reduced(jax_get_arch("deepseek-7b")), jnp.asarray(inputs["cache_len"]), window=0))
    assert got.shape == want.shape == (SP["B"], 1, SP["H"], SP["D"])
    assert float((got - want).abs().max()) <= DECODE_TOL
    assert float(np.abs(got.numpy() - jwant).max()) <= DECODE_TOL
    assert float(np.abs(got.numpy() - res["seq_parallel"]).max()) <= DECODE_TOL
    # heads over a second axis too: the same output
    mesh2 = Mesh(["cpu"] * 8, ("data", "model"), (4, 2))
    fn2 = make_seq_parallel_decode(mesh2, "data", P(None, "data", "model", None),
                                   P(None, None, "model", None))
    assert float((fn2(q, kc, vc, cl) - want).abs().max()) <= DECODE_TOL


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------
def test_elastic_checkpoint_remesh(tmp_path):
    """Save on a (4,2) mesh, restore on (2,2) with swapped specs: equal bit
    for bit, each place holding its new block."""
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8), "b": torch.ones(8)}
    mesh8 = make_host_mesh(4, 2)
    sh8 = {"w": NamedSharding(mesh8, P("data", "model")), "b": NamedSharding(mesh8, P("model"))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {k: place(v, sh8[k]) for k, v in t.items()})
    mesh4 = make_host_mesh(2, 2)
    sh4 = {"w": NamedSharding(mesh4, P("model", "data")), "b": NamedSharding(mesh4, P(None))}
    reset_transfer_counts()
    restored, step = mgr.restore(t, shardings=sh4)
    assert step == 1 and transfer_counts()["host_to_place"] == (64 + 4 * 8) * 4
    for k in t:
        assert isinstance(restored[k], Placed) and restored[k].sharding == sh4[k]
        assert torch.equal(gather(restored[k], "cpu"), t[k])
        for i in range(4):
            assert torch.equal(restored[k].blocks[i], t[k][restored[k].slices(i)])
    again, _ = mgr.restore(restored)                   # a placed target: its own mesh
    assert all(again[k].sharding == sh4[k] for k in t)


def test_launcher_mesh_runs_and_its_checkpoints_restore_on_1x1(tmp_path, capsys):
    """``--mesh 2x2 --reduced --device cpu``: 4 steps and the JAX launcher's
    line; its step-4 checkpoint restores onto a 1x1 mesh equal to itself,
    and holds the one-device launcher's at ``--microbatches 2`` within the
    bf16 envelope (LAUNCHER_LOSS_TOL, LAUNCHER_UPDATE_TOL: the dense layers'
    compute is split, each partial sum rounding apart in bf16;
    ``_hold_split_step`` holds the split step in float32).  ``--mesh 2x1``
    (model size 1, nothing split): its step-4 checkpoint equals the
    one-device launcher's bit for bit."""
    base = ["--arch", "gemma2-2b", "--reduced", "--steps", "4", "--ckpt-every", "2",
            "--device", "cpu"]
    train_launcher.main(base + ["--mesh", "2x2", "--ckpt-dir", str(tmp_path / "mesh")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("steps=4 restarts=0 stragglers=") and "tokens/s=" in line
    mesh_loss = float(line.split("loss=")[1].split()[0])
    train_launcher.main(base + ["--mesh", "2x1", "--ckpt-dir", str(tmp_path / "dp")])
    rec = train_launcher.train_lm(train_launcher.parser().parse_args(
        base + ["--microbatches", "2", "--ckpt-dir", str(tmp_path / "one")]))
    assert rec["steps"] == 4 and rec["mesh"] is None
    assert abs(mesh_loss - rec["loss"]) <= LAUNCHER_LOSS_TOL * max(1.0, abs(rec["loss"]))
    cfg = reduced(get_arch("gemma2-2b"))
    tc = TrainConfig(warmup_steps=1)
    target = init_train_state(build_model(cfg, device="cpu"), tc, 1)
    one_ckpt = CheckpointManager(str(tmp_path / "one"))
    dp, _ = CheckpointManager(str(tmp_path / "dp")).restore(target, step=4)
    want, _ = one_ckpt.restore(target, step=4)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(dp), tree.leaves(want)))
    mesh_ckpt = CheckpointManager(str(tmp_path / "mesh"))
    assert mesh_ckpt.all_steps() == [0, 2, 4]
    got, _ = mesh_ckpt.restore(target, step=4)
    start, _ = one_ckpt.restore(target, step=0)
    mesh_start, _ = mesh_ckpt.restore(target, step=0)
    assert torch.equal(got["opt"]["step"], want["opt"]["step"])
    for (path, p4), w4, p0, q0 in zip(tree.flatten_with_paths(got["params"]),
                                      tree.leaves(want["params"]), tree.leaves(start["params"]),
                                      tree.leaves(mesh_start["params"])):
        assert torch.equal(p0, q0), path
        upd, want_upd = (p4 - p0).double(), (w4 - p0).double()
        assert (upd - want_upd).norm() <= LAUNCHER_UPDATE_TOL * want_upd.norm(), path
    mesh1 = make_host_mesh(1, 1)
    rules = AxisRules(make_rules(cfg, ShapeConfig("cli", 128, 8, "train"), model_size=1,
                                 dp_size=1))
    ps = param_specs(target["params"], cfg, rules, 1)
    specs = {"params": ps, "opt": opt_specs(target["opt"], ps, cfg, rules,
                                            mesh_shape_dict(mesh1), tc.zero1), "step": None}
    specs["opt"]["step"] = None
    on1, _ = mesh_ckpt.restore(target, step=4, shardings=named_shardings(mesh1, specs))
    for a, b in zip(tree.leaves(on1), tree.leaves(got)):
        assert torch.equal(a.blocks[0] if isinstance(a, Placed) else a, b)


# ---------------------------------------------------------------------------
# remat: drops counted once, no cycle left
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("local", [False, True], ids=["dense", "local"])
def test_count_drops_once_under_remat(local):
    """One train step of reduced phi3.5-moe at a capacity factor where
    slots drop: under remat "full" and "dots" the drops read as without
    remat, one count a MoE call (a recomputed forward is not counted)."""
    cfg = dataclasses.replace(reduced(get_arch("phi3.5-moe-42b-a6.6b")), capacity_factor=0.5)
    m = build_model(cfg, device="cpu")
    b = _batches(cfg.vocab, n=1, seed=2)[0]
    ctx = (flags.use_local_moe_dispatch(make_host_mesh(2, 2), ("data",), "model")
           if local else flags.use_scan_unroll(False))
    counts = {}
    with ctx:
        for remat in ("none", "full", "dots"):
            tc = TrainConfig(remat=remat, compute_dtype="float32")
            with moe.count_drops() as drops:
                make_train_step(m, tc)(init_train_state(m, tc, 0), b)
            counts[remat] = [int(d) for d in drops]
    assert len(counts["none"]) == cfg.n_layers and sum(counts["none"]) > 0
    assert counts["full"] == counts["none"] == counts["dots"], counts


def test_remat_step_leaves_no_cycle_holding_its_copies():
    """In a fresh process, a weak reference to each remat step's
    compute-dtype copy dies when the step returns, the garbage collector
    off: remat's first ``torch.utils.checkpoint`` call (which imports
    ``torch._dynamo``) leaves no cycle that holds the caller's frames."""
    code = textwrap.dedent("""
        import dataclasses, gc, json, weakref, torch
        from repro_torch.configs import TrainConfig, get_arch, reduced
        from repro_torch.data import lm_batches
        from repro_torch.models import build_model
        from repro_torch.training import init_train_state, make_train_step
        cfg = reduced(get_arch("gemma2-2b"))
        m = build_model(cfg, device="cpu")
        refs = []
        def loss(p, batch):
            refs.append(weakref.ref(p["embed"]))
            return m.loss(p, batch)
        m2 = dataclasses.replace(m, loss=loss)
        b = {k: torch.from_numpy(v) for k, v in next(iter(lm_batches(cfg.vocab, 2, 16, 1))).items()}
        out = {}
        for remat in ("full", "dots"):
            tc = TrainConfig(remat=remat)
            state, step = init_train_state(m2, tc, 0), make_train_step(m2, tc)
            for i in range(2):
                refs.clear()
                gc.disable()
                step(state, b)
                out[f"{remat}{i}"] = [r() is None for r in refs]
                gc.enable()
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res and all(v and all(v) for v in res.values()), res
