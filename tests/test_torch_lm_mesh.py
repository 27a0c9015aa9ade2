"""PyTorch port, the LM stack placed over a mesh, on the CPU: the
single-controller mesh of ``distributed/sharding.py`` with its places on
``devices=["cpu"] * n``.

  * ``place``/``gather``/``named_shardings``/``lshard`` and
    ``launch/mesh.py``;
  * the placed train step (``training/train_step.make_placed_train_step``)
    on reduced deepseek-7b with 4 kv heads, batch 8 x 16, for AdamW with and
    without ZeRO-1, SGD, Adafactor and int8 error feedback, against the
    one-device step at ``microbatches`` = the data size, each of 3 steps
    (``_hold_step``): at (2,1) the loss and each place's reduced gradient
    block bit for bit; at (2,4), (2,2) and (1,2), where the model axis
    splits the dense layers' compute, in float32 the loss and gradients
    within SPLIT_TOL; the clip norm within NORM_TOL; the update bit for bit
    with the one-device update of the same gradients at the placed clip
    (Adafactor's where places cut a leaf within ADAFACTOR_TOL); the same on
    2x2 with FSDP; no op making a tensor of a cut leaf's whole shape; the
    placed Adafactor and int8 EF's block form against their whole-leaf
    forms; FSDP's per-layer gathers lowering a placed forward's peak on
    meta (``assembled`` building nothing for a layer that gathers nothing);
    each place holds only its block, with ZeRO-1 and with FSDP too (its
    slice, its own storage); the losses of two steps within
    JAX's envelope (1e-3 x max(1, loss), tests/test_distributed.py) of
    JAX's single-device jitted step with the weights carried across, for
    ZeRO-1, ZeRO-1 with FSDP and Adafactor;
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
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.compression import (ef_amax, ef_compress, ef_compress_block,
                                                 ef_scale)
from repro_torch.distributed.sharding import _spec_axes, block_slices
from repro_torch.launch.dryrun import PlaceCount, from_host
from repro_torch.models.transformer import params_tree
from repro_torch.training.optim import (adafactor_update, adafactor_update_placed,
                                        lr_schedule, make_optimizer)
from repro_torch.training.train_step import global_norm, make_placed_train_step
from torch.utils._python_dispatch import TorchDispatchMode

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
NORM_TOL = dict(rtol=1e-6, atol=0.0)     # the clip norm's partial sums against one sum
ADAFACTOR_TOL = dict(rtol=1e-5, atol=1e-6)   # Adafactor's means from partial sums
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


def _placed_step(model, tc, D, M, fsdp=0):
    mesh = make_host_mesh(D, M)
    shp = ShapeConfig("t", S, B, "train")
    rules_d = make_rules(model.cfg, shp, model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    state = init_train_state(model, tc, 0)
    ps = param_specs(state["params"], model.cfg, rules, M, fsdp)
    os_ = opt_specs(state["opt"], ps, model.cfg, rules, mesh_shape_dict(mesh), tc.zero1)
    step = make_placed_train_step(model, tc, mesh, {"params": ps, "opt": os_, "step": P()},
                                  batch_specs(model.cfg, shp, rules))
    return step, state, rules_d


@functools.lru_cache(maxsize=None)
def _model():
    return build_model(_cfg(), device="cpu")


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


def _one_device_update(tc, state, grads, gn):
    """The one-device step's update (``train_step``'s body after its
    gradients) of ``state`` by ``grads`` at the placed step's clip: int8 EF
    on the whole leaves, the clip scale from the placed norm ``gn`` as
    ``clip_grads`` takes it from its own.  (The new state, the one-device
    norm of the same gradients.)"""
    if tc.grad_compression == "int8_ef":
        grads, err = ef_compress(grads, tree.leaves(state["ef_err"]))
        state["ef_err"] = tree.unflatten(state["ef_err"], err)
    own = global_norm(grads)
    scale = torch.clamp_max(tc.grad_clip / torch.clamp_min(gn, 1e-9), 1.0)
    grads = [g.float().mul_(scale) for g in grads]
    lr = lr_schedule(tc, state["step"])
    opt = {k: tree.leaves(v) if k != "step" else v for k, v in state["opt"].items()}
    params, opt = make_optimizer(tc)[1](grads, opt, tree.leaves(state["params"]), lr)
    return {**state, "params": tree.unflatten(state["params"], params),
            "opt": {**state["opt"], "step": opt["step"]}, "step": state["step"] + 1}, own


def _hold_step(variant, D, M, fsdp=0):
    """The placed step against the one-device step at microbatches = D,
    each of 3 steps from the placed state gathered: its two halves
    (``compute_grads``, then ``apply_grads``) held apart.

    At model size 1 the loss and each place's reduced gradient block are bit
    for bit the one-device loss and the same slice of its gradient.  Past
    it the dense layers' compute is split over the model places, which sums
    the row-parallel partials (and the vocab-parallel cross-entropy's terms)
    in another order: in float32 compute (bf16 would round each partial: the
    split's design, as Megatron's bf16 sums) the loss and the gradients at
    the scale the optimizer takes them (the clip's) within SPLIT_TOL.  The
    clip norm, a sum of each distinct block's sum of squares, within
    NORM_TOL of the one-device norm of the same gradients (the partial sums
    reorder it by design, as JAX's reduce-scatter does).  The update (int8
    EF, optimizer, ZeRO-1's hand-over) bit for bit with the one-device update
    of those same gradients at the placed step's clip scale; Adafactor's,
    whose means combine partial sums where the places cut a leaf, within
    ADAFACTOR_TOL past model size 1 or with FSDP.  (Not the parameters of
    two separate runs: where |g| is below AdamW's eps its update moves a
    parameter by lr |g| / eps, so a gradient's 1e-9 rounding moves it by
    1e-5, and int8's rounding edges by a quantisation step.)"""
    m = _model()
    tc = TrainConfig(**STEP_KW, **VARIANTS[variant],
                     **({} if M == 1 else {"compute_dtype": "float32"}))
    step, state, rules_d = _placed_step(m, tc, D, M, fsdp)
    ref_tc = dataclasses.replace(tc, microbatches=D)
    ref = make_train_step(m, ref_tc)
    with use_rules(rules_d):
        state = step.place_state(state)
        for b in _batches(m.cfg.vocab):
            whole = _whole(state)
            loss, metrics, grads = step.compute_grads(state["params"], b)
            wloss, _, wgrads = ref.compute_grads(whole["params"], b)
            wgrads = tree.leaves(wgrads)
            whole_g = [gather(g, "cpu") for g in grads]
            if M == 1:
                assert torch.equal(loss, wloss)
                for g, w in zip(grads, wgrads):
                    for i, blk in enumerate(g.blocks):
                        assert torch.equal(blk, w[g.slices(i)]), (g, i)
            else:
                torch.testing.assert_close(loss, wloss, **SPLIT_TOL)
                scale = min(1.0, tc.grad_clip / float(global_norm(wgrads)))   # the clip's
                for g, w in zip(whole_g, wgrads):
                    torch.testing.assert_close(g * scale, w * scale, **SPLIT_TOL)
            state, met = step.apply_grads(state, loss, metrics, grads)
            assert met.keys() == {"loss", "grad_norm", "lr", "ce", "aux"}
            want, own_gn = _one_device_update(ref_tc, whole, whole_g, met["grad_norm"])
            torch.testing.assert_close(met["grad_norm"], own_gn, **NORM_TOL)
            loose = variant == "adafactor" and (M > 1 or fsdp)
            for (path, got), w in zip(tree.flatten_with_paths(state), tree.leaves(want)):
                g = gather(got, "cpu") if isinstance(got, Placed) else got
                if loose:
                    torch.testing.assert_close(g, w, **ADAFACTOR_TOL, msg=str(path))
                else:
                    assert torch.equal(g, w), path


@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_placed_step_bitwise_with_one_device(variant, mesh):
    """At model size 1 the placed step's loss and gradient blocks are the
    one-device step's at microbatches = D bit for bit, its update the
    one-device update of the same gradients at its clip; past it, in the
    split's envelope (``_hold_step``)."""
    _hold_step(variant, *mesh)


@pytest.mark.parametrize("variant", ["adamw_zero1", "adafactor", "int8_ef"])
def test_fsdp_step_held_to_one_device(variant):
    """2x2 with the weights cut over the data places too (``fsdp_size`` 2:
    each stacked weight assembled a layer at a time, its gradient handed
    back to the pieces' places), held as ``_hold_step`` holds the rest."""
    _hold_step(variant, 2, 2, fsdp=2)


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


def test_each_place_holds_only_its_block_under_fsdp():
    """(2,2) with ZeRO-1 and the weights cut over the data places too
    (``fsdp_size`` 2): every block of a parameter, m and v is exactly its
    slice of the whole leaf (``block_slices``), 1/(the product of its
    spec's axes) of it, and no two places share storage."""
    D, M = 2, 2
    sizes = {"data": D, "model": M}
    m = _model()
    step, state, _ = _placed_step(m, TrainConfig(**STEP_KW, zero1=True), D, M, fsdp=2)
    whole = {k: tree.leaves(t) for k, t in (("params", state["params"]),
                                             ("m", state["opt"]["m"]), ("v", state["opt"]["v"]))}
    placed = step.place_state(state)
    held = {"params": tree.leaves(placed["params"]), "m": tree.leaves(placed["opt"]["m"]),
            "v": tree.leaves(placed["opt"]["v"])}
    fsdp_cut = 0
    for k in held:
        for w, pp in zip(whole[k], held[k]):
            axes = [a for e in pp.sharding.spec for a in _spec_axes(e)]
            fsdp_cut += k == "params" and "data" in axes
            for i in range(D * M):
                assert pp.blocks[i].numel() * int(np.prod([sizes[a] for a in axes])) == w.numel()
                assert torch.equal(pp.blocks[i], w[block_slices(pp.sharding, w.shape, i)])
    assert fsdp_cut >= 6
    for leaves in zip(*held.values()):
        ptrs = {b.data_ptr() for t in leaves for b in t.blocks}
        assert len(ptrs) == 3 * D * M


class _Allocs(TorchDispatchMode):
    """Every tensor an op makes: (its shape, its dtype)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.made.append((tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("fsdp", [0, 2], ids=["tp", "tp_fsdp"])
@pytest.mark.parametrize("variant", ["adamw_zero1", "adafactor", "int8_ef"])
def test_no_place_holds_a_whole_cut_leaf(variant, fsdp):
    """A step on 2x2 (and with the weights cut over the data places too):
    no op makes a tensor of the whole shape of a leaf that its specs cut,
    the gradients reduced to each place's block, the clip norm, int8's scale
    and Adafactor's means taken from partial sums, and no whole parameter,
    ``vr``, ``vc`` or error buffer gathered.  (The reduced model's other
    tensors have none of those shapes: the same step with the specs
    replicated makes them: d_ff 384 keeps an MLP block from having an
    attention weight's whole shape.)"""
    m = build_model(dataclasses.replace(_cfg(), d_ff=384), device="cpu")
    tc = TrainConfig(**STEP_KW, **VARIANTS[variant], compute_dtype="float32")
    step, state, rules_d = _placed_step(m, tc, 2, 2, fsdp)
    with use_rules(rules_d):
        state = step.place_state(state)
        leaves = [p for p in tree.leaves(state["params"])
                  if any(e is not None for e in p.sharding.spec)]
        cut = {tuple(p.shape) for p in leaves}
        with _Allocs() as seen:
            state, met = step(state, _batches(m.cfg.vocab, 1)[0])
    assert len(leaves) >= 6 and bool(torch.isfinite(met["loss"]))
    whole = [(s, dt) for s, dt in seen.made if s in cut]
    assert not whole, whole[:5]
    rstep, rstate, rrules = _placed_step(m, tc, 2, 1)     # model size 1: leaves whole
    with use_rules(rrules):
        rstate = rstep.place_state(rstate)
        with _Allocs() as seen:
            rstep(rstate, _batches(m.cfg.vocab, 1)[0])
    assert cut <= {s for s, _ in seen.made}


@pytest.mark.parametrize("mesh,fsdp", [((2, 2), 0), ((2, 2), 2), ((1, 4), 0), ((4, 1), 4)],
                         ids=["2x2", "2x2_fsdp", "1x4", "4x1_fsdp"])
def test_placed_adafactor_matches_one_device(mesh, fsdp):
    """``optim.adafactor_update_placed`` on every leaf of the reduced tree
    placed by its specs (dimensions cut over the model places, the data
    places, both) against the one-device ``adafactor_update`` of the same
    gradients, 3 steps: the parameters and each place's ``vr``/``vc`` block
    against its slice within ADAFACTOR_TOL (float32); a leaf no place cuts
    (its parameter, ``vr`` and ``vc``) bit for bit."""
    D, M = mesh
    m = _model()
    tc = TrainConfig(**STEP_KW, optimizer="adafactor")
    rules = AxisRules(make_rules(m.cfg, ShapeConfig("t", S, B, "train"), model_size=M,
                                 dp_size=D))
    hm = make_host_mesh(D, M)
    state = init_train_state(m, tc, 0)
    ps = param_specs(state["params"], m.cfg, rules, M, fsdp)
    os_ = opt_specs(state["opt"], ps, m.cfg, rules, mesh_shape_dict(hm), False)
    placed = {"p": tree.tree_map(lambda t, s: place(t, NamedSharding(hm, s)), state["params"], ps),
              "vr": tree.tree_map(lambda t, s: place(t, NamedSharding(hm, s)),
                                  state["opt"]["vr"], os_["vr"]),
              "vc": tree.tree_map(lambda t, s: place(t, NamedSharding(hm, s)),
                                  state["opt"]["vc"], os_["vc"])}
    rng = np.random.default_rng(3)
    opt = {"vr": tree.leaves(state["opt"]["vr"]), "vc": tree.leaves(state["opt"]["vc"]),
           "step": state["opt"]["step"]}
    params = tree.leaves(state["params"])
    n_cut = 0
    for k in range(3):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** -k)
                 for p in params]
        for g, pp, vr, vc in zip(grads, *(tree.leaves(placed[key]) for key in ("p", "vr", "vc"))):
            gp = place(g, pp.sharding)
            adafactor_update_placed(gp, vr, vc, pp, opt["step"], tc, 1e-2)
        params, opt = adafactor_update(grads, opt, params, tc, 1e-2)
        for key, want in (("p", params), ("vr", opt["vr"]), ("vc", opt["vc"])):
            for pp, got, w in zip(tree.leaves(placed["p"]), tree.leaves(placed[key]), want):
                cut = any(e is not None for e in pp.sharding.spec)
                n_cut += cut
                for i, blk in enumerate(got.blocks):
                    if cut:
                        torch.testing.assert_close(blk, w[got.slices(i)], **ADAFACTOR_TOL)
                    else:
                        assert torch.equal(blk, w), (key, got)
    assert n_cut > 0


def test_ef_compress_block_matches_whole_leaf():
    """int8 error feedback on a leaf cut in blocks (8, 4 ways along
    different dimensions): the scale from the blocks' maxima equals the
    whole leaf's bit for bit, and each block's dequantised gradient and new
    error equal the slices of ``ef_compress``'s."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32) * 1e-3)
    (deq,), (err,) = ef_compress([g], [e])
    for cuts in ((slice(0, 2), slice(2, 4)), (slice(0, 1), slice(1, 4))):
        for dim in (0, 1, 2):
            size = g.shape[dim]
            blocks = [tuple(slice(None) if d != dim else slice(size * c.start // 4,
                                                               size * c.stop // 4)
                            for d in range(3)) for c in cuts]
            scale = ef_scale(torch.stack([ef_amax(g[b], e[b]) for b in blocks]).amax())
            assert torch.equal(scale, ef_scale((g + e).abs().max()))
            for b in blocks:
                d, ne = ef_compress_block(g[b], e[b], scale)
                assert torch.equal(d, deq[b]) and torch.equal(ne, err[b])


def test_fsdp_forward_peak_falls_per_layer():
    """A placed forward on the meta device (8 layers, 2x2, the weights cut
    over the data places too): assembled one layer at a time, the peak of
    each place falls, against the same forward with every stacked weight
    assembled whole first, by at least (L-1)/L of that assembled stack."""
    cfg = dataclasses.replace(_cfg(), n_layers=8)
    params = params_tree(build_model(cfg, device="meta").init_params(0))
    hm = make_host_mesh(2, 2, devices=["meta"] * 4)
    rules_d = make_rules(cfg, ShapeConfig("p", S, B, "prefill"), model_size=2, dp_size=2)
    ps = param_specs(params, cfg, AxisRules(rules_d), 2, 2)
    placed = from_host(params, ps, hm)
    toks = torch.empty((B // 2, S), dtype=torch.int64, device="meta")
    peaks, stack = {}, [0] * 4
    for mode in ("layer", "whole"):
        with use_rules(rules_d), torch.no_grad(), PlaceCount(4) as count:
            view = tp.replica_view(placed, hm, 0)
            gathered = [v for v in tree.leaves(view) if isinstance(v, tp.Gathered)]
            if mode == "whole":
                for v in gathered:
                    for p, shp in zip(v.places, v.shapes):
                        stack[p] += int(np.prod(shp)) * v.dtype.itemsize
                view = tp.assembled(view)
            build_model(cfg, device="meta").forward(view, {"tokens": toks})
            del view
        peaks[mode] = list(count.peak)
    assert gathered and all(stack[p] > 0 for p in (0, 1))
    L = cfg.n_layers
    for p in (0, 1):              # the replica's two model places
        assert peaks["whole"][p] - peaks["layer"][p] >= (L - 1) / L * stack[p], (peaks, stack)


def test_assembled_keeps_a_layer_with_nothing_gathered():
    """``tensor_parallel.assembled`` hands back a layer that holds no
    ``Gathered`` as the same object (the one-device path builds nothing a
    layer), and in a placed FSDP view builds a new layer whose ``Gathered``
    are assembled and whose other leaves are the view's own."""
    from repro_torch.models.transformer import _as_params
    cfg = dataclasses.replace(_cfg(), n_layers=2)
    one = _as_params(params_tree(build_model(cfg, device="meta").init_params(0)))
    assert all(tp.assembled(lp) is lp for lp in one.layers)
    params = params_tree(build_model(cfg, device="meta").init_params(0))
    hm = make_host_mesh(2, 2, devices=["meta"] * 4)
    rules_d = make_rules(cfg, ShapeConfig("p", S, B, "prefill"), model_size=2, dp_size=2)
    placed = from_host(params, param_specs(params, cfg, AxisRules(rules_d), 2, 2), hm)
    with use_rules(rules_d), torch.no_grad():
        for lp in _as_params(tp.replica_view(placed, hm, 0)).layers:
            got = tp.assembled(lp)
            before, after = tree.leaves(vars(lp)), tree.leaves(vars(got))
            assert got is not lp and len(before) == len(after)
            assert any(isinstance(b, tp.Gathered) for b in before)
            for b, a in zip(before, after):
                assert (a is b) != isinstance(b, tp.Gathered)


@pytest.mark.parametrize("posture", ["zero1", "zero1_fsdp", "adafactor"])
def test_placed_step_loss_within_jax_envelope_of_single_device(posture):
    """JAX's state carried into the port: the losses of two steps of the
    placed step (2,4), bf16 compute, against JAX's single-device jitted
    step on the same batches: ZeRO-1, ZeRO-1 with the weights cut over the
    data places too (FSDP), and Adafactor."""
    kw = {"zero1": {"zero1": True}, "zero1_fsdp": {"zero1": True},
          "adafactor": {"optimizer": "adafactor"}}[posture]
    jm = jax_build_model(jax_reduced(jax_get_arch("deepseek-7b"), n_kv_heads=4))
    jtc = JaxTrainConfig(**kw)
    jstate = jax_init_train_state(jm, jtc, jax.random.PRNGKey(0))
    batches = list(lm_batches(_cfg().vocab, B, S, 2, seed=5))
    jstep = jax.jit(jax_make_train_step(jm, jtc))
    m = _model()
    tc = TrainConfig(**kw)
    step, _, rules_d = _placed_step(m, tc, 2, 4, 2 if posture == "zero1_fsdp" else 0)
    state = train_state_from_arrays(m.cfg, tc, jax.tree_util.tree_map(np.asarray, jstate),
                                    device="cpu")
    for b in batches:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref = float(jmet["loss"])
        with use_rules(rules_d):
            state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(met["loss"]) - ref) < JAX_LOSS_TOL * max(1.0, ref), (
            float(met["loss"]), ref)


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
    ``_hold_step`` holds the split step in float32).  ``--mesh 2x1``
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
