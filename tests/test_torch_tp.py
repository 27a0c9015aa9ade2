"""PyTorch port: the dense layers' compute split along the model axis
(``distributed/tensor_parallel.py``) on the CPU, places on
``devices=["cpu"] * n``.

  * the placed train step with the split against the one-device step at
    ``microbatches`` = the data size, reduced dense (deepseek-7b), MoE
    (phi3.5-moe), hybrid (zamba2), M-RoPE VLM (qwen2-vl) and encoder
    (hubert) on (2, 2) and (2, 4): the parameters after 3 steps within
    SPLIT_TOL (rtol 1e-5, atol 1e-6; float32 compute).  SGD, whose update is
    the gradient scaled: AdamW moves a parameter whose gradient is below its
    eps by lr |g| / eps, so a gradient's float32 rounding of ~1e-9 moves it
    by ~1e-5 (``test_torch_lm_mesh._hold_step`` holds AdamW, ZeRO-1,
    Adafactor and int8 EF at the optimizer's input instead).  At (2, 4)
    reduced's 2 kv heads do not divide over 4 places: each place computes
    both and attends with the one its q heads read;
  * no weight block the model axis cuts is gathered whole, in the train
    step (AdamW with ZeRO-1, and with FSDP cuts over the data places), the
    placed prefill and the placed decode;
  * the placed prefill and 7 decode steps against the one-device forward
    (DECODE_TOL 1e-5) and against JAX's forward with JAX's weights carried
    in (LOGIT_TOL 2e-5, tests/test_torch_lm.py's): heads cut with the cache
    by heads (gemma2, 2x2), kv heads unbound with the cache cut along its
    positions over the model places (gemma2, 1x4), the hybrid, the MoE;
  * long-context decode: a batch of one, the cache's positions split over
    the data places as ``make_rules`` binds ``kv_seq`` (zamba2, 4x2), against
    the one-device decode;
  * the hybrid's Mamba2 states: the placed prefill's ``ssm``/``conv`` cache
    against the one-device prefill's (DECODE_TOL) and JAX's (LOGIT_TOL);
    decode with no ``cache_sync``, every place updating its own copy of the
    states from the layer's input (``state_in``), bit for bit home's after
    every step (2x2, and at long context on 4x2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs import ShapeConfig, TrainConfig, get_arch, reduced
from repro_torch.data import lm_batches
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import (batch_specs, cache_specs, opt_specs,
                                            param_specs)
from repro_torch.distributed.sharding import (AxisRules, NamedSharding, P, Placed,
                                              current_scope, gather, place,
                                              reset_transfer_counts, transfer_counts,
                                              use_rules)
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
from repro_torch.models import build_model
from repro_torch.models.transformer import params_tree
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_step import make_placed_train_step

torch.set_num_threads(1)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)     # chip_smoke phase train_resume's envelope
DECODE_TOL = 1e-5                          # tests/test_torch_lm.py
LOGIT_TOL = 2e-5                           # tests/test_torch_lm.py
FAMILIES = {"dense": "deepseek-7b", "moe": "phi3.5-moe-42b-a6.6b", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-72b", "encoder": "hubert-xlarge"}
MESHES = ((2, 2), (2, 4))
B, S = 8, 16
STEP_KW = dict(learning_rate=1e-2, warmup_steps=1, optimizer="sgd", compute_dtype="float32")


def _batches(cfg, n=3, seed=5):
    rng = np.random.default_rng(50 + seed)
    out = []
    for b in lm_batches(cfg.vocab, B, S, n, seed=seed):
        if not cfg.embed_inputs:
            b = {"embeds": rng.standard_normal((B, S, cfg.d_in)).astype(np.float32),
                 "labels": b["labels"]}
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def _placed(model, tc, D, M, fsdp=0):
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
def _model(arch):
    return build_model(reduced(get_arch(arch)), device="cpu")


@functools.lru_cache(maxsize=None)
def _one_device(arch, D):
    m = _model(arch)
    tc = TrainConfig(**STEP_KW, microbatches=D)
    state, step = init_train_state(m, tc, 0), make_train_step(m, tc)
    for b in _batches(m.cfg):
        state, _ = step(state, b)
    return state["params"]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("family", list(FAMILIES))
def test_split_step_matches_one_device(family, mesh):
    D, M = mesh
    arch = FAMILIES[family]
    m = _model(arch)
    step, state, rules_d = _placed(m, TrainConfig(**STEP_KW), D, M)
    reset_transfer_counts()
    with use_rules(rules_d):
        for b in _batches(m.cfg):
            state, met = step(state, b)
    moved = transfer_counts()["bytes"]
    assert moved.get("tp_sum", 0) > 0 and moved.get("tp_sum_grad", 0) > 0
    assert bool(torch.isfinite(met["loss"]))
    want = _one_device(arch, D)
    for (path, got), w in zip(tree.flatten_with_paths(state["params"]), tree.leaves(want)):
        torch.testing.assert_close(gather(got, "cpu"), w, **SPLIT_TOL, msg=str(path))


def _model_cut(t) -> bool:
    return isinstance(t, Placed) and "model" in str(t.sharding.spec)


class _Made(TorchDispatchMode):
    """The shape of every tensor an op makes (``scoped``: only inside a
    placed run's replicas and their hand-overs home, ``work_scope``)."""

    def __init__(self, scoped=False):
        super().__init__()
        self.shapes, self.scoped = set(), scoped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.scoped and current_scope() is None:
            return out
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def _watch(monkeypatch):
    """Record the model block each replica reads of a placed leaf (its own
    block, or the plan of one assembled from the data places' pieces)."""
    seen = {"assembled": []}
    real_plan = tp._plan

    def plan_(pp, i, *a, **kw):
        out = real_plan(pp, i, *a, **kw)
        seen["assembled"].append((pp, tuple(pp.blocks[i].shape) if out is None
                                  else tuple(out[0])))
        return out

    monkeypatch.setattr(tp, "_plan", plan_)
    return seen


@pytest.mark.parametrize("fsdp", [0, 2], ids=["tp", "tp_fsdp"])
def test_no_model_block_gathered_whole(monkeypatch, fsdp):
    """AdamW with ZeRO-1 on (2, 4), the weights cut over the data places too
    where ``fsdp``: no op makes a tensor of the whole shape of a parameter
    the model axis cuts (no gather, no whole gradient), and every block a
    replica assembles of one is 1/M of it along the cut; the placed prefill
    and decode make none either."""
    seen = _watch(monkeypatch)
    m = _model("deepseek-7b")
    tc = TrainConfig(zero1=True, compute_dtype="float32", warmup_steps=1)
    step, state, rules_d = _placed(m, tc, 2, 4, fsdp)
    with use_rules(rules_d):
        state = step.place_state(state)
        with _Made() as made:
            step(state, _batches(m.cfg, 1)[0])
    cut = [p for p in tree.leaves(state["params"]) if _model_cut(p)]
    assert len(cut) >= 6
    assert not {tuple(p.shape) for p in cut} & made.shapes
    assembled = [(pp, shp) for pp, shp in seen["assembled"] if _model_cut(pp)]
    assert assembled and all(np.prod(shp) * 4 == pp.shape.numel() for pp, shp in assembled)
    if fsdp:
        assert transfer_counts()["bytes"].get("fsdp_gather", 0) > 0
    seen["assembled"].clear()
    with _Made(scoped=True) as made:        # the weights' making and placing left out
        _, _, params = _prefill_decode("gemma2-2b", 2, 4, steps=2)
    assembled = [(pp, shp) for pp, shp in seen["assembled"] if _model_cut(pp)]
    assert assembled and all(np.prod(shp) * 4 == pp.shape.numel() for pp, shp in assembled)
    cfg = reduced(get_arch("gemma2-2b"))
    rules = AxisRules(make_rules(cfg, ShapeConfig("p", 32, 4, "prefill"), model_size=4,
                                 dp_size=2))
    model_cut = {tuple(t.shape) for t, s in zip(tree.leaves(params),
                                               tree.leaves(param_specs(params, cfg, rules, 4)))
                 if "model" in str(s)}
    assert model_cut and not model_cut & made.shapes


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_pair(arch):
    """JAX's reduced model, its parameters, and the port's params tree with
    the same weights."""
    jm = jax_build_model(jax_reduced(jax_get_arch(arch)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    arrays = jax.tree_util.tree_map(np.asarray, jp)
    cfg = reduced(get_arch(arch))
    return jm, jp, params_tree(lm_params_from_arrays(cfg, arrays, device="cpu"))


def _copies_equal_home(cache) -> bool:
    """Every place's copy of every replicated state leaf (not keys or
    values) bit for bit the copy at the first place holding its rows."""
    same = True
    for key, val in cache.items():
        if key in tp.KV_LEAVES or key == "pos":
            continue
        for pp in tree.leaves(val):
            first = {}
            for i, blk in enumerate(pp.blocks):
                same &= torch.equal(blk, first.setdefault(pp.slices(i), blk))
    return same


def _prefill_decode(arch, D, M, steps=7, Bp=4, Sp=16, seen=None):
    """Placed prefill of Sp tokens then ``steps`` decode steps, teacher
    forced: (logits a position (B, V) each, tokens, the port's params).
    ``seen`` (a dict) gets the prefill's ``ssm`` and ``conv`` gathered, and
    after each decode step whether every place's state copies equal
    home's."""
    cfg = reduced(get_arch(arch))
    _, _, params = _jax_pair(arch)
    Smax = 32                      # divides over the places of a positions cut
    toks = torch.randint(0, cfg.vocab, (Bp, Sp + steps), generator=torch.Generator().manual_seed(7))
    mesh = make_host_mesh(D, M)
    rules_d = make_rules(cfg, ShapeConfig("p", Smax, Bp, "prefill"), model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    ps = param_specs(params, cfg, rules, M)
    cs = cache_specs(build_model(cfg, device="cpu").init_cache(Bp, Smax, torch.float32), cfg,
                     rules)
    out = []
    with use_rules(rules_d):
        prefill = tp.make_placed_prefill(cfg, mesh, ps, batch_specs(
            cfg, ShapeConfig("p", Sp, Bp, "prefill"), rules), cs, max_seq=Smax)
        lg, cache = prefill(params, {"tokens": toks[:, :Sp]})
        out.append(lg[:, 0])
        if seen is not None:
            seen["prefill"] = {k: gather(cache[k], "cpu") for k in ("ssm", "conv")
                               if k in cache}
            seen["copies_equal"] = []
        decode = tp.make_placed_decode(cfg, mesh, ps, rules.spec(("batch", None)))
        for t in range(Sp, Sp + steps):
            lg, cache = decode(params, toks[:, t:t + 1], cache)
            out.append(lg[:, 0])
            if seen is not None:
                seen["copies_equal"].append(_copies_equal_home(cache))
    assert cache["pos"] == Sp + steps
    return torch.stack(out, 1), toks, params


@pytest.mark.parametrize("arch,mesh", [("gemma2-2b", (2, 2)), ("gemma2-2b", (1, 4)),
                                       ("zamba2-2.7b", (2, 2)),
                                       ("phi3.5-moe-42b-a6.6b", (2, 2))],
                         ids=["heads_cut", "kv_unbound", "hybrid", "moe"])
def test_placed_prefill_decode_match_one_device_and_jax(arch, mesh):
    """The hybrid's Mamba2 mixer too: its SSD split over the model places in
    the prefill, whose ``ssm`` and ``conv`` cache, put together on every
    place, holds against the one-device and JAX prefills' caches; decode
    updates every place's copy of the states where it is held (no
    ``cache_sync``), each bit for bit home's after every step."""
    reset_transfer_counts()
    seen = {}
    got, toks, params = _prefill_decode(arch, *mesh, seen=seen)
    moved = transfer_counts()["bytes"]
    assert moved.get("tp_sum", 0) > 0 and "cache_sync" not in moved
    assert all(seen["copies_equal"])
    if mesh == (1, 4):
        assert moved.get("seq_partial", 0) > 0       # the positions cut over 4 places
    n = got.shape[1]                 # the prefill's last position, then each decode's
    Sp = toks.shape[1] - n + 1
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, device="cpu")
    full, _, _ = model.forward(params, {"tokens": toks})
    want = full[:, Sp - 1:Sp - 1 + n]
    torch.testing.assert_close(got, want, rtol=0, atol=DECODE_TOL)
    jm, jp, _ = _jax_pair(arch)
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks.numpy(), jnp.int32)})
    jwant = np.asarray(jl)[:, Sp - 1:Sp - 1 + n]
    assert float(np.abs(got.numpy() - jwant).max()) <= LOGIT_TOL
    if cfg.family == "hybrid":
        assert moved.get("state_in", 0) > 0 and moved.get("cache_place", 0) > 0
        _, _, one = model.forward(params, {"tokens": toks[:, :Sp]}, build_cache=True,
                                  max_seq=32)
        _, _, jcache = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :Sp].numpy(), jnp.int32)},
                                  build_cache=True, max_seq=32)
        for key in ("ssm", "conv"):
            torch.testing.assert_close(seen["prefill"][key], one[key], rtol=0,
                                       atol=DECODE_TOL, msg=key)
            assert float(np.abs(seen["prefill"][key].numpy()
                                - np.asarray(jcache[key])).max()) <= LOGIT_TOL, key


def test_long_context_decode_splits_positions_over_data_places():
    """A batch of one (``make_rules`` unbinds batch and binds ``kv_seq`` to
    the data axis): the cache placed by ``cache_specs(long_context=True)``
    (kv heads over the model places, every data place holding every
    position), each data place attending to its quarter of the positions;
    8 decode steps against the one-device decode."""
    cfg = reduced(get_arch("zamba2-2.7b"))
    m = build_model(cfg, device="cpu")
    params = params_tree(m.init_params(0))
    Sp, n, Smax = 12, 8, 32
    toks = torch.randint(0, cfg.vocab, (1, Sp + n), generator=torch.Generator().manual_seed(2))
    _, _, cache1 = m.forward(params, {"tokens": toks[:, :Sp]}, build_cache=True, max_seq=Smax)
    _, _, cache2 = m.forward(params, {"tokens": toks[:, :Sp]}, build_cache=True, max_seq=Smax)
    mesh = make_host_mesh(4, 2)
    rules_d = make_rules(cfg, ShapeConfig("long", Smax, 1, "decode"), model_size=2, dp_size=4)
    assert rules_d["batch"] is None and rules_d["kv_seq"] == ("data",)
    rules = AxisRules(rules_d)
    cs = cache_specs(cache2, cfg, rules, long_context=True)
    placed = {k: v if k == "pos" else tree.tree_map(
        lambda t, s: place(t, NamedSharding(mesh, s)), v, cs[k]) for k, v in cache2.items()}
    with use_rules(rules_d):
        decode = tp.make_placed_decode(cfg, mesh, param_specs(params, cfg, rules, 2),
                                       rules.spec(("batch", None)), kv_seq=rules_d["kv_seq"])
        reset_transfer_counts()
        errs = []
        for t in range(Sp, Sp + n):
            lg, placed = decode(params, toks[:, t:t + 1], placed)
            want, cache1 = m.decode_step(params, toks[:, t:t + 1], cache1)
            errs.append(float((lg - want).abs().max()))
            assert _copies_equal_home(placed)         # each place updated its own copy
    assert transfer_counts()["count"].get("seq_partial", 0) >= 4 * 2 * 3 * n
    moved = transfer_counts()["bytes"]
    assert "cache_sync" not in moved
    # every place but home gets each layer's input row (1, 1, d) in float32
    assert moved["state_in"] == n * cfg.n_layers * 7 * cfg.d_model * 4
    assert max(errs) <= DECODE_TOL, errs
    for key in ("attn_k", "ssm"):
        torch.testing.assert_close(gather(placed[key], "cpu"), cache1[key], rtol=0,
                                   atol=DECODE_TOL)
