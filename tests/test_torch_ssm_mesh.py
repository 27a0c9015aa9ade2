"""PyTorch port: the hybrid's Mamba2 mixer over a mesh of CPU places
(``devices=["cpu"] * n``), as JAX places it.

  * the SSD's d_inner channels cut over the model places where
    ``make_rules`` binds ``ssm_inner`` (JAX's ``lshard(x, ..., "ssm_inner")``,
    ``src/repro/models/ssm.py:141``): reduced zamba2 (d_inner 256, 4 heads of
    64 channels, two SSD chunks of 16 a sequence), the placed step's
    ``compute_grads`` (AdamW with ZeRO-1, whose owner blocks cut ``w_in``'s
    columns across the places' pieces) against the one-device step's at
    ``microbatches`` = the data size: at (2,2) and (1,4) (whole heads a
    place) and (1,8) (half a head a place) the loss and every gradient in
    float32 within SPLIT_TOL (rtol 1e-5, atol 1e-6); at model size 1 bit
    for bit; where ``ssm_inner`` unbinds (3 places: 256 % 3) the mixer runs
    at home and the step is bit for bit the one-device step, as before the
    split;
  * each place's gradient of a replicated Mamba2 weight covers only what it
    read: the bytes each place hands to the owners;
  * the placed prefill on (1,8): its ``ssm`` and ``conv`` cache, put
    together from head and channel blocks on every place, against the
    one-device prefill (DECODE_TOL);
  * decode's replicated states updated on every place that holds a copy
    (zamba2's ``ssm``/``conv``, xlstm-125m's ``C, n, m, c, h``), at (2,2)
    and at long context on (4,2) (a batch of one: every place holds the
    state): no ``cache_sync``, the layer's input handed to each holder
    (``state_in``), after every step each place's copy bit for bit home's,
    the logits against the one-device decode (DECODE_TOL).
"""
import functools

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ShapeConfig, TrainConfig, get_arch, reduced
from repro_torch.data import lm_batches
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import (batch_specs, cache_specs, opt_specs,
                                            param_specs)
from repro_torch.distributed.sharding import (AxisRules, NamedSharding, P, Placed, gather,
                                              place, reset_transfer_counts, transfer_counts,
                                              use_rules)
from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
from repro_torch.models import build_model
from repro_torch.models.transformer import params_tree
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_step import global_norm, make_placed_train_step

torch.set_num_threads(1)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)     # chip_smoke phase train_resume's envelope
DECODE_TOL = 1e-5                          # tests/test_torch_lm.py
B, S = 4, 32                               # two SSD chunks of 16 a sequence
HYBRID, XLSTM = "zamba2-2.7b", "xlstm-125m"


@functools.lru_cache(maxsize=None)
def _model(arch=HYBRID):
    return build_model(reduced(get_arch(arch)), device="cpu")


def _batch(vocab, seed=5):
    return {k: torch.from_numpy(v) for k, v in next(iter(lm_batches(vocab, B, S, 1, seed=seed))).items()}


class _Calls:
    """Counts ``tensor_parallel.channel_split``'s calls."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = tp.channel_split

        def counted(*a):
            self.n += 1
            return real(*a)

        monkeypatch.setattr(tp, "channel_split", counted)


def _grads(D, M):
    """(placed loss, placed gradients gathered, one-device loss, one-device
    gradients, bytes handed by kind) of one step of reduced zamba2 on (D, M)
    places, AdamW with ZeRO-1 in float32."""
    model = _model()
    tc = TrainConfig(zero1=True, compute_dtype="float32", warmup_steps=1)
    mesh = make_host_mesh(D, M)
    shp = ShapeConfig("t", S, B, "train")
    rules_d = make_rules(model.cfg, shp, model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    state = init_train_state(model, tc, 0)
    ps = param_specs(state["params"], model.cfg, rules, M)
    os_ = opt_specs(state["opt"], ps, model.cfg, rules, mesh_shape_dict(mesh), tc.zero1)
    step = make_placed_train_step(model, tc, mesh, {"params": ps, "opt": os_, "step": P()},
                                  batch_specs(model.cfg, shp, rules))
    b = _batch(model.cfg.vocab)
    with use_rules(rules_d):
        placed = step.place_state(state)
        reset_transfer_counts()
        loss, _, grads = step.compute_grads(placed["params"], b)
        moved = transfer_counts()["bytes"]
    ref = make_train_step(model, TrainConfig(zero1=True, compute_dtype="float32",
                                             warmup_steps=1, microbatches=D))
    wloss, _, wgrads = ref.compute_grads(state["params"], b)
    return loss, [gather(g, "cpu") for g in grads], wloss, tree.leaves(wgrads), moved


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (1, 8)], ids=["2x2", "1x4", "1x8_half_heads"])
def test_split_step_matches_one_device(monkeypatch, mesh):
    """The loss, and the gradients at the scale the optimizer takes them
    (the clip's, as ``tests/test_torch_lm_mesh._hold_step`` holds them),
    within SPLIT_TOL of the one-device step's."""
    calls = _Calls(monkeypatch)
    loss, grads, wloss, wgrads, moved = _grads(*mesh)
    cfg = _model().cfg
    assert calls.n == cfg.n_layers * mesh[0]          # every layer of every replica split
    torch.testing.assert_close(loss, wloss, **SPLIT_TOL)
    scale = min(1.0, TrainConfig().grad_clip / float(global_norm(wgrads)))   # the clip's
    for n, (g, w) in enumerate(zip(grads, wgrads)):
        torch.testing.assert_close(g * scale, w * scale, **SPLIT_TOL, msg=f"leaf {n}")
    assert moved["tp_sum"] > 0 and moved["tp_sum_grad"] > 0


@pytest.mark.parametrize("mesh", [(2, 1), (1, 3), (2, 3)], ids=["2x1", "1x3", "2x3"])
def test_model_size_one_or_unbound_stays_home_bit_for_bit(monkeypatch, mesh):
    """At model size 1, and where ``make_rules`` unbinds ``ssm_inner``
    (d_inner 256 over 3 places), the mixer runs once at the replica's home
    and the step is the one-device step bit for bit."""
    D, M = mesh
    assert (make_rules(_model().cfg, model_size=M)["ssm_inner"] is None) == (M == 3)
    calls = _Calls(monkeypatch)
    loss, grads, wloss, wgrads, _ = _grads(D, M)
    assert calls.n == 0
    assert torch.equal(loss, wloss)
    for n, (g, w) in enumerate(zip(grads, wgrads)):
        assert torch.equal(g, w), n


def test_gradient_of_a_replicated_weight_covers_what_was_read():
    """On (1,4) each place's gradient of a Mamba2 weight is of its pieces
    alone (``grad_sources``' regions, ``split_regions``): w_in's columns of
    z, x and dt of its own channels and heads, w_out's rows of its
    channels; place 0's also of B and C, which it computes for all.  The
    places' pieces tile each leaf: no gradient element is handed twice."""
    from repro_torch.models import ssm
    model = _model()
    cfg = model.cfg
    mesh = make_host_mesh(1, 4)
    rules = AxisRules(make_rules(cfg, model_size=4, dp_size=1))
    params = init_train_state(model, TrainConfig(), 0)["params"]
    ps = param_specs(params, cfg, rules, 4)
    placed = tree.tree_map(lambda t, s: place(t, NamedSharding(mesh, s)), params, ps)
    view = tp.replica_view(placed, mesh, 0)
    sources = tp.grad_sources(placed, view, 0)
    di, nh, _ = ssm.ssm_dims(cfg)
    ds = cfg.ssm_state
    seen = 0
    for (path, pp), v, srcs in zip(tree.flatten_with_paths(placed), tree.leaves(view), sources):
        if "mamba" not in path:
            continue
        seen += 1
        assert isinstance(v, tp.Pieces) and v.places == (0, 1, 2, 3)
        assert [i for i, _ in srcs] == [i for i, part in enumerate(v.parts) for _ in part]
        for (_, reg), t in zip(srcs, v.tensors):
            assert tuple(t.shape) == tuple(r.stop - r.start for r in reg)
        cover = torch.zeros(pp.shape, dtype=torch.int32)
        for _, reg in srcs:
            cover[reg] += 1
        assert bool((cover >= 1).all()), path
        assert int(cover.max()) == 1, path
        if path[-1] in ("w_in", "conv_w", "conv_b"):
            lo = 2 * di if path[-1] == "w_in" else di
            bc = [reg for i, reg in srcs if reg[-1] == slice(lo, lo + 2 * ds)]
            assert [i for i, reg in srcs if reg in bc] == [0], path
    assert seen == 8


def _prefill(arch, D, M, Bp, Sp, Smax):
    """The placed prefill of reduced ``arch`` on (D, M): (its cache, the
    one-device prefill's)."""
    cfg = reduced(get_arch(arch))
    model = _model(arch)
    params = params_tree(model.init_params(0))
    toks = torch.randint(0, cfg.vocab, (Bp, Sp), generator=torch.Generator().manual_seed(7))
    mesh = make_host_mesh(D, M)
    rules_d = make_rules(cfg, ShapeConfig("p", Smax, Bp, "prefill"), model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    ps = param_specs(params, cfg, rules, M)
    cs = cache_specs(model.init_cache(Bp, Smax, torch.float32), cfg, rules)
    with use_rules(rules_d):
        prefill = tp.make_placed_prefill(cfg, mesh, ps, batch_specs(
            cfg, ShapeConfig("p", Sp, Bp, "prefill"), rules), cs, max_seq=Smax)
        _, cache = prefill(params, {"tokens": toks})
    _, _, want = model.forward(params, {"tokens": toks}, build_cache=True, max_seq=Smax)
    return cache, want


def test_prefill_states_put_together_from_half_heads(monkeypatch):
    """(1,8): each place computes half a head; the ``ssm`` state comes out
    in 8 half-head blocks and ``conv`` in 8 channel blocks and B and C's,
    put together once on each of the 8 places (``cache_place``), against
    the one-device prefill."""
    calls = _Calls(monkeypatch)
    reset_transfer_counts()
    cache, want = _prefill(HYBRID, 1, 8, 2, 24, 32)
    cfg = _model().cfg
    assert calls.n == cfg.n_layers
    moved = transfer_counts()["bytes"]
    for key in ("ssm", "conv"):
        pp = cache[key]
        assert isinstance(pp, Placed)
        for i in range(8):
            torch.testing.assert_close(pp.blocks[i], want[key], rtol=0, atol=DECODE_TOL,
                                       msg=f"{key} at place {i}")
    # each place gets the seven eighths of the states that the others
    # computed (B and C's conv state from place 0), and its eighth of the
    # keys' and values' positions (4 heads do not divide over 8 places: the
    # attention ran at home)
    nbytes = {k: want[k].numel() * want[k].element_size() for k in want if k != "pos"}
    assert moved["cache_place"] == 7 * (nbytes["ssm"] + nbytes["conv"]) + sum(
        7 * nbytes[k] // 8 for k in ("attn_k", "attn_v"))


def _copies_equal_home(cache):
    """Every place's copy of every replicated state leaf equals the copy
    at its replica's home (the first place with its rows), bit for bit."""
    for key, val in cache.items():
        if key in tp.KV_LEAVES or key == "pos":
            continue
        for pp in tree.leaves(val):
            first = {}
            for i, blk in enumerate(pp.blocks):
                sl = pp.slices(i)
                if sl not in first:
                    first[sl] = blk
                assert torch.equal(blk, first[sl]), (key, i)


def _decode_run(arch, D, M, Bp, Sp, n, long_context=False):
    """``n`` teacher-forced placed decode steps from the one-device
    prefill's cache placed by ``cache_specs``: (each step's logits error
    against the one-device decode, the bytes handed by kind, the placed
    cache, the one-device cache, the config); every place's state copies
    checked against home's after every step."""
    cfg = reduced(get_arch(arch))
    model = _model(arch)
    params = params_tree(model.init_params(0))
    Smax = 32
    toks = torch.randint(0, cfg.vocab, (Bp, Sp + n), generator=torch.Generator().manual_seed(2))
    _, _, cache1 = model.forward(params, {"tokens": toks[:, :Sp]}, build_cache=True,
                                 max_seq=Smax)
    _, _, cache2 = model.forward(params, {"tokens": toks[:, :Sp]}, build_cache=True,
                                 max_seq=Smax)
    mesh = make_host_mesh(D, M)
    kind = "decode" if long_context else "prefill"
    rules_d = make_rules(cfg, ShapeConfig("d", Smax, Bp, kind), model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    cs = cache_specs(cache2, cfg, rules, long_context=long_context)
    placed = {k: v if k == "pos" else tree.tree_map(
        lambda t, s: place(t, NamedSharding(mesh, s)), v, cs[k]) for k, v in cache2.items()}
    errs = []
    with use_rules(rules_d):
        decode = tp.make_placed_decode(cfg, mesh, param_specs(params, cfg, rules, M),
                                       rules.spec(("batch", None)),
                                       kv_seq=rules_d.get("kv_seq") if long_context else None)
        reset_transfer_counts()
        for t in range(Sp, Sp + n):
            lg, placed = decode(params, toks[:, t:t + 1], placed)
            want, cache1 = model.decode_step(params, toks[:, t:t + 1], cache1)
            errs.append(float((lg - want).abs().max()))
            _copies_equal_home(placed)
        moved = transfer_counts()["bytes"]
    return errs, moved, placed, cache1, cfg


@pytest.mark.parametrize("arch", [HYBRID, XLSTM], ids=["zamba2", "xlstm"])
@pytest.mark.parametrize("mesh,long_context", [((2, 2), False), ((4, 2), True)],
                         ids=["2x2", "long_4x2"])
def test_decode_updates_states_where_held(arch, mesh, long_context):
    Bp = 1 if long_context else 4
    errs, moved, placed, cache1, cfg = _decode_run(arch, *mesh, Bp, 12, 4, long_context)
    assert max(errs) <= DECODE_TOL, errs
    assert "cache_sync" not in moved
    holders = mesh[0] * mesh[1] if long_context else mesh[1]
    replicas = 1 if long_context else mesh[0]
    # to each holder but home, a step, its rows' float32: the layer's input
    # (d), or the mLSTM's projections (q, k, v of H x dh, log_i, log_f)
    rows, (d, H) = Bp // replicas, (cfg.d_model, cfg.n_heads)
    per = [3 * 2 * d + 2 * H if arch == XLSTM and i not in cfg.slstm_at else d
           for i in range(cfg.n_layers)]
    assert moved["state_in"] == 4 * replicas * (holders - 1) * rows * sum(per) * 4
    key = "ssm" if arch == HYBRID else "states"
    for got, want in zip(tree.leaves(placed[key]), tree.leaves(cache1[key])):
        torch.testing.assert_close(gather(got, "cpu"), want, rtol=0, atol=DECODE_TOL)
