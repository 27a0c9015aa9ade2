"""PyTorch port: the placed step's gradients reduced once and gathered to
their owners (``tensor_parallel.reduce_grads``, ``gather_chunks``), as
JAX's all-reduce of a gradient runs, and the dry run's count of each place
whichever thread runs the backward (``launch/dryrun.PlaceCount``).

  * the placed ``compute_grads`` of reduced gemma2-2b and reduced zamba2,
    AdamW with and without ZeRO-1, on ``make_host_mesh`` at (2,2), (1,4),
    (2,3) (ragged chunks: blocks over 3 owners) and (4,1): each place's
    block equal, bit for bit, to what the reduce as it stood before made of
    the same gradients (every owner adding every part that covers its block
    to a whole-block accumulator: ``_owner_loop``, kept here as the plain
    reference); at model size 1 bit for bit the one-device step's at
    ``microbatches`` = the replicas, past it within SPLIT_TOL at the clip's
    scale; while the replicas run no place holds more than its chunk of a
    leaf with several owners;
  * one replicated leaf of L bytes, R places' gradients of it and O owners:
    the bytes of ``grad_reduce`` (each gradient's parts off its own
    place's chunk) and ``grad_gather`` ((O - 1) / O of L to the owners in
    all, each owner all but its own chunk) equal the closed form, no place
    receives more than 2 L, and each block is the sum of the gradients in
    order, with and without the microbatch accumulators;
  * the count a place: the 2x2 step of each (the hybrid's SSD split over
    the model places) with its backward on another thread (as the card's autograd runs it: the count's mode carried over,
    no thread-local place, scope or ``places_apart``) gives each place the
    FLOPs, the FLOPs by part and the peak of the caller-thread count; a
    column-parallel product charges each of M places 2 m n k / M of each of
    its three products, on either thread.
"""
import dataclasses
import functools
import math
import threading

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ShapeConfig, TrainConfig, get_arch, reduced
from repro_torch.data import lm_batches
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import batch_specs, opt_specs, param_specs
from repro_torch.distributed.sharding import (AxisRules, Mesh, NamedSharding, P,
                                              block_slices, gather, place, places_apart,
                                              reset_transfer_counts, transfer_counts,
                                              use_rules)
from repro_torch.launch.dryrun import PlaceCount
from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
from repro_torch.models import build_model
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_step import global_norm, make_placed_train_step

torch.set_num_threads(1)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)     # chip_smoke phase train_resume's envelope
B, S = 4, 32                               # zamba2: two SSD chunks of 16 a row
ARCHS = ("gemma2-2b", "zamba2-2.7b")
MESHES = ((2, 2), (1, 4), (2, 3), (4, 1))


@functools.lru_cache(maxsize=None)
def _model(arch):
    return build_model(reduced(get_arch(arch)), device="cpu")


def _batch(vocab, seed=5):
    return {k: torch.from_numpy(v) for k, v in next(iter(lm_batches(vocab, B, S, 1,
                                                                     seed=seed))).items()}


def _step(arch, D, M, zero1):
    model = _model(arch)
    tc = TrainConfig(zero1=zero1, compute_dtype="float32", warmup_steps=1)
    mesh = make_host_mesh(D, M)
    shp = ShapeConfig("t", S, B, "train")
    rules_d = make_rules(model.cfg, shp, model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    state = init_train_state(model, tc, 0)
    ps = param_specs(state["params"], model.cfg, rules, M)
    os_ = opt_specs(state["opt"], ps, model.cfg, rules, mesh_shape_dict(mesh), tc.zero1)
    step = make_placed_train_step(model, tc, mesh, {"params": ps, "opt": os_, "step": P()},
                                  batch_specs(model.cfg, shp, rules))
    return model, tc, step, state, rules_d


# ---------------------------------------------------------------------------
# the reduce as it stood: every owner takes every part that covers its block
# ---------------------------------------------------------------------------
def _meet(a, b):
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop)) for x, y in zip(a, b))
    return None if any(s.start >= s.stop for s in out) else out


def _rel(inner, outer):
    return tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(inner, outer))


def _owner_loop(params, sources, grads, owners, acc, mb):
    """One replica's gradients reduced the way the placed step reduced them
    before the chunks: each owner adds, in the order of ``grads``, the part
    of every gradient that covers its block to its whole-block float32
    accumulator (``acc``, a list a leaf of each place's block: the
    microbatch loop's ``acc += g.float() / mb``), or, with ``acc`` None,
    sums the parts (one replica, one microbatch): each place's block."""
    out, at = [], 0
    for n, (pp, srcs, sh) in enumerate(zip(tree.leaves(params), sources, owners)):
        gs, at = grads[at:at + len(srcs)], at + len(srcs)
        blocks = []
        for i in range(sh.mesh.size):
            region = block_slices(sh, pp.shape, i)
            total = None
            for (_, reg), g in zip(srcs, gs):
                inter = _meet(region, reg)
                if inter is None:
                    continue
                part, dst = g[_rel(inter, reg)], _rel(inter, region)
                if acc is not None:
                    acc[n][i][dst].add_(part.float() / mb)
                    continue
                if total is None:
                    total = torch.zeros([s.stop - s.start for s in region], dtype=part.dtype)
                    total[dst] = part
                else:
                    total[dst] = total[dst] + part
            blocks.append(total)
        out.append(blocks)
    return out


class _Spy:
    """``tensor_parallel.reduce_grads`` and ``owner_chunks`` watched: each
    reduce's inputs (its gradients copied before they are consumed) and
    each chunk the accumulators hold."""

    def __init__(self, monkeypatch):
        self.calls, self.sizes = [], None
        real_reduce, real_chunks = tp.reduce_grads, tp.owner_chunks

        def reduce(params, sources, grads, owners, acc=None, mb=1):
            self.calls.append((sources, [g.detach().clone() for g in grads], acc is None, mb))
            return real_reduce(params, sources, grads, owners, acc, mb)

        def chunks(params, owners):
            out = real_chunks(params, owners)
            self.sizes = [[0 if t is None else t.numel() for t in ch] for ch in out]
            return out

        monkeypatch.setattr(tp, "reduce_grads", reduce)
        monkeypatch.setattr(tp, "owner_chunks", chunks)

    def owner_loop(self, params, owners):
        """Every reduce again through ``_owner_loop``: each place's block."""
        whole = all(plain for _, _, plain, _ in self.calls)
        acc = None if whole else [
            [torch.zeros([s.stop - s.start for s in block_slices(sh, pp.shape, i)])
             for i in range(sh.mesh.size)] for pp, sh in zip(tree.leaves(params), owners)]
        out = None
        for sources, grads, _, mb in self.calls:
            out = _owner_loop(params, sources, grads, owners, acc, mb)
        return out if whole else acc


@pytest.mark.parametrize("zero1", [False, True], ids=["adamw", "zero1"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_equal_the_owner_loop_and_the_one_device_step(monkeypatch, arch, mesh, zero1):
    D, M = mesh
    model, tc, step, state, rules_d = _step(arch, D, M, zero1)
    spy = _Spy(monkeypatch)
    b = _batch(model.cfg.vocab)
    with use_rules(rules_d):
        placed = step.place_state(state)
        loss, _, grads = step.compute_grads(placed["params"], b)
    owners = [g.sharding for g in grads]
    want = spy.owner_loop(placed["params"], owners)
    for n, (g, w) in enumerate(zip(grads, want)):
        for i, blk in enumerate(g.blocks):
            assert blk.dtype == w[i].dtype and torch.equal(blk, w[i]), (arch, n, i)
    if spy.sizes is not None:                   # the accumulators: a chunk a place
        for pp, sizes, sh in zip(tree.leaves(placed["params"]), spy.sizes, owners):
            regions = [block_slices(sh, pp.shape, i) for i in range(sh.mesh.size)]
            for i, region in enumerate(regions):
                group = [j for j, r in enumerate(regions) if r == region]
                n = math.prod(s.stop - s.start for s in region)
                assert sizes[i] <= -(-n // len(group))
                assert sum(sizes[j] for j in group) == n
    ref = make_train_step(model, dataclasses.replace(tc, microbatches=D))
    wloss, _, wgrads = ref.compute_grads(state["params"], b)
    wgrads = tree.leaves(wgrads)
    if M == 1:
        assert torch.equal(loss, wloss)
        for g, w in zip(grads, wgrads):
            for i, blk in enumerate(g.blocks):
                assert torch.equal(blk, w[g.slices(i)]), (g, i)
    else:
        torch.testing.assert_close(loss, wloss, **SPLIT_TOL)
        scale = min(1.0, tc.grad_clip / float(global_norm(wgrads)))   # the clip's
        for n, (g, w) in enumerate(zip(grads, wgrads)):
            torch.testing.assert_close(gather(g, "cpu") * scale, w * scale, **SPLIT_TOL,
                                       msg=f"leaf {n}")


# ---------------------------------------------------------------------------
# one replicated leaf: the bytes in closed form
# ---------------------------------------------------------------------------
def _received(monkeypatch):
    """The bytes each place receives by kind, from ``tensor_parallel``'s
    counts."""
    got = {}
    real = tp.count_transfer

    def counted(t, src, dst, kind="other"):
        if src is not None and src != dst:
            n = t if isinstance(t, int) else t.numel() * t.element_size()
            got.setdefault(kind, {}).setdefault(dst, 0)
            got[kind][dst] += n
        return real(t, src, dst, kind)

    monkeypatch.setattr(tp, "count_transfer", counted)
    return got


@pytest.mark.parametrize("acc", [False, True], ids=["one_microbatch", "accumulated"])
@pytest.mark.parametrize("shape,sources,n_places", [((8, 6), (0,), 4), ((5, 7), (0, 2, 3), 4),
                                                    ((5, 7), (1, 4), 6), ((3,), (0, 1), 4),
                                                    ((64,), (2,), 4)],
                         ids=["even", "ragged", "ragged6", "fewer_elements", "one_source"])
def test_replicated_leaf_moves_the_closed_form(monkeypatch, shape, sources, n_places, acc):
    """A leaf every place owns whole (O = ``n_places``; chunks of ceil(n/O),
    the last ragged, some empty where n < O), its gradient at each place of
    ``sources``: ``grad_reduce`` is each gradient's parts off its own
    place's chunk, ``grad_gather`` each owner's block less its own chunk,
    (O - 1) L in all; each owner's block the gradients' sum in their
    order."""
    O = n_places
    mesh = Mesh(["cpu"] * O, ("data",))
    sh = NamedSharding(mesh, P())
    leaf = place(torch.zeros(shape), sh)
    n = math.prod(shape)
    L, c = 4 * n, -(-n // O)
    chunk = [max(0, min((k + 1) * c, n) - min(k * c, n)) * 4 for k in range(O)]
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(shape, generator=gen) for _ in sources]
    srcs = [[(i, tuple(slice(0, s) for s in shape)) for i in sources]]
    got = _received(monkeypatch)
    reset_transfer_counts()
    mb = 3 if acc else 1
    if acc:
        chunks = tp.owner_chunks([leaf], [sh])
        assert [0 if t is None else t.numel() * 4 for t in chunks[0]] == chunk
        tp.reduce_grads([leaf], srcs, list(grads), [sh], chunks, mb)
        out = tp.gather_chunks([leaf], chunks, [sh])
    else:
        out = tp.reduce_grads([leaf], srcs, list(grads), [sh])
    moved = transfer_counts()["bytes"]
    assert moved.get("grad_reduce", 0) == sum(L - chunk[i] for i in sources)
    assert moved["grad_gather"] == sum(L - chunk[j] for j in range(O)) == (O - 1) * L
    for j in range(O):
        into = got.get("grad_reduce", {}).get(j, 0) + got["grad_gather"].get(j, 0)
        assert into == len([i for i in sources if i != j]) * chunk[j] + L - chunk[j] <= 2 * L
    want = None
    for g in grads:
        part = g.float() / mb if acc else g
        want = part if want is None else want + part
    for j in range(O):
        assert torch.equal(out[0].blocks[j], want), j


# ---------------------------------------------------------------------------
# the count a place, whichever thread runs the backward
# ---------------------------------------------------------------------------
def _on_thread(count: PlaceCount, fn):
    """``fn()`` on a new thread as the card's autograd runs a backward: the
    count's dispatch mode carried over, nothing of the caller's
    thread-local place, scope or mirror."""
    out = {}

    def run():
        with count:
            out["r"] = fn()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    return out["r"]


def _step_count(monkeypatch, arch: str, thread: bool) -> PlaceCount:
    """The count of reduced ``arch``'s placed step on (2, 2), AdamW with
    ZeRO-1 in float32, the places apart on the CPU, the state placed
    before the count; its backward on another thread if ``thread``."""
    _, _, step, state, rules_d = _step(arch, 2, 2, True)
    b = _batch(_model(arch).cfg.vocab)
    count = None
    if thread:
        real = torch.autograd.grad
        monkeypatch.setattr(torch.autograd, "grad",
                            lambda *a, **kw: _on_thread(count, lambda: real(*a, **kw)))
    with use_rules(rules_d):
        placed = step.place_state(state)
        count = PlaceCount(4, held=placed)
        with count, places_apart():
            step(placed, b)
    monkeypatch.undo()
    return count


@pytest.mark.parametrize("arch", ARCHS)
def test_count_a_place_is_the_same_on_any_thread(monkeypatch, arch):
    here, there = _step_count(monkeypatch, arch, False), _step_count(monkeypatch, arch, True)
    assert min(here.flops) > 0
    assert there.flops == here.flops
    assert there.flops_by == here.flops_by
    assert there.peak == here.peak


@pytest.mark.parametrize("thread", [False, True], ids=["caller", "other_thread"])
def test_column_parallel_product_splits_its_flops(thread):
    """x (m, k) at home times w (k, n) cut by columns over M places: the
    forward, and the backward's two products (dx's partials, dw's
    blocks), each 2 m k n / M a place."""
    m, k, n, M = 6, 8, 12, 3
    mesh = Mesh(["cpu"] * M, ("model",))
    gen = torch.Generator().manual_seed(1)
    w = place(torch.randn(k, n, generator=gen), NamedSharding(mesh, P(None, "model")))
    x = torch.randn(m, k, generator=gen).requires_grad_(True)
    count = PlaceCount(M, held=[w])
    with count, places_apart():
        ws = [t.detach().requires_grad_(True) for t in w.blocks]
        out = tp.column_parallel(lambda a, b: b @ a, tp.Blocks(ws, range(M), mesh.devices, 1), x)
        loss = out.whole().sum()
        grads = (_on_thread(count, lambda: torch.autograd.grad(loss, [x, *ws])) if thread
                 else torch.autograd.grad(loss, [x, *ws]))
    assert count.flops == [3 * 2 * m * k * n // M] * M
    torch.testing.assert_close(grads[0], torch.ones(m, n) @ torch.cat(w.blocks, 1).T)
