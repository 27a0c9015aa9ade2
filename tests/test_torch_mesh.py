"""PyTorch port, the Peregrine path placed over a device mesh: the batteries
of ``tests/mesh_check.py`` by name (``ambient``, ``parity``, ``fused``,
``sketch``, ``engine``), each at D = 1, 2 and 4 places in one process with
``flow_mesh(devices=["cpu"] * D)``, the port's stand-in for the JAX
package's forced host devices.

The JAX package's placed runs fail (``tests/test_mesh.py``, ROADMAP queue
3), so the port's placed runs are held to its own unplaced runs bit for
bit: ``bucketed`` at 8 and 16 buckets over every attack (features and
state), ``sharded`` at 4 shards in exact and switch mode, the sketch state,
``process_stream`` on ``bucketed`` one shot and chunked, and engines of 2, 3
and 4 tenants.  On two attacks the placed runs are also held against the
JAX package's unplaced ``process_bucketed`` and ``process_sharded`` (the
envelopes of ``tests/test_torch_partition.py``), its ``process_stream``
and its one-tenant engine on the serial backend with a carried net (the
envelope of ``tests/test_torch_engine.py``).  Beside the results, the tests
check where the work went: which place each bucket cut, shard table and
tenant's pool tables lies on (the place's index: every place is the CPU),
that the engine's state stays put, and which bytes cross between places.
Print the readings with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mesh.py
"""
import ast
import contextlib
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core.bucketed import process_bucketed as jax_process_bucketed
from repro.core.sharded import process_sharded as jax_process_sharded
from repro.serving import DetectionEngine as JaxEngine
from repro.serving import DetectionService as JaxService
from repro.traffic.generator import ATTACKS
from test_torch_engine import _assert_within_jax_envelope, _net_arrays
from test_torch_fc import _assert_feats, _assert_state, _readings
from test_torch_partition import _state_close
from test_torch_scan import JAX_STATE_TOL, _trace
from test_torch_switch import MAX_FEATURE_DIFFS, SR_TOL

from repro_torch.core import clone_state, compute_features, init_state
from repro_torch.core.bucketed import _resolve_placement, _shard_ctx
from repro_torch.core.sharded import place_shards, shard_tables
from repro_torch.core.state import (PlacedPool, StatePool, init_state_stacked,
                                    tenant_view)
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (ShardContext, ambient_mesh,
                                              flow_mesh, flow_shards_binding,
                                              reset_transfer_counts,
                                              tenant_binding, tenant_placement,
                                              transfer_counts, use_rules)
from repro_torch.interop import kitnet_from_arrays, state_from_arrays
from repro_torch.kernels.feature_update import (feature_update_full_tenants,
                                                feature_update_full_tenants_ref)
from repro_torch.serving import DetectionEngine, DetectionService
from repro_torch.traffic import synth_trace, to_torch

torch.set_num_threads(1)

PLACES = (1, 2, 4)
N_SLOTS = 512
BUCKETS = 8
EPOCH = 64
CHUNK = 128
TWO_ATTACKS = ("mirai", "ssh_bruteforce")


def _mesh(D: int):
    return flow_mesh(devices=["cpu"] * D)


def _bitwise(st_a, f_a, st_b, f_b, msg=""):
    assert torch.equal(f_a, f_b), (msg, float((f_a - f_b).abs().max()))
    for g in st_b:
        if isinstance(st_b[g], dict):
            for k in st_b[g]:
                assert torch.equal(st_a[g][k], st_b[g][k]), (msg, g, k)
        else:
            assert torch.equal(st_a[g], st_b[g]), (msg, g)


def _same_results(a, b, msg=""):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _unplaced(attack: str, backend: str, mode: str = "exact", **kw):
    """An attack's trace through ``backend`` unplaced, from fresh tables
    (shared by the tests, which never write to it)."""
    return compute_features(init_state(N_SLOTS, device="cpu"),
                            to_torch(_trace(attack), "cpu"), backend=backend,
                            mode=mode, **kw)


def _placed(D: int, attack: str, backend: str, mode: str = "exact", **kw):
    with _mesh(D):
        return compute_features(init_state(N_SLOTS, device="cpu"),
                                to_torch(_trace(attack), "cpu"),
                                backend=backend, mode=mode, **kw)


# ---------------------------------------------------------------------------
# ambient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", PLACES)
def test_ambient(D):
    """``flow_mesh`` binds a D-place mesh and both rules; the bucketed
    resolver accepts it and falls back (JAX's rules) where the buckets do
    not divide over the places or the rule names an axis the mesh lacks;
    one cached context per (mesh, binding); all of it unbound afterwards."""
    assert ambient_mesh() is None and _resolve_placement(BUCKETS) == (None, None)
    assert tenant_placement() is None
    with _mesh(D) as mesh:
        assert ambient_mesh() is mesh and mesh.size == D
        assert mesh.shape == {"data": D}
        assert flow_shards_binding() == "data" and tenant_binding() == "data"
        rm, rb = _resolve_placement(BUCKETS)
        assert rm is mesh and rb == "data"
        if D > 1:
            assert _resolve_placement(D + 1) == (None, None)
        ctx = _shard_ctx(rm, rb)
        assert isinstance(ctx, ShardContext) and ctx.size == D
        assert ctx.devices == (torch.device("cpu"),) * D
        assert _shard_ctx(rm, rb) is ctx
        assert tenant_placement() is ctx
        with use_rules({"flow_shards": "model", "tenants": "data"}):
            assert _resolve_placement(BUCKETS) == (None, None)
            assert tenant_placement() is ctx
        with use_rules(None):
            assert tenant_placement() is None
    assert ambient_mesh() is None and flow_shards_binding() is None
    assert sharding.PRODUCTION_RULES["flow_shards"] == ("pod", "data")


def test_flow_mesh_defaults_to_the_cards(monkeypatch):
    """Without ``devices``, ``flow_mesh`` binds cards and raises when it
    cannot: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with flow_mesh():
            pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with flow_mesh() as mesh:
        assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError):
        with flow_mesh(3):
            pass
    with pytest.raises(ValueError):
        with flow_mesh(2, devices=["cpu"] * 3):
            pass


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", PLACES)
def test_parity(D):
    """``bucketed`` at 8 and 16 buckets under the mesh: the unplaced run's
    features and every table bit for bit, over every attack generator."""
    for attack in sorted(ATTACKS):
        for S in (BUCKETS, 16):
            st_p, f_p = _placed(D, attack, "bucketed", buckets=S)
            st_u, f_u = _unplaced(attack, "bucketed", buckets=S)
            _bitwise(st_p, f_p, st_u, f_u, f"{attack} S={S} D={D}")


@pytest.mark.parametrize("n,S,D", [(256, 8, 4), (250, 16, 4), (97, 4, 2),
                                   (250, 6, 4)])
def test_bucket_cuts_by_place(monkeypatch, n, S, D):
    """Which place holds each cut: place i scans cuts [i*2S/D, (i+1)*2S/D)
    of every scan's sorted array (both key types of a group end to end, so
    2S cuts), on its device; a ragged batch's padding lies only at the
    last place's tail; results bit for bit with the unplaced run.  Where S
    does not divide over the places the run is unplaced (no scatter)."""
    seen = []
    scatter = ShardContext.scatter

    def spy(self, t):
        parts = scatter(self, t)
        seen.append((t, parts, self))
        return parts

    monkeypatch.setattr(ShardContext, "scatter", spy)
    pk = {k: v[:n] for k, v in to_torch(_trace("mirai"), "cpu").items()}
    st_u, f_u = compute_features(init_state(N_SLOTS, device="cpu"), pk,
                                 backend="bucketed", buckets=S)
    assert not seen
    with _mesh(D):
        st_p, f_p = compute_features(init_state(N_SLOTS, device="cpu"), pk,
                                     backend="bucketed", buckets=S)
    _bitwise(st_p, f_p, st_u, f_u, f"n={n} S={S} D={D}")
    if S % D:
        assert not seen
        return
    # three linear scans (uni, bi directions, SR) of two arrays each, and
    # the channel pass's index cummax
    assert len(seen) == 7
    cut_len = -(-2 * n // (2 * S))
    pad = 2 * S * cut_len - 2 * n
    assert pad <= cut_len * 2 * S // D      # the padding: the last place's only
    for t, parts, ctx in seen:
        assert t.shape[:2] == (2 * S, cut_len) and len(parts) == D
        for i, part in enumerate(parts):
            assert part.device == ctx.devices[i]
            assert torch.equal(part, t[i * 2 * S // D:(i + 1) * 2 * S // D])
        if pad:
            tail = parts[-1].reshape(-1, *t.shape[2:])[-pad:]
            assert (tail == (-1 if t.dtype == torch.int64 else 0)).all()


@pytest.mark.parametrize("D", PLACES)
def test_sharded_parity(D):
    """``sharded`` at 4 shards over D places: the unplaced run (the port's
    serial oracle bit for bit), features and every table, in exact mode on
    two attacks and in switch mode on one."""
    for attack, mode in (("mirai", "exact"), ("ssh_bruteforce", "exact"),
                         ("mirai", "switch")):
        st_p, f_p = _placed(D, attack, "sharded", mode, shards=4)
        st_u, f_u = _unplaced(attack, "serial", mode)
        _bitwise(st_p, f_p, st_u, f_u, f"{attack} {mode} D={D}")


@pytest.mark.parametrize("D", (2, 4))
def test_shard_tables_by_place(D):
    """Place i holds shards [i*S/D, (i+1)*S/D) of every table (slot g in
    shard g % S), on its device; a shard count the places do not divide
    runs unplaced and still equals serial."""
    st, _ = _unplaced("mirai", "serial")
    sh = shard_tables(st, 8)
    with _mesh(D):
        ctx = _shard_ctx(*_resolve_placement(8))
        parts = place_shards(sh, ctx)
    assert len(parts) == D
    for p, part in enumerate(parts):
        for g in sh:
            for k, v in sh[g].items():
                assert part[g][k].device == ctx.devices[p]
                assert torch.equal(part[g][k], v[p * 8 // D:(p + 1) * 8 // D])
    assert place_shards(sh, None) == [sh]
    if D == 4:
        with _mesh(3):
            st_3, f_3 = compute_features(
                init_state(N_SLOTS, device="cpu"), to_torch(_trace("mirai"), "cpu"),
                backend="sharded", shards=4)
        _bitwise(st_3, f_3, *_unplaced("mirai", "serial"))


def test_placed_runs_move_only_tails_and_results():
    """Bytes handed between places: the bucketed scans move each place's
    cuts out and back plus the O(S) tails, and nothing at one place."""
    pk = to_torch(_trace("mirai"), "cpu")
    for D in PLACES:
        reset_transfer_counts()
        with _mesh(D):
            compute_features(init_state(N_SLOTS, device="cpu"), pk,
                             backend="bucketed", buckets=16)
        moved = transfer_counts()
        assert moved["host_to_place"] == 0
        assert (moved["between_places"] == 0) == (D == 1), (D, moved)


# ---------------------------------------------------------------------------
# fused
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _fitted_bucketed_service():
    """A service on ``bucketed`` fitted unplaced on a mirai trace: its
    post-fit state, stream position, net and threshold."""
    data = synth_trace("mirai", n_train=1024, n_benign_eval=256, n_attack=256,
                       seed=0)
    svc = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, backend="bucketed",
                           buckets=BUCKETS, device="cpu")
    svc.observe_stream(data["train"], chunk=512)
    svc.fit(fpr=0.05)
    ev = {k: v for k, v in data["eval"].items() if k != "label"}
    return svc, clone_state(svc.state), svc.pkt_count, ev


def _restart(svc, snap, count):
    svc.state, svc.pkt_count = clone_state(snap), count
    return svc


@pytest.mark.parametrize("D", PLACES)
def test_fused(D):
    """The fused service step under the mesh, one shot and chunked (chunks
    straddling epochs, the state carried), equals the unplaced run driven
    alike: the same record indices and the same score bits, the same
    tables.  (Chunking cuts the buckets elsewhere, so chunked and one shot
    agree only to the scan envelope, placed or not.)"""
    svc, snap, c0, ev = _fitted_bucketed_service()
    runs = []
    for placed in (False, True):
        for chunk in (None, 192):
            _restart(svc, snap, c0)
            with _mesh(D) if placed else contextlib.nullcontext():
                runs.append(svc.process(ev, fused=True) if chunk is None else
                            svc.process_stream(ev, chunk=chunk, fused=True))
            runs.append(clone_state(svc.state))
    one_u, st1_u, ch_u, st2_u, one_p, st1_p, ch_p, st2_p = runs
    assert len(one_u[0]) > 0
    _same_results(one_p, one_u, f"one shot D={D}")
    _same_results(ch_p, ch_u, f"chunked D={D}")
    _bitwise(st1_p, torch.zeros(0), st1_u, torch.zeros(0), "one shot state")
    _bitwise(st2_p, torch.zeros(0), st2_u, torch.zeros(0), "chunked state")


# ---------------------------------------------------------------------------
# sketch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", PLACES)
def test_sketch(D):
    """The Count-Min state under a bound mesh: features and state bit for
    bit with the unplaced run (its update takes and ignores the partition
    options), and a 2-tenant sketch pool placed, lane by lane, equal to the
    unplaced engine."""
    pk = to_torch(_trace("mirai"), "cpu")
    st0 = init_state(N_SLOTS, state_backend="sketch", rows=2, device="cpu")
    st_u, f_u = compute_features(clone_state(st0), pk, backend="serial")
    with _mesh(D):
        st_p, f_p = compute_features(clone_state(st0), pk, backend="bucketed",
                                     buckets=BUCKETS)
    _bitwise(st_p, f_p, st_u, f_u, f"sketch D={D}")

    svc, _, _, ev = _fitted_bucketed_service()
    sk = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, state_backend="sketch",
                          state_kw={"rows": 2}, backend="serial",
                          threshold=svc.threshold, device="cpu")
    sk.net = svc.net
    short = {k: v[:256] for k, v in ev.items()}

    def run():
        eng = DetectionEngine.from_service(sk, n_tenants=2, chunk=CHUNK)
        tids = [eng.add_tenant() for _ in range(2)]
        return eng, eng.run({tids[0]: short, tids[1]: ev})

    _, ref = run()
    with _mesh(D):
        eng, got = run()
    assert eng.pool.placed
    for t in ref:
        _same_results(got[t], ref[t], f"sketch tenant {t} D={D}")


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _engine_run(svc, T: int, traces=None, **kw):
    eng = DetectionEngine.from_service(svc, n_tenants=T, chunk=CHUNK,
                                       queue_depth=4, **kw)
    tids = [eng.add_tenant() for _ in range(T)]
    _, _, _, ev = _fitted_bucketed_service()
    traces = traces or {t: {k: v[:(t + 2) * CHUNK + 17 * t] for k, v in ev.items()}
                        for t in tids}
    return eng, eng.run(traces), traces


@pytest.mark.parametrize("D", PLACES)
@pytest.mark.parametrize("T,backend", [(2, "cuda"), (4, "cuda"), (3, "cuda"),
                                       (2, "bucketed")])
def test_engine(D, T, backend):
    """Engines of 2, 3 and 4 tenants (3 divides no place count past one)
    under the mesh: each tenant's results, end state and slot collisions
    equal the unplaced engine's; tenant t's tables lie on place t % D for
    the pool's life, a view of that place's stacked dict; they do not move
    during ``run``, and only packets (from the host) and results (to place
    0) cross."""
    svc, snap, c0, _ = _fitted_bucketed_service()
    kw = {} if backend == "bucketed" else {"backend": backend, "backend_kw": {}}
    ref_eng, ref, traces = _engine_run(svc, T, **kw)
    with _mesh(D):
        eng = DetectionEngine.from_service(svc, n_tenants=T, chunk=CHUNK,
                                           queue_depth=4, **kw)
    pool = eng.pool.stacked
    assert isinstance(pool, PlacedPool) and pool.size == D
    assert [len(next(iter(part["uni"].values()))) for part in pool.parts] == [
        len(range(p, T, D)) for p in range(D)]
    tids = [eng.add_tenant() for _ in range(T)]
    ptrs = {}
    for t in tids:
        p, local = pool.home(t)
        assert (p, local) == (t % D, t // D)
        view = tenant_view(pool, t)
        for g in ("uni", "bi"):
            for k, v in view[g].items():
                part = pool.parts[p][g][k]
                assert v.device == pool.ctx.devices[p]
                assert v.data_ptr() == part[local].data_ptr()
                ptrs[(t, g, k)] = v.data_ptr()
    reset_transfer_counts()
    got = eng.run(traces)        # outside the mesh: the pool keeps its places
    moved = transfer_counts()
    one = to_torch({k: v[:1] for k, v in traces[0].items()}, "cpu")
    per_packet = sum(v.element_size() for v in one.values())
    assert moved["host_to_place"] == per_packet * sum(
        len(tr["ts"]) for tr in traces.values()), moved
    # a lane's chunk sends back its records' positions (int64), scores
    # (float32), alarms (bool) and its collision count (int64)
    lane_chunks = sum(-(-len(traces[t]["ts"]) // CHUNK) for t in tids if t % D)
    assert moved["between_places"] <= lane_chunks * (
        -(-CHUNK // EPOCH) * (8 + 4 + 1) + 8), moved
    assert (moved["between_places"] > 0) == (D > 1)
    for t in tids:
        _same_results(got[t], ref[t], f"tenant {t} D={D} T={T}")
        view = tenant_view(pool, t)
        for g in ("uni", "bi"):
            for k, v in view[g].items():
                assert v.data_ptr() == ptrs[(t, g, k)]
                assert torch.equal(v, ref_eng.pool.read(t)[g][k]), (t, g, k)
        assert (eng.stats()["tenants"][t]["slot_collisions"]
                == ref_eng.stats()["tenants"][t]["slot_collisions"])
        assert eng.pool.read(t)["uni"]["w"].device == pool.ctx.devices[t % D]


@pytest.mark.parametrize("D", (2, 4))
def test_engine_tenants_removed_and_readded(D):
    """Under the mesh: a tenant removed and another added takes the freed
    slot (its home place) with fresh tables; reset, seed and read act on
    the home place; the results equal an unplaced engine driven alike."""
    svc, snap, c0, ev = _fitted_bucketed_service()
    part = {k: v[:2 * CHUNK] for k, v in ev.items()}

    def drive():
        eng = DetectionEngine.from_service(svc, n_tenants=3, chunk=CHUNK,
                                           backend="cuda", backend_kw={})
        a, b, c = (eng.add_tenant() for _ in range(3))
        first = eng.run({a: part, b: part, c: part})
        eng.remove_tenant(b)
        d = eng.add_tenant()
        assert d == b
        assert torch.equal(eng.pool.read(d)["uni"]["w"],
                           torch.zeros_like(eng.pool.read(d)["uni"]["w"]))
        eng.seed_tenant(c, snap, c0)
        eng.reset_tenant(a)
        second = eng.run({a: part, d: ev, c: part})
        return eng, first, second

    _, f_ref, s_ref = drive()
    with _mesh(D):
        eng, f_got, s_got = drive()
    assert eng.pool.placed
    for t in f_ref:
        _same_results(f_got[t], f_ref[t], f"first {t}")
    for t in s_ref:
        _same_results(s_got[t], s_ref[t], f"second {t}")
    assert eng.pool.read(2)["uni"]["w"].device == eng.pool.stacked.ctx.devices[2 % D]


def test_tenant_fc_by_place_equals_its_plain_version():
    """The tenant-batched FC on a placed pool (one launch a place, plain on
    the CPU) against its plain twin lane by lane, bit for bit, for a
    tenant subset spread over 4 places; the pool's tables equal."""
    tr = _trace("mirai")
    pk = to_torch({k: np.stack([v[:128], v[64:192], v[128:256]]) for k, v in tr.items()},
                  "cpu")
    with _mesh(4):
        pool_a = init_state_stacked(6, 128, device="cpu")
        pool_b = init_state_stacked(6, 128, device="cpu")
    assert isinstance(pool_a, PlacedPool)
    tids = [5, 0, 2]
    _, f_a = feature_update_full_tenants(pool_a, tids, pk)
    _, f_b = feature_update_full_tenants_ref(pool_b, tids, pk)
    assert torch.equal(f_a, f_b)
    for p in range(4):
        for g in ("uni", "bi"):
            for k in pool_a.parts[p][g]:
                assert torch.equal(pool_a.parts[p][g][k], pool_b.parts[p][g][k])
    assert pool_a.groups(tids) == [(0, [1], [0]), (1, [0], [1]), (2, [2], [0])]


# ---------------------------------------------------------------------------
# against the JAX package's unplaced runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", TWO_ATTACKS)
def test_placed_partitions_match_jax(attack):
    """At 4 places: ``bucketed`` against JAX's ``process_bucketed`` (the
    per-kind limits, the state to JAX's scan tolerance) and ``sharded``
    against JAX's ``process_sharded`` in exact and switch mode (the serial
    envelopes), as ``tests/test_torch_partition.py`` holds the unplaced
    runs."""
    jx = {k: jnp.asarray(v) for k, v in _trace(attack).items()}
    st_j, f_j = jax_process_bucketed(jax_init_state(N_SLOTS), jx, buckets=BUCKETS)
    st_t, f_t = _placed(4, attack, "bucketed", buckets=BUCKETS)
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _state_close(st_t, st_j, attack, **JAX_STATE_TOL)

    st_j, f_j = jax_process_sharded(jax_init_state(N_SLOTS), jx, shards=4)
    st_t, f_t = _placed(4, attack, "sharded", shards=4)
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _assert_state(st_t, st_j, attack)

    st_j, f_j = jax_process_sharded(jax_init_state(N_SLOTS), jx, shards=4,
                                    mode="switch")
    st_t, f_t = _placed(4, attack, "sharded", "switch", shards=4)
    f_j, f_t = np.asarray(f_j), f_t.numpy()
    assert (f_j != f_t).sum() <= MAX_FEATURE_DIFFS
    assert np.abs(f_j - f_t).max() <= 1.0
    for g in ("uni", "bi"):
        for k in st_t[g]:
            want, got = np.asarray(st_j[g][k]), st_t[g][k].numpy()
            if (g, k) == ("bi", "sr"):
                np.testing.assert_allclose(got, want, err_msg=attack, **SR_TOL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{attack} {g}/{k}")


@functools.lru_cache(maxsize=None)
def _jax_fitted(attack: str):
    """A JAX service (serial FC) fitted on ``attack``'s trace, the eval
    stream, and its net, threshold, state and position carried across."""
    data = synth_trace(attack, n_train=1024, n_benign_eval=192, n_attack=192,
                       seed=4)
    js = JaxService(epoch=EPOCH, n_slots=N_SLOTS, backend="scan")
    js.observe_stream(data["train"], chunk=512)
    js.fit(fpr=0.05)
    ev = {k: v for k, v in data["eval"].items() if k != "label"}
    state = jax.tree_util.tree_map(np.array, js.state)
    return js, ev, kitnet_from_arrays(_net_arrays(js.net), device="cpu"), state


@pytest.mark.parametrize("attack", TWO_ATTACKS)
def test_placed_stream_and_engine_match_jax(attack):
    """At 4 places, with a JAX-fitted net, threshold and tables carried
    across: the service's ``process_stream`` on ``sharded`` (serial
    semantics) against JAX's unplaced ``process_stream`` on ``serial``, and
    tenant 1 (place 1) of a 2-tenant engine against JAX's one-tenant engine
    on ``serial``: indices equal, scores within ``SCORE_TOL``, alarms equal
    off the threshold (``tests/test_torch_engine.py``)."""
    js, ev, net, state = _jax_fitted(attack)
    ev = {k: v[:256] for k, v in ev.items()}
    j_svc = JaxService(epoch=EPOCH, n_slots=N_SLOTS, backend="serial",
                       threshold=js.threshold)
    j_svc.net, j_svc.pkt_count = js.net, js.pkt_count
    j_svc.state = jax.tree_util.tree_map(jnp.asarray, state)
    want = j_svc.process_stream(ev, chunk=CHUNK)
    svc = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, backend="sharded",
                           shards=4, threshold=js.threshold, device="cpu")
    svc.net, svc.pkt_count = net, js.pkt_count
    svc.state = state_from_arrays(state, device="cpu")
    with _mesh(4):
        got = svc.process_stream(ev, chunk=CHUNK)
    _assert_within_jax_envelope(got, want, js.threshold)

    je = JaxEngine.from_service(js, backend="serial", n_tenants=1, chunk=CHUNK,
                                queue_depth=4)
    jt = je.add_tenant()
    je.seed_tenant(jt, jax.tree_util.tree_map(jnp.asarray, state), js.pkt_count)
    j_out = je.run({jt: ev})[jt]
    with _mesh(4):
        eng = DetectionEngine(net, js.threshold, epoch=EPOCH, n_slots=N_SLOTS,
                              n_tenants=2, chunk=CHUNK, queue_depth=4,
                              device="cpu")
    t0, t1 = eng.add_tenant(), eng.add_tenant()
    eng.seed_tenant(t1, state_from_arrays(state, device="cpu"), js.pkt_count)
    out = eng.run({t0: ev, t1: ev})
    assert eng.pool.stacked.home(t1)[0] == 1
    _assert_within_jax_envelope(out[t1], j_out, js.threshold)


# ---------------------------------------------------------------------------
# the import graph
# ---------------------------------------------------------------------------
def test_sharding_imports_neither_jax_nor_the_jax_package():
    path = Path(sharding.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names <= {"__future__", "contextlib", "functools", "threading",
                     "typing", "torch"}, names
    code = ("import sys; import repro_torch.distributed.sharding, "
            "repro_torch.serving, repro_torch.core; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=path.parents[3],
                   env={**os.environ, "PYTHONPATH": str(path.parents[2])})


def test_pool_of_a_mesh_without_the_tenant_rule_is_unplaced():
    with _mesh(4):
        with use_rules({"flow_shards": "data"}):
            pool = StatePool(3, 64, device="cpu")
    assert not pool.placed and pool.stacked["uni"]["w"].shape[0] == 3


if __name__ == "__main__":
    for attack in TWO_ATTACKS:
        jx = {k: jnp.asarray(v) for k, v in _trace(attack).items()}
        _, f_j = jax_process_bucketed(jax_init_state(N_SLOTS), jx, buckets=BUCKETS)
        _, f_t = _placed(4, attack, "bucketed", buckets=BUCKETS)
        print(f"{attack}: placed bucketed (4 places) against JAX's process_bucketed",
              {k: round(float(v), 6) for k, v in _readings(f_t.numpy(),
                                                          np.asarray(f_j)).items()})
    pk = to_torch(_trace("mirai"), "cpu")
    for D in PLACES:
        for backend, kw in (("bucketed", {"buckets": 16}), ("sharded", {"shards": 4})):
            reset_transfer_counts()
            with _mesh(D):
                compute_features(init_state(N_SLOTS, device="cpu"), pk,
                                 backend=backend, **kw)
            print(f"D={D} {backend} {kw}: bytes between places "
                  f"{transfer_counts()['between_places']} for 256 packets")
