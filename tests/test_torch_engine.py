"""PyTorch port, the multi-tenant engine: ``StatePool``, the tenant-batched
step and ``DetectionEngine`` on the CPU, where the ``cuda`` names run their
plain versions.

The tests of ``tests/test_engine.py`` carry over by name: one tenant through
the engine equals ``DetectionService.process_stream`` bit for bit (results
and end state), N tenants each equal their solo runs, epoch counters stay
per tenant, shedding and backpressure, the pool's lifecycle, slot reuse,
alarm logs and the import graph.  Added: the sketch pool (lane by lane), the
tenant-batched FC on a tenant subset (the kernel's phase twin with the
combined keys) against ``process_serial`` lane by lane bit for bit, the
host hash and collision counts against the JAX package's bit for bit and
the engine's device collision counter against them lane by lane, each of
4 co-tenants against the JAX package's single-stream ``process_stream``,
and a single-tenant engine with a JAX net carried across against JAX's own
engine on the serial backend (indices equal, scores within ``SCORE_TOL``,
the envelope of ``tests/test_torch_service.py``).
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.state import np_hash_fields as jax_np_hash_fields
from repro.core.state import slot_collisions as jax_slot_collisions
from repro.serving import DetectionEngine as JaxEngine
from repro.serving import DetectionService as JaxService

from repro_torch.core import clone_state, epoch_gather, init_state, process_serial
from repro_torch.core.records import epoch_gather_lanes, epoch_indices
from repro_torch.core.state import (KEY_SALTS, StatePool, _np_key_fields,
                                    hash_fields, init_state_stacked, key_fields,
                                    np_hash_fields, slot_collisions,
                                    slot_collisions_lanes, tenant_view)
from repro_torch.interop import kitnet_from_arrays, state_from_arrays
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.feature_update import (fc_phases_tenants_ref,
                                                feature_update_full_tenants)
from repro_torch.serving import DetectionEngine, DetectionService, make_tenant_step
from repro_torch.traffic import synth_trace, to_torch

torch.set_num_threads(1)

N_SLOTS = 512
EPOCH = 32
CHUNK = 96
SCORE_TOL = dict(rtol=1e-3, atol=1e-4)     # tests/test_torch_service.py


def _eval_trace(attack: str, seed: int, n: int = 256):
    d = synth_trace(attack, n_train=64, n_benign_eval=n, n_attack=n, seed=seed)
    return {k: v for k, v in d["eval"].items() if k != "label"}


def _states_equal(a, b) -> bool:
    return all(torch.equal(a[g][k], b[g][k]) for g in ("uni", "bi") for k in a[g])


@pytest.fixture(scope="module")
def svc():
    """One fitted service (the ``cuda`` backends, plain on the CPU) shared
    by the engine tests; they run copies of it (``_solo``), never it."""
    data = synth_trace("mirai", n_train=768, n_benign_eval=64, n_attack=64,
                       seed=0)
    s = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, device="cpu")
    s.observe_stream(data["train"], chunk=256)
    s.fit(fpr=0.05)
    return s


def _solo(svc, backend="cuda", state=None, pkt_count=0, **kw) -> DetectionService:
    """A service with ``svc``'s net and threshold from ``state`` (fresh
    tables if None) at stream position ``pkt_count``."""
    s = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, device="cpu",
                         backend=backend, threshold=svc.threshold, **kw)
    s.net = svc.net
    if state is not None:
        s.state = clone_state(state)
    s.pkt_count = pkt_count
    return s


# ---------------------------------------------------------------------------
# single-tenant bit-parity with process_stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cuda", "scan"])
@pytest.mark.parametrize("attack", ["mirai", "syn_dos", "os_scan", "slowloris"])
def test_single_tenant_engine_matches_process_stream(svc, attack, backend):
    """One tenant through the engine (tenant-batched step, chunk cutting,
    partial-tail flush) emits the single-stream service's (indices, scores,
    alarms) on the same trace bit for bit and leaves its flow tables."""
    ev = _eval_trace(attack, seed=11)
    solo = _solo(svc, backend, svc.state, svc.pkt_count)
    want = solo.process_stream(ev, chunk=CHUNK)
    eng = DetectionEngine.from_service(solo, n_tenants=2, chunk=CHUNK,
                                       queue_depth=4)
    assert eng.backend == backend and eng.device.type == "cpu"
    tid = eng.add_tenant()
    eng.seed_tenant(tid, svc.state, svc.pkt_count)
    got = eng.run({tid: ev})[tid]
    assert len(want[0]) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert _states_equal(solo.state, eng.pool.read(tid))


# ---------------------------------------------------------------------------
# N-tenant isolation
# ---------------------------------------------------------------------------
def test_tenant_isolation_results_and_states(jax_fitted):
    """Each tenant's engine output equals that tenant run ALONE through the
    port's service (fresh tables both times) bit for bit: co-tenancy in the
    batched step leaks no state, records or epoch accounting across lanes.
    With the JAX-fitted net carried across, each tenant also agrees with
    the JAX package's single-stream ``process_stream`` on its trace alone
    (serial FC; indices equal, scores within SCORE_TOL), and its slot
    collision count equals the host count of its chunks."""
    _, js, net = jax_fitted
    attacks = ["syn_dos", "ssdp_flood", "goldeneye", "fuzzing"]
    traces = {k: _eval_trace(a, seed=20 + k) for k, a in enumerate(attacks)}
    eng = DetectionEngine(net, js.threshold, epoch=EPOCH, n_slots=N_SLOTS,
                          n_tenants=4, chunk=CHUNK, queue_depth=4, device="cpu")
    tids = [eng.add_tenant() for _ in range(4)]
    together = eng.run({tid: traces[k] for k, tid in enumerate(tids)})
    for k, tid in enumerate(tids):
        solo = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, device="cpu",
                                threshold=js.threshold)
        solo.net = net
        alone = solo.process_stream(traces[k], chunk=CHUNK)
        for a, b in zip(together[tid], alone):
            np.testing.assert_array_equal(a, b)
        assert _states_equal(eng.pool.read(tid), solo.state)
        tr, n = traces[k], len(traces[k]["ts"])
        assert eng.stats()["tenants"][tid]["slot_collisions"] == sum(
            slot_collisions({f: v[i:i + CHUNK] for f, v in tr.items()},
                            N_SLOTS)["total"] for i in range(0, n, CHUNK))
        j_solo = JaxService(epoch=EPOCH, n_slots=N_SLOTS, backend="serial",
                            threshold=js.threshold)
        j_solo.net = js.net
        _assert_within_jax_envelope(together[tid],
                                    j_solo.process_stream(tr, chunk=CHUNK),
                                    js.threshold)


def test_tenant_epoch_counters_never_mix(svc):
    """Tenants at different stream positions sample records at their OWN
    epoch boundaries: global indices stay per-tenant-continuous even when
    every chunk rides a shared batched step."""
    ev = _eval_trace("mirai", seed=31, n=160)
    eng = DetectionEngine.from_service(svc, n_tenants=2, chunk=64,
                                       queue_depth=8)
    a, b = eng.add_tenant(), eng.add_tenant()
    # tenant b starts mid-epoch (offset 7): boundaries shift accordingly
    eng.seed_tenant(b, init_state(N_SLOTS, device="cpu"), pkt_count=7)
    out = eng.run({a: ev, b: ev})
    ia, ib = out[a][0], out[b][0]
    assert len(ia) and len(ib)
    assert all((i + 1) % EPOCH == 0 for i in ia)
    assert all((i + 1) % EPOCH == 0 for i in ib)
    # both streams hit the same ABSOLUTE boundaries, but tenant b's offset
    # means different packets feed each record: scores must diverge
    np.testing.assert_array_equal(ia, ib)
    assert not np.array_equal(out[a][1], out[b][1])


def test_epoch_gather_lanes_equals_epoch_gather_per_lane():
    """Each lane's positions are the host's ``epoch_indices`` at that lane's
    running count (zero-padded), and ``epoch_gather`` is lane 0."""
    mods = [0, 7, 31, 5, 24]
    idx, counts = epoch_gather_lanes(200, 32, mods)
    assert idx.shape == (len(mods), 7)
    for lane, m in enumerate(mods):
        want = epoch_indices(200, 32, m)
        assert counts[lane] == len(want)
        np.testing.assert_array_equal(idx[lane, :counts[lane]].numpy(), want)
        assert not idx[lane, counts[lane]:].any()
        one, c = epoch_gather(200, 32, m)
        assert torch.equal(idx[lane], one) and counts[lane] == c


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------
def test_bounded_queue_sheds_and_reports(svc):
    """A full ingress queue sheds (drop-tail) instead of blocking: the
    accepted prefix is processed normally, counters report the drops, and
    the engine drains without deadlock."""
    ev = _eval_trace("mirai", seed=41, n=150)
    n = len(ev["ts"])
    eng = DetectionEngine.from_service(svc, n_tenants=1, chunk=64,
                                       queue_depth=2)
    tid = eng.add_tenant()
    cap = 2 * 64
    accepted = eng.submit(tid, ev)          # one oversized burst, no ticks
    assert accepted == cap
    assert eng.room(tid) == 0
    assert eng.submit(tid, ev) == 0         # full: everything sheds
    eng.step()
    eng.flush()
    idx, scores, alarms = eng.results(tid)
    st = eng.stats()["tenants"][tid]
    assert st["pkts_dropped"] == (n - cap) + n
    assert st["pkts_processed"] == cap
    assert st["pkts_in"] == 2 * n
    # the accepted prefix is exactly the first `cap` packets of the trace
    want = _solo(svc).process_stream({k: v[:cap] for k, v in ev.items()},
                                     chunk=64)
    for w, g in zip(want, (idx, scores, alarms)):
        np.testing.assert_array_equal(w, g)


def test_run_driver_respects_backpressure_without_drops(svc):
    """The offline ``run`` loop pauses feeding instead of shedding, so a
    tiny queue still processes the whole trace."""
    ev = _eval_trace("syn_dos", seed=43, n=100)
    eng = DetectionEngine.from_service(svc, n_tenants=1, chunk=64,
                                       queue_depth=1)
    tid = eng.add_tenant()
    eng.run({tid: ev})
    st = eng.stats()
    assert st["tenants"][tid]["pkts_dropped"] == 0
    assert st["tenants"][tid]["pkts_processed"] == len(ev["ts"])
    assert st["aggregate"]["pkts_processed"] == len(ev["ts"])
    assert st["tenants"][tid]["p99_ms"] >= st["tenants"][tid]["p50_ms"] > 0


# ---------------------------------------------------------------------------
# state pool lifecycle
# ---------------------------------------------------------------------------
def _fill(pool, tid, value=1.0):
    for g in ("uni", "bi"):
        for t in pool.stacked[g].values():
            t[tid] = value


def test_state_pool_alloc_free_reset():
    pool = StatePool(3, 64, device="cpu")
    fresh = init_state(64, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1) and pool.live == (0, 1) and pool.free_slots == 1
    # slots are independent: dirty one, the other stays fresh
    _fill(pool, a)
    pool.mark_dirty([a])
    assert _states_equal(pool.read(b), fresh)
    assert not _states_equal(pool.read(a), fresh)
    pool.reset(a)
    assert _states_equal(pool.read(a), fresh)
    _fill(pool, a)
    pool.mark_dirty([a])
    pool.free(a)
    assert pool.live == (b,)
    with pytest.raises(KeyError):
        pool.read(a)
    assert pool.alloc() == a            # lowest free slot, freshly reset
    assert _states_equal(pool.read(a), fresh)
    c = pool.alloc()
    assert c == 2
    with pytest.raises(RuntimeError):
        pool.alloc()                    # exhausted: bounded pool rejects
    with pytest.raises(IndexError):
        pool.reset(99)
    with pytest.raises(ValueError, match="layout"):
        pool.write(a, init_state(32, device="cpu"))


def test_state_pool_read_is_a_copy():
    pool = StatePool(2, 32, device="cpu")
    t = pool.alloc()
    snap = pool.read(t)
    _fill(pool, t)
    assert _states_equal(snap, init_state(32, device="cpu"))
    # the pool is one allocation per table; a tenant is a view into it
    assert pool.stacked["uni"]["w"].shape == (2, 2, 32, 4)
    assert pool.stacked["bi"]["w"].shape == (2, 2, 32, 2, 4)
    view = tenant_view(pool.stacked, t)
    assert view["uni"]["w"].data_ptr() == pool.stacked["uni"]["w"][t].data_ptr()


def test_engine_add_remove_tenants_reuses_slots(svc):
    eng = DetectionEngine.from_service(svc, n_tenants=2, chunk=64,
                                       queue_depth=2)
    a = eng.add_tenant()
    b = eng.add_tenant()
    with pytest.raises(RuntimeError):
        eng.add_tenant()
    eng.run({a: _eval_trace("mirai", seed=51, n=50)})
    eng.remove_tenant(a)
    c = eng.add_tenant()                 # reuses the freed slot, fresh state
    assert c == a
    assert _states_equal(eng.pool.read(c), init_state(N_SLOTS, device="cpu"))
    assert eng.results(c)[0].shape == (0,)
    eng.remove_tenant(b)


def test_engine_defaults_and_unsupported_options(svc):
    """The port's defaults (FC ``cuda``, MD ``cuda``), the JAX package's
    refusal of switch mode, and a repeated tenant in one step."""
    eng = DetectionEngine(svc.net, svc.threshold, epoch=EPOCH, n_slots=N_SLOTS,
                          n_tenants=2, chunk=CHUNK, device="cpu")
    assert (eng.backend, eng.md_backend, eng.max_batch) == ("cuda", "cuda", 2)
    with pytest.raises(ValueError, match="switch"):
        DetectionEngine(svc.net, svc.threshold, mode="switch", device="cpu")
    switch = DetectionService(device="cpu", mode="switch", n_slots=64,
                              threshold=1.0)
    switch.net = svc.net
    with pytest.raises(ValueError, match="switch"):
        DetectionEngine.from_service(switch)
    with pytest.raises(RuntimeError, match="fit"):
        DetectionEngine.from_service(DetectionService(device="cpu", n_slots=64))
    pool = init_state_stacked(2, N_SLOTS, device="cpu")
    pk = to_torch({k: np.stack([v[:8], v[:8]])
                   for k, v in _eval_trace("mirai", 1, 8).items()}, "cpu")
    with pytest.raises(ValueError, match="repeat"):
        make_tenant_step(epoch=EPOCH)(pool, [1, 1], svc.net, svc.threshold,
                                      [0, 0], pk)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DetectionEngine(svc.net, svc.threshold)


# ---------------------------------------------------------------------------
# alarm delivery
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["csv", "jsonl"])
def test_alarm_log_written_per_tenant(svc, tmp_path, fmt):
    import json
    ev = _eval_trace("syn_dos", seed=61)
    with DetectionEngine.from_service(svc, n_tenants=1, chunk=CHUNK,
                                      queue_depth=4, alarm_dir=str(tmp_path),
                                      alarm_format=fmt) as eng:
        tid = eng.add_tenant()
        idx, scores, alarms = eng.run({tid: ev})[tid]
    n_alarms = int(np.asarray(alarms).sum())
    assert n_alarms > 0
    lines = (tmp_path / f"tenant{tid}.{fmt}").read_text().strip().splitlines()
    if fmt == "csv":
        assert lines[0] == "tenant,record_index,score"
        assert len(lines) == 1 + n_alarms
        got_idx = [int(line.split(",")[1]) for line in lines[1:]]
    else:
        recs = [json.loads(line) for line in lines]
        assert len(recs) == n_alarms and {r["tenant"] for r in recs} == {tid}
        got_idx = [r["record"] for r in recs]
        np.testing.assert_array_equal([r["score"] for r in recs],
                                      scores[alarms].astype(np.float64))
    np.testing.assert_array_equal(got_idx, idx[alarms])


# ---------------------------------------------------------------------------
# sketch pools and the tenant-batched FC
# ---------------------------------------------------------------------------
def test_sketch_pool_lane_by_lane(svc):
    """Two tenants on a sketch pool (the sketch step runs lane by lane) each
    equal their solo sketch service bit for bit, results and end state."""
    kw = dict(state_backend="sketch", state_kw={"rows": 2, "evict_age": 1.0})
    traces = {0: _eval_trace("syn_dos", seed=71, n=128),
              1: _eval_trace("mirai", seed=72, n=128)}
    eng = DetectionEngine.from_service(_solo(svc, **kw), n_tenants=2, chunk=CHUNK,
                                       queue_depth=4)
    assert eng.state_backend == "sketch"
    assert eng.state_kw == {"rows": 2, "evict_age": 1.0}
    tids = [eng.add_tenant() for _ in range(2)]
    together = eng.run({t: traces[k] for k, t in enumerate(tids)})
    for k, t in enumerate(tids):
        solo = _solo(svc, **kw)
        alone = solo.process_stream(traces[k], chunk=CHUNK)
        for a, b in zip(together[t], alone):
            np.testing.assert_array_equal(a, b)
        got = eng.pool.read(t)
        assert _states_equal(got, solo.state)
        assert torch.equal(got["evict_age"], solo.state["evict_age"])
        assert eng.stats()["tenants"][t]["slot_collisions"] == 0


def test_tenant_batched_fc_plain_matches_process_serial():
    """The tenant-batched FC on tenants {3, 0, 2} of a 4-tenant pool, each
    from a different state and trace: the kernel's phase twin with the
    combined keys (``fc_phases_tenants_ref``) equals ``process_serial``
    lane by lane bit for bit, features and every pool table; tenant 1 is
    untouched.  No kernel launches on the CPU.  The wrapper rejects
    repeated and out-of-pool tenants."""
    tids = [3, 0, 2]
    pool = init_state_stacked(4, 128, device="cpu")
    for t, attack in enumerate(["mirai", "syn_dos", "os_scan", "slowloris"]):
        warm = to_torch(_eval_trace(attack, seed=80 + t, n=48), "cpu")
        process_serial(tenant_view(pool, t), warm)
    lanes = [_eval_trace(a, seed=90 + i, n=48)
             for i, a in enumerate(["ssdp_flood", "mirai", "fuzzing"])]
    pk = to_torch({k: np.stack([tr[k] for tr in lanes]) for k in lanes[0]}, "cpu")
    want = [process_serial(clone_state(tenant_view(pool, t)),
                           {k: v[lane] for k, v in pk.items()})
            for lane, t in enumerate(tids)]
    untouched = clone_state(tenant_view(pool, 1))
    reset_launch_counts()
    _, feats = fc_phases_tenants_ref(pool, tids, pk)
    assert set(launch_counts().values()) == {0}
    assert feats.shape == (3, 96, 80)
    for lane, t in enumerate(tids):
        assert torch.equal(feats[lane], want[lane][1]), lane
        assert _states_equal(tenant_view(pool, t), want[lane][0]), t
    assert _states_equal(tenant_view(pool, 1), untouched)
    with pytest.raises(ValueError, match="distinct"):
        feature_update_full_tenants(pool, [0, 0, 2], pk)
    with pytest.raises(ValueError, match="distinct"):
        feature_update_full_tenants(pool, [0, 4, 2], pk)


# ---------------------------------------------------------------------------
# host hashing and collision telemetry against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", ["mirai", "syn_dos", "video_injection"])
def test_np_hash_and_slot_collisions_match_jax(attack):
    tr = _eval_trace(attack, seed=3, n=256)
    for n_slots in (64, 512):
        assert slot_collisions(tr, n_slots) == jax_slot_collisions(tr, n_slots)
    assert slot_collisions(tr, 64)["total"] > 0
    t_fields, _ = key_fields(to_torch(tr, "cpu"))
    for name, fields in _np_key_fields(tr).items():
        for salt in (KEY_SALTS[name], 0x7F4A7C15):
            got = np_hash_fields(fields, salt)
            np.testing.assert_array_equal(got, jax_np_hash_fields(fields, salt))
            np.testing.assert_array_equal(
                got.astype(np.int64), hash_fields(t_fields[name], salt).numpy())
        both = hash_fields(t_fields[name], (KEY_SALTS[name], 0x7F4A7C15))
        for h, salt in zip(both, (KEY_SALTS[name], 0x7F4A7C15)):
            assert torch.equal(h, hash_fields(t_fields[name], salt))


@pytest.mark.parametrize("attack", ["mirai", "syn_dos", "video_injection"])
def test_slot_collisions_lanes_match_host_count(attack):
    """The engine's device collision counter, every lane of a batch in one
    pass, equals the JAX package's host ``slot_collisions`` lane by lane
    (and the port's numpy copy on one lane)."""
    lanes = [_eval_trace(attack, seed=s, n=128) for s in (3, 4, 5)]
    pk = to_torch({k: np.stack([tr[k] for tr in lanes]) for k in lanes[0]}, "cpu")
    for n_slots in (16, 64, 512):
        want = [jax_slot_collisions(tr, n_slots)["total"] for tr in lanes]
        assert slot_collisions_lanes(pk, n_slots).tolist() == want
    assert min(jax_slot_collisions(tr, 16)["total"] for tr in lanes) > 0
    one = slot_collisions_lanes(to_torch(lanes[0], "cpu"), 64)
    assert one.dim() == 0 and int(one) == slot_collisions(lanes[0], 64)["total"]


# ---------------------------------------------------------------------------
# against the JAX package's engine
# ---------------------------------------------------------------------------
def _net_arrays(net):
    d = {"idx": net.idx, "mask": net.mask, **net.params,
         "norm_min": net.norm_min, "norm_max": net.norm_max,
         "out_min": net.out_min, "out_max": net.out_max}
    return {k: np.array(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_fitted():
    """A JAX service (scan FC) fitted on a mirai trace, and its net carried
    into the port."""
    data = synth_trace("mirai", n_train=1024, n_benign_eval=192, n_attack=192,
                       seed=4)
    js = JaxService(epoch=EPOCH, n_slots=N_SLOTS, backend="scan")
    js.observe_stream(data["train"], chunk=256)
    js.fit(fpr=0.05)
    return data, js, kitnet_from_arrays(_net_arrays(js.net), device="cpu")


def _assert_within_jax_envelope(got, want, threshold):
    """Indices equal, scores within SCORE_TOL, alarms equal off the
    threshold: ``tests/test_torch_service.py``'s envelope."""
    (idx, scores, alarms), (j_idx, j_scores, j_alarms) = got, want
    assert len(idx) > 0
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(scores, j_scores, **SCORE_TOL)
    near = np.abs(j_scores - threshold) <= (
        SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(j_scores))
    np.testing.assert_array_equal(alarms[~near], j_alarms[~near])


def test_single_tenant_engine_matches_jax_engine(jax_fitted):
    """A JAX service's net, threshold, tables and stream position carried
    into a one-tenant port engine: its results against JAX's one-tenant
    engine on the serial backend, indices equal and scores within
    SCORE_TOL (alarms equal off the threshold)."""
    data, js, net = jax_fitted
    state = jax.tree_util.tree_map(np.array, js.state)
    ev = {k: v for k, v in data["eval"].items() if k != "label"}
    je = JaxEngine.from_service(js, backend="serial", n_tenants=1, chunk=CHUNK,
                                queue_depth=4)
    jt = je.add_tenant()
    je.seed_tenant(jt, js.state, js.pkt_count)
    j_idx, j_scores, j_alarms = je.run({jt: ev})[jt]

    eng = DetectionEngine(net, js.threshold, epoch=EPOCH, n_slots=N_SLOTS,
                          n_tenants=1, chunk=CHUNK, queue_depth=4, device="cpu")
    t = eng.add_tenant()
    eng.seed_tenant(t, state_from_arrays(state, device="cpu"), js.pkt_count)
    got = eng.run({t: ev})[t]
    assert len(got[0]) == len(ev["ts"]) // EPOCH
    _assert_within_jax_envelope(got, (j_idx, j_scores, j_alarms), js.threshold)


# ---------------------------------------------------------------------------
# import-graph pin
# ---------------------------------------------------------------------------
def test_serving_import_graph_stays_detection_only():
    """Importing ``repro_torch.serving`` imports neither JAX nor the JAX
    package, nor the LM stack (``repro_torch.models``/``configs``); the
    placement rules (``repro_torch.distributed``) are allowed, as
    ``repro.distributed`` is in the JAX package's test.  Runs in a fresh
    interpreter so it is immune to import order."""
    allowed = ("repro_torch.core", "repro_torch.data", "repro_torch.detection",
               "repro_torch.distributed", "repro_torch.kernels",
               "repro_torch.serving", "repro_torch.traffic", "repro_torch.device")
    code = ("import sys, repro_torch.serving\n"
            "print('\\n'.join(sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('jax', 'repro', 'repro_torch', 'jaxlib'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    mods = out.stdout.split()
    assert "repro_torch.serving.engine" in mods
    bad = [m for m in mods if m != "repro_torch" and not m.startswith(allowed)]
    assert not bad, f"repro_torch.serving pulled in disallowed modules: {bad}"
