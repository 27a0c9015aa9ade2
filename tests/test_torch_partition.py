"""PyTorch port, partitioned FC: the ``bucketed`` backend (the scan backend
cut into buckets, ``core/bucketed.py``) and the ``sharded`` backend
(hash-partitioned tables, ``core/sharded.py``), the two-level scans under
them, and the backend-options path (``backend_kw``/``md_kw``) through the
service, the engine, the fused steps and the evaluation protocol.

Tolerances.  ``bucketed`` at one bucket is the scan backend bit for bit;
with more buckets it reassociates once more, so it is held to the JAX
package's scan envelope against the serial oracle (tests/test_backends.py,
as ``tests/test_torch_scan.py`` holds ``scan``), and against the JAX
package's ``process_bucketed`` to the per-kind limits of
``tests/test_torch_fc.py`` (the state as ``test_torch_scan.py`` holds it
against JAX's scan).  Its record-sampled path takes the same operations per
row: bit for bit the full path's rows and state.  ``sharded`` is the serial
step on partitioned tables, so it equals the port's ``process_serial`` bit
for bit in both modes; against the JAX package's ``process_sharded`` it is
held to the port's serial envelopes against JAX's serial
(``tests/test_torch_fc.py`` exact, ``tests/test_torch_switch.py`` switch).
Print the readings (bucketed against JAX per kind; what a full-width
``exp2`` would cost the sharded step's bits) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_partition.py
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core.bucketed import process_bucketed as jax_process_bucketed
from repro.core.sharded import process_sharded as jax_process_sharded
from repro.core.sharded import shard_tables as jax_shard_tables
from repro.traffic.generator import ATTACKS
from test_torch_fc import _assert_feats, _assert_state
from test_torch_scan import JAX_STATE_TOL, STATE_TOL, _envelope, _trace
from test_torch_switch import MAX_FEATURE_DIFFS, SR_TOL

from repro_torch.core import (N_FEATURES, clone_state, compute_features,
                              init_state, process_bucketed, process_serial)
from repro_torch.core.backends import _REGISTRY, compute_features_sampled
from repro_torch.core.bucketed import process_bucketed_sampled
from repro_torch.core.parallel import seg_last_scan, seg_linear_scan
from repro_torch.core.sharded import shard_tables, unshard_tables
from repro_torch.core.state import init_state_stacked
from repro_torch.detection import (run_peregrine, score_records, train_kitnet,
                                   validate_md_options)
from repro_torch.detection.sweep import sweep_attack
from repro_torch.serving import (DetectionEngine, DetectionService,
                                 make_fused_step, make_tenant_step)
from repro_torch.traffic import synth_trace, to_torch

torch.set_num_threads(1)

N_PKTS = 256
N_SLOTS = 512


@functools.lru_cache(maxsize=None)
def _serial(attack: str, mode: str = "exact"):
    """The port's serial oracle on an attack's trace from fresh tables
    (shared by the tests, which never write to it)."""
    return process_serial(init_state(N_SLOTS, device="cpu"),
                          to_torch(_trace(attack), "cpu"), mode=mode)


@functools.lru_cache(maxsize=None)
def _sharded(attack: str, mode: str, shards: int):
    """``process_sharded`` on an attack's trace from fresh tables (shared
    by the tests, which never write to it)."""
    return compute_features(init_state(N_SLOTS, device="cpu"),
                            to_torch(_trace(attack), "cpu"), backend="sharded",
                            shards=shards, mode=mode)


def _bitwise(st_a, f_a, st_b, f_b, msg=""):
    assert torch.equal(f_a, f_b), (msg, float((f_a - f_b).abs().max()))
    for g in st_b:
        for k in st_b[g]:
            assert torch.equal(st_a[g][k], st_b[g][k]), (msg, g, k)


def _state_close(st, want, msg, **tol):
    for g in want:
        for k in want[g]:
            np.testing.assert_allclose(st[g][k].numpy(), np.asarray(want[g][k]),
                                       err_msg=f"{msg} {g}/{k}", **tol)


# ---------------------------------------------------------------------------
# the two-level scans
# ---------------------------------------------------------------------------
def test_chunked_scans_against_flat():
    """The latest-value scan's chunked form equals the flat one exactly at
    every cut (ragged ones too); the linear scan's equals it at one chunk
    bit for bit and within float32 reassociation at more, with the carry
    crossing cuts and killed at segment starts."""
    rng = np.random.default_rng(0)
    n = 203
    start = torch.from_numpy(rng.random(n) < 0.08)
    start[0] = True
    delta = torch.from_numpy(rng.uniform(0.5, 1.0, (n, 4)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0.0, 2.0, (n, 4, 3)).astype(np.float32))
    flat = seg_linear_scan(start, delta[..., None], x)
    assert torch.equal(seg_linear_scan(start, delta[..., None], x, chunks=1), flat)
    want = np.zeros((n, 4, 3))
    for i in range(n):
        prev = 0.0 if start[i] else want[i - 1]
        want[i] = delta[i].double().numpy()[:, None] * prev + x[i].double().numpy()
    x_in = x.clone()
    valid = torch.from_numpy(rng.random((n, 2)) < 0.3)
    value = torch.from_numpy(rng.normal(size=(n, 2, 5)).astype(np.float32))
    found, last = seg_last_scan(start, valid, value)
    for chunks in (2, 3, 7, 16, 64, 300):
        got = seg_linear_scan(start, delta[..., None], x, chunks=chunks)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, err_msg=str(chunks))
        f_c, l_c = seg_last_scan(start, valid, value, chunks=chunks)
        assert torch.equal(f_c, found) and torch.equal(l_c, last), chunks
    assert torch.equal(x, x_in)          # the scans never write their input


# ---------------------------------------------------------------------------
# bucketed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_bucketed_matches_scan_and_serial(attack):
    """One bucket: the scan backend bit for bit.  Four and sixteen: the JAX
    package's scan envelope against the serial oracle."""
    pk = to_torch(_trace(attack), "cpu")
    st0 = init_state(N_SLOTS, device="cpu")
    st_p, f_p = compute_features(clone_state(st0), pk, backend="scan")
    st_1, f_1 = compute_features(clone_state(st0), pk, backend="bucketed",
                                 buckets=1)
    _bitwise(st_1, f_1, st_p, f_p, attack)
    st_s, f_s = _serial(attack)
    for S in (4, 16):
        st_b, f_b = compute_features(clone_state(st0), pk, backend="bucketed",
                                     buckets=S)
        assert f_b.shape == (N_PKTS, N_FEATURES) and torch.isfinite(f_b).all()
        _envelope(f_b.numpy(), f_s.numpy(), f"{attack} S={S}")
        _state_close(st_b, {g: {k: v.numpy() for k, v in st_s[g].items()}
                            for g in st_s}, f"{attack} S={S}", **STATE_TOL)


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_bucketed_matches_jax_bucketed(attack):
    tr = _trace(attack)
    st_j, f_j = jax_process_bucketed(jax_init_state(N_SLOTS),
                                     {k: jnp.asarray(v) for k, v in tr.items()},
                                     buckets=4)
    st_t, f_t = process_bucketed(init_state(N_SLOTS, device="cpu"),
                                 to_torch(tr, "cpu"), buckets=4)
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _state_close(st_t, st_j, attack, **JAX_STATE_TOL)


@pytest.mark.parametrize("n,S", [(250, 4), (250, 16), (97, 3), (1, 16)])
def test_bucketed_ragged_batch(n, S):
    """n not a multiple of S: the padded tail changes no real row; the scan
    envelope against the serial oracle, and (at 250 packets, 16 buckets)
    against JAX's padded ``process_bucketed``."""
    tr = {k: v[:n] for k, v in _trace("mirai").items()}
    pk = to_torch(tr, "cpu")
    st_s, f_s = process_serial(init_state(N_SLOTS, device="cpu"), pk)
    st_b, f_b = process_bucketed(init_state(N_SLOTS, device="cpu"), pk,
                                 buckets=S)
    assert f_b.shape == (n, N_FEATURES)
    _envelope(f_b.numpy(), f_s.numpy(), f"n={n} S={S}")
    _state_close(st_b, {g: {k: v.numpy() for k, v in st_s[g].items()}
                        for g in st_s}, f"n={n} S={S}", **STATE_TOL)
    if (n, S) != (250, 16):
        return
    st_j, f_j = jax_process_bucketed(jax_init_state(N_SLOTS),
                                     {k: jnp.asarray(v) for k, v in tr.items()},
                                     buckets=S)
    _assert_feats(f_b.numpy(), np.asarray(f_j), f"n={n} S={S}")
    _state_close(st_b, st_j, f"n={n} S={S}", **JAX_STATE_TOL)


@pytest.mark.parametrize("n", [256, 250])
def test_bucketed_sampled_equals_full(n):
    """The record-sampled path: the full path's rows and state bit for bit,
    directly and through the registry, with repeated and unsorted rows."""
    pk = {k: v[:n] for k, v in to_torch(_trace("active_wiretap"), "cpu").items()}
    st0 = init_state(N_SLOTS, device="cpu")
    st_f, f_full = process_bucketed(clone_state(st0), pk, buckets=4)
    for idx in (torch.arange(31, n, 32), torch.tensor([200, 3, 3, 0, n - 1])):
        for fn in (lambda s, p, i: process_bucketed_sampled(s, p, i, buckets=4),
                   lambda s, p, i: compute_features_sampled(
                       s, p, i, backend="bucketed", buckets=4)):
            st_x, f_x = fn(clone_state(st0), pk, idx)
            _bitwise(st_x, f_x, st_f, f_full[idx], str(idx.tolist()))
    st_e, f_e = process_bucketed_sampled(clone_state(st0), pk,
                                         torch.zeros(0, dtype=torch.int64))
    assert f_e.shape == (0, N_FEATURES)
    assert torch.equal(st_e["bi"]["sr"], st_f["bi"]["sr"])


def test_bucketed_chained_chunks_track_one_batch():
    """State carried across three chunks: >= 99.9% of values and every
    non-pcc value within the envelope of the one-batch run."""
    pk = to_torch(_trace("mirai", seed=3, n=300), "cpu")
    _, f_once = process_bucketed(init_state(256, device="cpu"), pk, buckets=4)
    st = init_state(256, device="cpu")
    parts = []
    for i in range(0, 300, 100):
        st, f = compute_features(st, {k: v[i:i + 100] for k, v in pk.items()},
                                 backend="bucketed", buckets=4)
        parts.append(f)
    fa, fo = torch.cat(parts).numpy(), f_once.numpy()
    ok = np.abs(fa - fo) <= 1.0 + 1e-3 * np.abs(fo)
    assert ok.mean() >= 0.999, ok.mean()
    _envelope(fa, fo, "chained")


@pytest.mark.parametrize("S", [1, 4, 16])
def test_bucketed_pays_the_scan_backends_two_sorts(S):
    from torch.profiler import profile
    pk = to_torch(_trace("syn_dos"), "cpu")
    with profile() as prof:
        process_bucketed(init_state(64, device="cpu"), pk, buckets=S)
    sorts = sum(e.count for e in prof.key_averages() if e.key == "aten::sort")
    assert sorts == 2, sorts


def test_bucketed_rejects_bad_arguments():
    pk = to_torch(_trace("syn_dos"), "cpu")
    st = init_state(64, device="cpu")
    for fn in (lambda: process_bucketed(st, pk, buckets=0),
               lambda: process_bucketed_sampled(st, pk, torch.arange(3), buckets=0),
               lambda: process_bucketed(st, pk, mode="switch"),
               lambda: compute_features(st, pk, backend="bucketed", mode="switch")):
        with pytest.raises(ValueError):
            fn()


# ---------------------------------------------------------------------------
# sharded
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_sharded_matches_serial_bitwise(attack):
    """Exact mode at 1, 4 and 16 shards, switch mode at 4: the port's
    serial oracle bit for bit, features and every table."""
    for mode, counts in (("exact", (1, 4, 16)), ("switch", (4,))):
        st_s, f_s = _serial(attack, mode)
        for S in counts:
            st_h, f_h = _sharded(attack, mode, S)
            _bitwise(st_h, f_h, st_s, f_s, f"{attack} {mode} S={S}")


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_sharded_matches_jax_sharded(attack):
    """Against JAX's ``process_sharded`` at 4 shards: the exact-mode
    envelope of ``test_torch_fc.py`` and the switch-mode envelope of
    ``test_torch_switch.py``."""
    jx = {k: jnp.asarray(v) for k, v in _trace(attack).items()}
    st_j, f_j = jax_process_sharded(jax_init_state(N_SLOTS), jx, shards=4)
    st_t, f_t = _sharded(attack, "exact", 4)
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _assert_state(st_t, st_j, attack)

    st_j, f_j = jax_process_sharded(jax_init_state(N_SLOTS), jx, shards=4,
                                    mode="switch")
    st_t, f_t = _sharded(attack, "switch", 4)
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


def test_shard_tables_round_trip():
    """Slot g lives in shard g % S at local row g // S (JAX's layout, bit
    for bit), scratch rows start fresh, and unsharding drops them."""
    st, _ = process_serial(init_state(64, device="cpu"),
                           to_torch(_trace("mirai"), "cpu"), mode="switch")
    sh = shard_tables(st, 4)
    jsh = jax_shard_tables({g: {k: jnp.asarray(v.numpy()) for k, v in st[g].items()}
                            for g in st}, 4)
    for g in st:
        for k, v in st[g].items():
            assert sh[g][k].shape == (4, v.shape[0], 17) + v.shape[2:]
            np.testing.assert_array_equal(sh[g][k].numpy(), np.asarray(jsh[g][k]))
            assert torch.equal(sh[g][k][1, :, 5], v[:, 5 * 4 + 1])
            fill = -1 if k in ("last_t", "sr_last_t") else 0
            assert (sh[g][k][:, :, -1] == fill).all(), (g, k)
            assert torch.equal(unshard_tables(sh, 4)[g][k], v)


def test_sharded_uneven_partition_raises():
    pk = to_torch(_trace("syn_dos"), "cpu")
    for S in (3, 0):
        with pytest.raises(ValueError, match="divisible"):
            compute_features(init_state(64, device="cpu"), pk, backend="sharded",
                             shards=S)


def test_registry_modes_and_options():
    assert _REGISTRY["sharded"].modes == ("exact", "switch")
    assert _REGISTRY["bucketed"].modes == ("exact",)
    assert _REGISTRY["bucketed"].options == {"buckets"}
    assert _REGISTRY["sharded"].options == {"shards"}
    pk = to_torch(_trace("syn_dos"), "cpu")
    st = init_state(64, device="cpu")
    with pytest.raises(ValueError, match="'serial' or 'sharded'"):
        compute_features(st, pk, backend="bucketed", mode="switch")
    for name, kw in (("sharded", {"buckets": 4}), ("bucketed", {"shards": 4}),
                     ("serial", {"shards": 4})):
        with pytest.raises(TypeError, match=next(iter(kw))):
            compute_features(st, pk, backend=name, **kw)


def test_sketch_state_ignores_partition_options():
    """A sketch state routes to its own update, which takes ``buckets``/
    ``shards`` and ignores them (JAX's sketch does the same)."""
    pk = to_torch(_trace("mirai"), "cpu")
    st0 = init_state(128, state_backend="sketch", rows=2, device="cpu")
    st_a, f_a = compute_features(clone_state(st0), pk, backend="serial")
    for backend, kw in (("bucketed", {"buckets": 4}), ("sharded", {"shards": 4})):
        st_b, f_b = compute_features(clone_state(st0), pk, backend=backend, **kw)
        assert torch.equal(f_a, f_b)
        assert all(torch.equal(st_a[g][k], st_b[g][k])
                   for g in ("uni", "bi") for k in st_a[g])
    with pytest.raises(TypeError, match="chunk"):
        compute_features(clone_state(st0), pk, backend="serial", chunk=4)


# ---------------------------------------------------------------------------
# the options path: service, engine, fused steps, evaluation protocol
# ---------------------------------------------------------------------------
EPOCH = 64


@pytest.fixture(scope="module")
def fitted():
    """A fitted scan service and an eval stream; the tests below give its
    net and threshold to services on other backends."""
    data = synth_trace("mirai", n_train=512, n_benign_eval=512, n_attack=512,
                       seed=4)
    svc = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, backend="scan",
                           device="cpu")
    svc.observe_stream(data["train"], chunk=256)
    svc.fit(fpr=0.05)
    return svc, data


def _run(fitted, backend, mode="exact", n_eval=1024, **backend_kw):
    svc, data = fitted
    s = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, backend=backend,
                         mode=mode, threshold=svc.threshold, device="cpu",
                         **backend_kw)
    s.net = svc.net
    ev = {k: v[:n_eval] for k, v in data["eval"].items()}
    return s, s.process_stream(ev, chunk=256)


def test_service_on_bucketed_and_sharded(fitted):
    """The service on ``bucketed`` (the fused step's record-sampled path)
    and ``sharded`` (the full matrix, gathered): one bucket equals ``scan``
    bit for bit, four agree with it to the service envelope; four shards
    equal ``serial`` bit for bit in exact mode (fused) and switch mode
    (staged)."""
    s_p, want = _run(fitted, "scan")
    s_b, got = _run(fitted, "bucketed", buckets=1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    s_b, got = _run(fitted, "bucketed", buckets=4)
    assert s_b.fused and s_b.backend_kw == {"buckets": 4}
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-4)
    for mode, n_eval in (("exact", 1024), ("switch", 256)):
        s_s, want = _run(fitted, "serial", mode, n_eval)
        s_h, got = _run(fitted, "sharded", mode, n_eval, shards=4)
        assert s_h.fused == (mode == "exact") and len(got[0]) > 0
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        assert all(torch.equal(s_s.state[g][k], s_h.state[g][k])
                   for g in ("uni", "bi") for k in s_s.state[g])


def test_engine_bucketed_tenants_equal_solo_services(fitted):
    """An engine on ``backend="bucketed", backend_kw={"buckets": 4}`` (lane
    by lane): each tenant equals its solo service bit for bit; an engine
    built from a sharded service inherits its options."""
    svc, data = fitted
    ev = data["eval"]
    traces = {k: {f: v[300 * k:300 * k + 600] for f, v in ev.items()}
              for k in range(3)}
    eng = DetectionEngine(svc.net, svc.threshold, epoch=EPOCH, n_slots=N_SLOTS,
                          n_tenants=3, chunk=256, backend="bucketed",
                          backend_kw={"buckets": 4}, device="cpu")
    tids = [eng.add_tenant() for _ in range(3)]
    got = eng.run({tid: traces[k] for k, tid in enumerate(tids)})
    for k, tid in enumerate(tids):
        solo = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, backend="bucketed",
                                buckets=4, threshold=svc.threshold, device="cpu")
        solo.net = svc.net
        want = solo.process_stream(traces[k], chunk=256)
        assert len(want[0]) > 0
        for w, g in zip(want, got[tid]):
            np.testing.assert_array_equal(w, g)
        assert all(torch.equal(solo.state[g][f], eng.pool.read(tid)[g][f])
                   for g in ("uni", "bi") for f in solo.state[g])
    sharded = DetectionService(epoch=EPOCH, n_slots=N_SLOTS, backend="sharded",
                               shards=8, md_backend="einsum", device="cpu")
    sharded.net, sharded.threshold = svc.net, svc.threshold
    eng = DetectionEngine.from_service(sharded, n_tenants=1, chunk=256)
    assert (eng.backend, eng.backend_kw, eng.md_backend, eng.md_kw) == (
        "sharded", {"shards": 8}, "einsum", {})
    tid = eng.add_tenant()
    got = eng.run({tid: traces[0]})[tid]
    want = sharded.process_stream(traces[0], chunk=256)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_md_options_validation(fitted):
    """Unknown MD options raise ``TypeError`` everywhere they enter: the
    JAX package's Pallas knobs ``bb``/``interpret`` have no counterpart;
    the ``cuda`` ensemble's ``design`` is taken by its ensemble stage (and
    ignored by the plain version on the CPU) but not where scoring would
    drop it."""
    svc, data = fitted
    assert validate_md_options("pallas", {"design": "pair"}, stage="ensemble") == "cuda"
    for kw in ({"bb": 128}, {"interpret": True}):
        for stage in ("score", "ensemble"):
            with pytest.raises(TypeError, match=next(iter(kw))):
                validate_md_options("cuda", kw, stage=stage)
    with pytest.raises(TypeError, match="design"):
        validate_md_options("cuda", {"design": "pair"})
    with pytest.raises(TypeError, match="design"):
        validate_md_options("einsum", {"design": "pair"}, stage="ensemble")
    recs = torch.rand(64, N_FEATURES, generator=torch.Generator().manual_seed(1))
    a = train_kitnet(recs, md_backend="cuda", device="cpu")
    b = train_kitnet(recs, md_backend="cuda", device="cpu", md_kw={"design": "pair"})
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    bad = {"bb": 64}
    for fn in (lambda: train_kitnet(recs, device="cpu", md_kw=bad),
               lambda: score_records(svc.net, recs, backend="cuda", **bad),
               lambda: make_fused_step(md_kw=bad),
               lambda: make_tenant_step(md_kw=bad),
               lambda: DetectionEngine(svc.net, 1.0, md_kw=bad, device="cpu"),
               lambda: run_peregrine(data, 64, md_kw=bad, device="cpu"),
               lambda: sweep_attack(data, [64], md_kw=bad, device="cpu")):
        with pytest.raises(TypeError, match="bb"):
            fn()
    for fn in (lambda: make_fused_step(backend_kw={"chunk": 64}),
               lambda: make_tenant_step(backend="scan", backend_kw={"shards": 2}),
               lambda: DetectionEngine(svc.net, 1.0, backend_kw={"buckets": 2},
                                       device="cpu")):
        with pytest.raises(TypeError):
            fn()


def test_fused_steps_take_backend_options(fitted):
    """``make_fused_step``/``make_tenant_step`` with ``backend_kw``: the
    bucketed step's records equal the full bucketed features gathered, and
    the tenant step's lane equals the single-stream step."""
    svc, data = fitted
    pk = to_torch({k: v[:512] for k, v in data["eval"].items()}, "cpu")
    st0 = init_state(N_SLOTS, device="cpu")
    step = make_fused_step(backend="bucketed", backend_kw={"buckets": 4},
                           md_backend="einsum", epoch=EPOCH)
    st_a, idx, scores, alarms, count = step(clone_state(st0), svc.net,
                                            svc.threshold, 0, pk)
    st_f, feats = process_bucketed(clone_state(st0), pk, buckets=4)
    _bitwise(st_a, scores, st_f, torch.as_tensor(
        score_records(svc.net, feats[idx], backend="einsum")))
    assert count == 512 // EPOCH
    pool = init_state_stacked(1, N_SLOTS, device="cpu")
    tstep = make_tenant_step(backend="bucketed", backend_kw={"buckets": 4},
                             md_backend="einsum", epoch=EPOCH)
    _, t_idx, t_scores, _, counts = tstep(pool, [0], svc.net, svc.threshold,
                                          [0], {k: v[None] for k, v in pk.items()})
    assert torch.equal(t_idx[0], idx) and torch.equal(t_scores[0], scores)
    assert counts == (count,)


if __name__ == "__main__":
    # The readings behind the tolerances above:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_partition.py
    import repro_torch.core.sharded as sharded_mod
    from test_torch_fc import _readings
    worst = {}
    for attack in sorted(ATTACKS):
        tr = _trace(attack)
        _, f_j = jax_process_bucketed(jax_init_state(N_SLOTS),
                                      {k: jnp.asarray(v) for k, v in tr.items()},
                                      buckets=4)
        _, f_t = process_bucketed(init_state(N_SLOTS, device="cpu"),
                                  to_torch(tr, "cpu"), buckets=4)
        for k, v in _readings(f_t.numpy(), np.asarray(f_j)).items():
            worst[k] = max(worst.get(k, 0.0), float(v))
    print("bucketed (S=4) against JAX's process_bucketed, worst over the "
          f"15 attacks: {worst}")
    # what the owner-only exp2 of the sharded step buys on the CPU: the same
    # step with one exp2 call over all S shards' rows
    sharded_mod._owner_exp2 = lambda own: torch.exp2
    differ = 0
    for attack in sorted(ATTACKS):
        pk = to_torch(_trace(attack), "cpu")
        _, f_s = _serial(attack)
        for S in (4, 16):
            _, f_h = sharded_mod.process_sharded(init_state(N_SLOTS, device="cpu"),
                                                 pk, shards=S)
            differ += int((f_h != f_s).sum())
    print("sharded with one full-width exp2 call, feature values that differ "
          f"from serial over 15 attacks at S=4 and 16: {differ}")
