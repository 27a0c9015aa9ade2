"""PyTorch port, the Count-Min sketch slice: the state-backend registry, the
plain sketch update (the sketch kernel's plain version), the sketch service
and the single-key atom update, each held against the JAX package on the
CPU; plus the sketch's own invariants inside the port.

Tolerances.
* rows=1: the state and the w/mean/magnitude columns to rtol=1e-4,
  atol=1e-3; std/radius/cov/pcc to the envelopes of tests/test_torch_fc.py
  (``_assert_feats``), whose float32 cancellation argument is the same here.
  Inside the port, a rows=1 sketch equals the dense ``process_serial`` bit
  for bit, state and features.
* rows>=2: the state, w/mean/magnitude, std/radius and cov as at rows=1.
  pcc = cov / (std_own * std_opp) is not comparable where a variance sits at
  the float32 cancellation floor: there the port (no contracted
  multiply-add) often reads exactly 0 and the JAX package a small positive
  value, and the quotient differs by up to ~6e6.  A sketch's pcc may lie
  beyond +-1 in both packages alike (cov comes from the least-collided
  row's SR, the variances from the min across rows).  So pcc is compared
  everywhere with the JAX package's own loose atol of 0.5
  (tests/test_state_backends.py), and at most PCC_MAX_LOOSE values of a
  trace outside rtol=1e-4, atol=1e-3, except at values that both lie beyond
  +-1 on one side and sit at the floor on one side: the own or opposite
  variance, read back from the std/mean/magnitude/cov/pcc columns, at most
  CANCEL * E[x^2].  Each test bounds the count of such values (``floor_max``,
  about twice the count measured: 4 a trace at width 512, 10 at width 64
  and rows=3, 56 over the carried state's 128 packets at width 64).
  Print the readings with ``PYTHONPATH=src python tests/test_torch_sketch.py``.
* single-key update: w, mean and the table to the JAX package's rtol=1e-5,
  atol=1e-3 (tests/test_kernels.py); sigma to the cancellation envelope
  |s_a^2 - s_b^2| <= 32 * 2^-23 * E[x^2].
* the sketch service with a JAX-fitted net: indices equal, scores to
  rtol=1e-3, atol=1e-4 (tests/test_torch_service.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core.sketch import process_sketch as jax_process_sketch
from repro.core.state import slot_collisions
from repro.core.state import state_backend_of as jax_state_backend_of
from repro.core.state import state_config as jax_state_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.serving import DetectionService as JaxService
from repro.traffic import synth_trace
from repro.traffic.generator import ATTACKS

from repro_torch.core import (FEATURE_NAMES, N_FEATURES, clone_state,
                              compute_features, init_state, packet_slots,
                              process_serial)
from repro_torch.core.pipeline import flat_tables
from repro_torch.core.sketch import (SKETCH_TABLES, _sketch_packet_step,
                                     process_sketch, row_salt,
                                     sketch_flat_rows, sketch_packet_rows)
from repro_torch.core.state import (KEY_SALTS, LAMBDAS,
                                    available_state_backends,
                                    state_backend_of, state_config,
                                    state_slots)
from repro_torch.interop import (kitnet_from_arrays, state_from_arrays,
                                 state_to_arrays)
from repro_torch.kernels import (feature_update, launch_counts,
                                 reset_launch_counts, sketch_update_full)
from repro_torch.kernels.feature_update import (feature_update_phases_ref,
                                                feature_update_ref)
from repro_torch.kernels.sketch_update import (kernel_rows, last_row_width,
                                               round_size, sketch_schedule_ref)
from repro_torch.serving import DetectionService
from repro_torch.traffic import to_torch

from test_torch_fc import (PCC_MAX_LOOSE, TOL, _assert_feats, _cols, _jax,
                           _readings, _trace)

torch.set_num_threads(1)

N_PKTS = 256
PCC_ATOL_ROWS = 0.5
PCC_FLOOR_MAX = 8
SCORE_TOL = dict(rtol=1e-3, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-3)
CANCEL = 32 * 2.0 ** -23
_PCC, _PCC_STD = _cols("pcc", "std")
_PCC_MEAN = _cols("pcc", "mean")[1]
_PCC_COV = _cols("pcc", "cov")[1]
_PCC_MAG = _cols("pcc", "magnitude")[1]


def _sketch(width, rows, evict_age=0.0):
    return init_state(width, state_backend="sketch", device="cpu", rows=rows,
                      evict_age=evict_age)


def _jax_sketch(width, rows, evict_age=0.0):
    return jax_init_state(width, state_backend="sketch", rows=rows,
                          evict_age=evict_age)


def _assert_state(got, want, msg=""):
    for g in ("uni", "bi"):
        assert set(got[g]) == set(want[g]), (msg, g)
        for k in want[g]:
            np.testing.assert_allclose(got[g][k].numpy(), np.asarray(want[g][k]),
                                       err_msg=f"{msg} {g}/{k}", **TOL)
    assert float(got["evict_age"]) == float(want["evict_age"])


def _at_floor(f) -> np.ndarray:
    """Per pcc value: the own or the opposite variance at the float32
    cancellation floor, var <= CANCEL * E[x^2].  Read back from the
    features: var_o = std^2; std_o * std_p = cov / pcc (0 where pcc = 0 but
    cov is not: the denominator was 0), so var_p = (cov / (pcc * std))^2;
    E[x^2] = mean^2 + var, with mu_p^2 <= magnitude^2."""
    f = f.astype(np.float64)
    cov, pcc, std = f[:, _PCC_COV], f[:, _PCC], f[:, _PCC_STD]
    var_o = std ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        den = np.where(pcc != 0, np.abs(cov / pcc), np.where(cov != 0, 0.0, np.nan))
        var_p = (den / std) ** 2
    return ((var_o <= CANCEL * (f[:, _PCC_MEAN] ** 2 + var_o))
            | (var_p <= CANCEL * (f[:, _PCC_MAG] ** 2 + var_p)))


def _pcc_readings(got, want) -> dict:
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    g, w = got[:, _PCC], want[:, _PCC]
    beyond = (np.abs(g) > 1.0) | (np.abs(w) > 1.0)
    floor = _at_floor(got) | _at_floor(want)
    ok = ~(beyond & floor)
    slack = np.abs(g - w) - 1e-4 * np.abs(w)
    return {"pcc_atol": slack[ok].max() if ok.any() else 0.0,
            "pcc_loose": int((slack[ok] > TOL["atol"]).sum()),
            "pcc_floor": int((~ok).sum()),
            "pcc_beyond_1": int(beyond.sum())}


def _assert_feats_rows(got, want, msg="", floor_max=PCC_FLOOR_MAX):
    """rows >= 2: every column but pcc as at rows=1; pcc as described above."""
    got_np = got.copy()
    got_np[:, _PCC] = np.asarray(want)[:, _PCC]      # pcc held separately
    _assert_feats(got_np, want, msg)
    r = _pcc_readings(got, want)
    assert (r["pcc_atol"] <= PCC_ATOL_ROWS and r["pcc_loose"] <= PCC_MAX_LOOSE
            and r["pcc_floor"] <= floor_max), (msg, r)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_matches_jax():
    assert available_state_backends() == ("dense", "sketch")
    for kw in ({}, {"rows": 3, "evict_age": 2.5}, {"rows": 1}):
        layout = "sketch" if kw else "dense"
        got = init_state(64, state_backend=layout, device="cpu", **kw)
        want = jax_init_state(64, state_backend=layout, **kw)
        assert state_backend_of(got) == jax_state_backend_of(want) == layout
        assert state_config(got) == jax_state_config(want)
        assert state_slots(got) == 64
        got, want = state_to_arrays(got), jax.tree_util.tree_map(np.asarray, want)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b), layout
    for base in KEY_SALTS.values():
        assert row_salt(base, 0) == base


def test_registry_errors_match_jax():
    pk = to_torch(_trace("syn_dos"), "cpu")
    with pytest.raises(ValueError, match="unknown state backend"):
        init_state(64, state_backend="nope", device="cpu")
    with pytest.raises(ValueError, match="at least one row"):
        _sketch(64, 0)
    with pytest.raises(ValueError, match="sketch-backed state"):
        compute_features(init_state(64, device="cpu"), pk, backend="sketch")
    with pytest.raises(ValueError, match="exact arithmetic only"):
        compute_features(_sketch(64, 2), pk, backend="serial", mode="switch")


# ---------------------------------------------------------------------------
# the plain sketch against the JAX package's reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_process_sketch_rows1_matches_jax(attack):
    tr = _trace(attack)
    st_j, f_j = jax_process_sketch(_jax_sketch(512, 1), _jax(tr))
    st_t, f_t = process_sketch(_sketch(512, 1), to_torch(tr, "cpu"))
    assert f_t.shape == (N_PKTS, N_FEATURES) and torch.isfinite(f_t).all()
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _assert_state(st_t, st_j, attack)


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_process_sketch_rows_matches_jax(attack, rows):
    tr = _trace(attack)
    st_j, f_j = jax_process_sketch(_jax_sketch(512, rows), _jax(tr))
    st_t, f_t = process_sketch(_sketch(512, rows), to_torch(tr, "cpu"))
    _assert_feats_rows(f_t.numpy(), np.asarray(f_j), f"{attack}/rows={rows}")
    _assert_state(st_t, st_j, f"{attack}/rows={rows}")


@pytest.mark.parametrize("evict_age", [0.0, 0.5])
def test_sketch_wrapper_on_cpu_matches_jax_pallas_kernel(evict_age):
    """The port's sketch wrapper on CPU tensors (its plain version) against
    the TPU kernel it replaces, in interpret mode, at rows=3 and width 64,
    where rows collide."""
    tr = _trace("mirai")
    st_j, f_j = jax_ops.sketch_update_full(_jax_sketch(64, 3, evict_age),
                                           _jax(tr), chunk=64, interpret=True)
    reset_launch_counts()
    st_t, f_t = sketch_update_full(_sketch(64, 3, evict_age), to_torch(tr, "cpu"))
    assert not any(launch_counts().values())
    _assert_feats_rows(f_t.numpy(), np.asarray(f_j), f"age={evict_age}",
                       floor_max=20)
    _assert_state(st_t, st_j, f"age={evict_age}")


def test_jax_sketch_state_continues_in_the_port():
    """A JAX sketch state carried over as numpy arrays continues in the port
    as in the JAX package, and survives the round trip bit for bit."""
    tr = _trace("ssh_bruteforce")
    first = {k: v[:128] for k, v in tr.items()}
    second = {k: v[128:] for k, v in tr.items()}
    st_j, _ = jax_process_sketch(_jax_sketch(64, 2, 0.5), _jax(first))
    arrays = jax.tree_util.tree_map(np.asarray, st_j)
    st_t = state_from_arrays(arrays, device="cpu")
    back = state_to_arrays(st_t)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(arrays)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(arrays)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert state_backend_of(st_t) == "sketch"
    assert state_config(st_t) == {"rows": 2, "evict_age": 0.5}
    st_j2, f_j = jax_process_sketch(st_j, _jax(second))
    st_t2, f_t = compute_features(st_t, to_torch(second, "cpu"), backend="serial")
    _assert_feats_rows(f_t.numpy(), np.asarray(f_j), floor_max=100)
    _assert_state(st_t2, st_j2)


# ---------------------------------------------------------------------------
# the sketch's own invariants inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attack", ["mirai", "arp_mitm", "active_wiretap",
                                    "ssh_bruteforce", "ddos_hulk"])
def test_rows1_equals_dense_serial_bitwise(attack):
    pk = to_torch(_trace(attack), "cpu")
    st_d, f_d = process_serial(init_state(512, device="cpu"), pk)
    st_s, f_s = compute_features(_sketch(512, 1), pk)
    assert torch.equal(f_s, f_d)
    for g in ("uni", "bi"):
        for k in st_d[g]:
            if k != "rr":       # the dense round-robin counters have no twin
                assert torch.equal(st_s[g][k][:, 0], st_d[g][k]), (g, k)


@pytest.mark.parametrize("width", [64, 512])
def test_row0_is_the_dense_slot_mapping(width):
    pk = to_torch(_trace("fuzzing"), "cpu")
    dense = packet_slots(pk, width)
    rows = sketch_packet_rows(pk, 3, width)
    for k in KEY_SALTS:
        assert torch.equal(rows[k][:, 0], dense[k]), k
        assert (rows[k] < width).all() and (rows[k] >= 0).all()
        assert not torch.equal(rows[k][:, 1], rows[k][:, 0]), k
    assert torch.equal(rows["dir"], dense["dir"])


def test_never_underestimates_decayed_count():
    """Conservative update keeps every w estimate at or above the truth of a
    collision-free dense table."""
    tr = _trace("ddos_hulk")
    n_true = next(n for n in (1 << 18, 1 << 20)
                  if slot_collisions(tr, n)["total"] == 0)
    pk = to_torch(tr, "cpu")
    _, f_true = process_serial(init_state(n_true, device="cpu"), pk)
    _, f_sk = process_sketch(_sketch(16, 2), pk)
    w_cols = _cols("w")
    over = (f_sk[:, w_cols] - f_true[:, w_cols]).numpy()
    assert (over >= -2e-3).all(), over.min()
    assert (over > 0.5).any()           # the 16-wide sketch did collide


def test_eviction_ages_out_idle_cells():
    """One channel, both directions in turn, idle ten minutes before its last
    packet: aged out, the flow restarts fresh (w = 1) and the SR stream with
    it (cov = 0); without aging the decayed history survives."""
    n = 9
    rng = np.random.default_rng(0)
    a, b = np.uint32(7), np.uint32(0xC0A80001)
    fwd = np.arange(n) % 2 == 0
    tr = {"ts": (np.arange(n) * 0.25).astype(np.float32),
          "src": np.where(fwd, a, b).astype(np.uint32),
          "dst": np.where(fwd, b, a).astype(np.uint32),
          "sport": np.where(fwd, 5000, 80).astype(np.uint32),
          "dport": np.where(fwd, 80, 5000).astype(np.uint32),
          "proto": np.full(n, 6, np.uint32),
          "length": rng.integers(60, 1500, n).astype(np.float32)}
    tr["ts"][-1] += 600.0
    # the slowest decay (lambda = 1/60) is the only one with mass left
    # after ten minutes
    w_col = FEATURE_NAMES.index(f"src_ip:{1 / 60}:w")
    cov_col = FEATURE_NAMES.index(f"channel:{1 / 60}:cov")

    def last(evict_age):
        _, f = process_sketch(_sketch(32, 2, evict_age), to_torch(tr, "cpu"))
        return float(f[-1, w_col]), float(f[-1, cov_col])

    w_keep, cov_keep = last(0.0)
    assert w_keep > 1.0 and cov_keep != 0.0
    assert last(60.0) == (1.0, 0.0)


def test_chunked_carry_equals_one_shot():
    pk = to_torch(_trace("goldeneye"), "cpu")
    st1, f_once = process_sketch(_sketch(64, 3, 0.5), pk)
    st2 = _sketch(64, 3, 0.5)
    parts = []
    for i in range(0, N_PKTS, 100):
        st2, f = compute_features(st2, {k: v[i:i + 100] for k, v in pk.items()})
        parts.append(f)
    assert torch.equal(torch.cat(parts), f_once)
    for g in ("uni", "bi"):
        for k in st1[g]:
            assert torch.equal(st1[g][k], st2[g][k]), (g, k)


# ---------------------------------------------------------------------------
# the sketch service with a JAX-fitted net
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fitted_sketch():
    data = synth_trace("mirai", n_train=1024, n_benign_eval=512, n_attack=512,
                       seed=5)
    js = JaxService(epoch=64, n_slots=256, state_backend="sketch",
                    state_kw={"rows": 2, "evict_age": 30.0})
    js.observe_stream(data["train"], chunk=256)
    js.fit(fpr=0.05)
    net = {"idx": js.net.idx, "mask": js.net.mask, **js.net.params,
           "norm_min": js.net.norm_min, "norm_max": js.net.norm_max,
           "out_min": js.net.out_min, "out_max": js.net.out_max}
    carried = {"net": {k: np.array(v) for k, v in net.items()},
               "threshold": js.threshold, "pkt_count": js.pkt_count,
               "state": jax.tree_util.tree_map(np.array, js.state)}
    want = js.process_stream(data["eval"], chunk=256)
    return data, carried, want


def _port(carried) -> DetectionService:
    svc = DetectionService(epoch=64, n_slots=256, device="cpu",
                           state_backend="sketch",
                           state_kw={"rows": 2, "evict_age": 30.0},
                           threshold=carried["threshold"])
    svc.net = kitnet_from_arrays(carried["net"], device="cpu")
    svc.state = state_from_arrays(carried["state"], device="cpu")
    svc.pkt_count = carried["pkt_count"]
    return svc


def test_sketch_service_matches_jax(fitted_sketch):
    data, carried, (j_idx, j_scores, j_alarms) = fitted_sketch
    svc = _port(carried)
    assert state_config(svc.state) == {"rows": 2, "evict_age": 30.0}
    reset_launch_counts()
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=256)
    assert not any(launch_counts().values())
    assert len(idx) == len(data["eval"]["ts"]) // 64
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(scores, j_scores, **SCORE_TOL)
    near = np.abs(j_scores - carried["threshold"]) <= (
        SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(j_scores))
    np.testing.assert_array_equal(alarms[~near], j_alarms[~near])


def test_sketch_service_fused_equals_staged(fitted_sketch):
    data, carried, _ = fitted_sketch
    svc = _port(carried)
    st0, c0 = clone_state(svc.state), svc.pkt_count
    fused = svc.process_stream(data["eval"], chunk=200)
    svc.state, svc.pkt_count = clone_state(st0), c0
    staged = svc.process_stream(data["eval"], chunk=200, fused=False)
    for a, b in zip(fused, staged):
        np.testing.assert_array_equal(a, b)


def test_sketch_service_fits_on_its_own():
    data = synth_trace("syn_dos", n_train=1024, n_benign_eval=256,
                       n_attack=256, seed=1)
    svc = DetectionService(epoch=32, n_slots=128, device="cpu",
                           state_backend="sketch", state_kw={"rows": 2})
    svc.observe_stream(data["train"], chunk=512)
    svc.fit(seed=0, fpr=0.05)
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=256)
    assert len(idx) == 512 // 32 and np.isfinite(scores).all()
    assert state_backend_of(svc.state) == "sketch"


# ---------------------------------------------------------------------------
# the sketch kernel's schedule (its plain twin) and replays in its order
# ---------------------------------------------------------------------------
def _cells(idx, width, table=None):
    """Per key type, the (n, R) columns each packet touches in each row
    (the bi base column covers the own, opposite and SR cells), taken
    modulo ``last_row_width`` when ``table`` is given."""
    _, n, R = idx.shape
    r = torch.arange(R)
    cols = [idx[kt].long() - ((kt % 2) * R + r) * width for kt in range(4)]
    if table is not None:
        cols = [c & (last_row_width(R, table) - 1) for c in cols]
    return cols


def _assert_levels_follow_cells(level, cols):
    """Packets that share a column in some row have strictly increasing
    levels in packet order (consecutive sharers suffice)."""
    for r in range(cols.shape[1]):
        key = cols[:, r]
        order = torch.sort(key, stable=True).indices
        same = key[order][1:] == key[order][:-1]
        lv = level[order]
        assert bool((lv[1:][same] > lv[:-1][same]).all()), r


def _assert_schedule_shape(s, n, R):
    """Order is the stable sort by level; rounds stay within one level and
    hold at most round_size(R) packets."""
    P = round_size(R)
    for kt in range(4):
        level = s["level"][kt].long()
        assert torch.equal(s["order"][kt].long(),
                           torch.sort(level, stable=True).indices)
        assert s["depth"][kt] == (int(level.max()) if n else 0)
        rs = s["round_starts"][kt].long()
        assert len(rs) == s["rounds"][kt] + 1 and int(rs[0]) == 0 and int(rs[-1]) == n
        width = rs[1:] - rs[:-1]
        assert bool((width >= 1).all() and (width <= P).all())
        lv = level[s["order"][kt].long()]
        for a, b in zip(rs[:-1].tolist(), rs[1:].tolist()):
            assert int(lv[a]) == int(lv[b - 1])


@pytest.mark.parametrize("width", [64, 4096])
@pytest.mark.parametrize("rows", [1, 2, 4, 9, 40])
def test_schedule_levels_follow_shared_cells(rows, width):
    """Uni and bi key types: every pair of packets sharing a cell in some row
    is in strictly increasing levels; with a `last` table smaller than R*W
    (columns alias) the same holds and no level falls."""
    pk = to_torch(_trace("mirai"), "cpu")
    idx, _ = kernel_rows(pk, rows, width)
    s = sketch_schedule_ref(idx, width)
    _assert_schedule_shape(s, N_PKTS, rows)
    small = 32 * rows                    # 32 entries a row: columns alias
    aliased = sketch_schedule_ref(idx, width, table=small)
    assert last_row_width(rows, small) < width
    for kt, (cols, cols_a) in enumerate(zip(_cells(idx, width),
                                            _cells(idx, width, small))):
        _assert_levels_follow_cells(s["level"][kt], cols)
        _assert_levels_follow_cells(aliased["level"][kt], cols_a)
        assert bool((aliased["level"][kt] >= s["level"][kt]).all()), kt
    if width == 64:                      # rows collide: levels run deep
        assert min(s["depth"]) > 1 and max(s["depth"]) < N_PKTS


def _replay(state, pkts, order):
    """``process_sketch`` with the packets applied in ``order``; each
    packet's features land at its own row."""
    rows = sketch_flat_rows(pkts, state["uni"]["w"].shape[1],
                            state["uni"]["w"].shape[2])
    tab = flat_tables(state, SKETCH_TABLES)
    ts = pkts["ts"].to(torch.float32)
    lens = pkts["length"].to(torch.float32)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32)
    d = rows["dir"][:, None, None]
    brow_s = rows["bbase"]
    brow_o, brow_p = brow_s * 2 + d, brow_s * 2 + (1 - d)
    feats = torch.empty((ts.shape[0], N_FEATURES), dtype=torch.float32)
    for i in order.tolist():
        feats[i] = _sketch_packet_step(tab, lam, state["evict_age"],
                                       rows["urow"][i], brow_o[i], brow_p[i],
                                       brow_s[i], ts[i], lens[i])
    return state, feats


@pytest.mark.parametrize("rows,evict_age", [(2, 0.0), (4, 0.5), (9, 0.5)])
def test_schedule_order_replay_is_bitwise(rows, evict_age):
    """Each key type's packets replayed in its schedule order through the
    plain per-packet step: that key type's feature columns and tables equal
    process_sketch's bit for bit."""
    pk = to_torch(_trace("ssh_bruteforce"), "cpu")
    width = 64
    st_p, f_p = process_sketch(_sketch(width, rows, evict_age), pk)
    idx, _ = kernel_rows(pk, rows, width)
    s = sketch_schedule_ref(idx, width)
    feat_cols = [range(0, 12), range(12, 24), range(24, 52), range(52, 80)]
    for kt in range(4):
        order = s["order"][kt]
        assert not torch.equal(order, torch.arange(N_PKTS, dtype=torch.int32))
        st_r, f_r = _replay(_sketch(width, rows, evict_age), pk, order)
        cols = list(feat_cols[kt])
        assert torch.equal(f_r[:, cols], f_p[:, cols]), kt
        g, k = ("uni", kt) if kt < 2 else ("bi", kt - 2)
        for name in st_p[g]:
            assert torch.equal(st_r[g][name][k], st_p[g][name][k]), (kt, name)


def test_schedule_empty_and_single_flow():
    idx = torch.zeros((4, 0, 2), dtype=torch.int32)
    s = sketch_schedule_ref(idx, 64)
    assert s["depth"] == [0] * 4 and s["rounds"] == [0] * 4
    assert s["level"].shape == s["order"].shape == (4, 0)
    assert all(rs.tolist() == [0] for rs in s["round_starts"])
    n = 300
    tr = _trace("mirai")
    one = {k: np.repeat(v[:1], n) for k, v in tr.items()}
    one["ts"] = np.arange(n, dtype=np.float32) * 0.01
    idx, _ = kernel_rows(to_torch(one, "cpu"), 2, 4096)
    s = sketch_schedule_ref(idx, 4096)
    ramp = torch.arange(1, n + 1, dtype=torch.int32)
    for kt in range(4):
        assert torch.equal(s["level"][kt], ramp)
        assert torch.equal(s["order"][kt], ramp - 1)
        assert s["depth"][kt] == s["rounds"][kt] == n
    _assert_schedule_shape(s, n, 2)


# ---------------------------------------------------------------------------
# single-key atom update
# ---------------------------------------------------------------------------
def _assert_single(got_tab, got, want_tab, want, msg=""):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got[:, :8], want[:, :8], err_msg=msg, **KERNEL_TOL)
    mu, sig_g, sig_w = want[:, 4:8], got[:, 8:], want[:, 8:]
    assert (np.abs(sig_g ** 2 - sig_w ** 2)
            <= CANCEL * (mu ** 2 + sig_w ** 2)).all(), msg
    for k in want_tab:
        np.testing.assert_allclose(got_tab[k].numpy(), np.asarray(want_tab[k]),
                                   err_msg=f"{msg} {k}", **KERNEL_TOL)


def _single_inputs(rng, n, n_slots, t0=0.0):
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    ts = np.sort(rng.uniform(t0, t0 + 5, n)).astype(np.float32)
    lens = rng.integers(60, 1500, n).astype(np.float32)
    return slots, ts, lens


@pytest.mark.parametrize("n,n_slots,chunk", [(100, 64, 32), (257, 128, 64),
                                             (512, 32, 256)])
def test_feature_update_plain_matches_jax(n, n_slots, chunk):
    rng = np.random.default_rng(n)
    tab = {f: np.zeros((n_slots, 4), np.float32) - (1.0 if f == "last_t" else 0.0)
           for f in ("last_t", "w", "ls", "ss")}
    slots, ts, lens = _single_inputs(rng, n, n_slots)
    jt = {k: jnp.asarray(v) for k, v in tab.items()}
    jargs = (jnp.asarray(slots), jnp.asarray(ts), jnp.asarray(lens))
    t_k, s_k = jax_ops.feature_update(jt, *jargs, chunk=chunk, interpret=True)
    t_r, s_r = jax_ref.feature_update_ref(jt, *jargs)
    reset_launch_counts()
    t_p, s_p = feature_update({k: torch.from_numpy(v.copy()) for k, v in tab.items()},
                              torch.from_numpy(slots), torch.from_numpy(ts),
                              torch.from_numpy(lens))
    assert not any(launch_counts().values())
    assert s_p.shape == (n, 12)
    _assert_single(t_p, s_p, t_k, s_k, "pallas")
    _assert_single(t_p, s_p, t_r, s_r, "ref")


def test_feature_update_warm_table_carries():
    """Three batches carried through the same table in place equal the JAX
    reference carried the same way."""
    rng = np.random.default_rng(0)
    n_slots = 64
    tab = {f: np.zeros((n_slots, 4), np.float32) - (1.0 if f == "last_t" else 0.0)
           for f in ("last_t", "w", "ls", "ss")}
    jt = {k: jnp.asarray(v) for k, v in tab.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in tab.items()}
    for r in range(3):
        slots, ts, lens = _single_inputs(rng, 150, n_slots, r * 5)
        jt, s_j = jax_ref.feature_update_ref(jt, jnp.asarray(slots),
                                             jnp.asarray(ts), jnp.asarray(lens))
        out, s_p = feature_update_ref(pt, torch.from_numpy(slots),
                                      torch.from_numpy(ts), torch.from_numpy(lens))
        assert out is pt
        _assert_single(pt, s_p, jt, s_j, f"batch {r}")


def test_round_size_past_a_warp():
    """A packet takes R lanes rounded up to a power of two, at most a warp:
    past 32 rows a round keeps 16 packets, and every R has its table
    stripe."""
    assert [round_size(r) for r in (1, 2, 3, 8, 9, 16, 17, 32, 33, 64, 1000)] == \
        [512, 256, 128, 64, 32, 32, 16, 16, 16, 16, 16]
    for r in (1, 9, 40, 1000, 32768):
        w = last_row_width(r)
        assert w >= 1 and w & (w - 1) == 0 and w * r <= 32768 < 2 * w * r


@pytest.mark.parametrize("n,n_slots,seed", [(300, 16, 0), (400, 1, 1),
                                            (500, 512, 2)])
def test_feature_update_phase_twin_equals_plain(n, n_slots, seed):
    """The single-key kernel's phases in PyTorch (decays per sorted position,
    the chain per (run, decay), then mu and sigma) equal the plain version
    bit for bit: many short runs, one run of every packet, then the same
    packets again onto the warm table."""
    rng = np.random.default_rng(seed)
    slots, ts, lens = (torch.from_numpy(a) for a in _single_inputs(rng, n, n_slots))

    def fresh():
        return {f: torch.full((n_slots, 4), -1.0 if f == "last_t" else 0.0)
                for f in ("last_t", "w", "ls", "ss")}

    t_p, t_t = fresh(), fresh()
    for _ in range(2):
        t_p, s_p = feature_update_ref(t_p, slots, ts, lens)
        out, s_t = feature_update_phases_ref(t_t, slots, ts, lens)
        assert out is t_t and torch.equal(s_t, s_p)
        for k in t_p:
            assert torch.equal(t_t[k], t_p[k]), k


if __name__ == "__main__":
    worst = {}
    cases = [(r, a) for r in (1, 2, 3) for a in sorted(ATTACKS)]
    for rows, attack in cases:
        tr = _trace(attack)
        _, f_j = jax_process_sketch(_jax_sketch(512, rows), _jax(tr))
        _, f_t = process_sketch(_sketch(512, rows), to_torch(tr, "cpu"))
        read = {**_readings(f_t.numpy(), np.asarray(f_j)),
                **{f"rows_{k}": v for k, v in
                   _pcc_readings(f_t.numpy(), np.asarray(f_j)).items()}}
        for k, v in read.items():
            key = (rows == 1, k)
            if key not in worst or v > worst[key][0]:
                worst[key] = (v, f"rows={rows}:{attack}")
    for (r1, k), (v, where) in sorted(worst.items()):
        print(f"{'rows=1' if r1 else 'rows>=2'} {k:18s} {float(v):.6g} at {where}")
