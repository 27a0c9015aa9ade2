"""PyTorch port, feature computation: the port's serial FC (the FC kernel's
plain version) against the JAX package's serial oracle on every attack
generator, and against its Pallas kernel in interpret mode; chunked carry;
and the FC registry, whose ``cuda``/``pallas`` names run the plain version
for CPU tensors without launching anything.

Tolerances.  State and the well-conditioned feature columns (w, mean,
magnitude) are held to the JAX package's envelope, rtol=1e-4, atol=1e-3
(tests/test_backends.py).  std and radius come from the variance
|E[x^2] - mu^2|, which cancels in float32: XLA's CPU exp2 differs from
PyTorch's in the last bit for many inputs and XLA contracts multiply-adds,
so the two packages' variances differ by a few ulps of E[x^2].  They are
held to that cancellation envelope, |a - b| <= K * 2^-23 * E[x^2] with
K = 32: on the variance for std (E[x^2] = mean^2 + std^2), and on radius
itself (the 2-norm of the two directions' variances, E[x^2] <= magnitude^2
+ radius).  cov and pcc get limits of their own.  Measured over the 15
attacks here and the Pallas kernel's three (float64 differences of the
float32 outputs): K = 10.64 for std and radius; cov needs atol 0.0061 at
rtol 1e-4 (limit 0.02); pcc, whose denominator std_o * std_p carries the
std noise, needs atol 0.0751 (limit 0.2), and at most 4 of a trace's 2048
pcc values leave the tight envelope (limit 10).  Print the readings with

    PYTHONPATH=src python tests/test_torch_fc.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compute_features as jax_compute_features
from repro.core import init_state as jax_init_state
from repro.kernels.ops import feature_update_full as jax_feature_update_full
from repro.traffic.generator import ATTACKS, benign_trace

from repro_torch.core import (FEATURE_NAMES, N_FEATURES, available_backends,
                              clone_state, compute_features, init_state,
                              process_serial, resolve_backend)
from repro_torch.core.pipeline import bi_step, flat_tables, packet_rows, uni_step
from repro_torch.core.state import LAMBDAS
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.feature_update import fc_phases_ref, fc_segments
from repro_torch.traffic import to_torch

torch.set_num_threads(1)

N_PKTS = 256
N_SLOTS = 512
TOL = dict(rtol=1e-4, atol=1e-3)

_KIND = np.array([nm.rsplit(":", 1)[1] for nm in FEATURE_NAMES])
_TIGHT = np.flatnonzero(~np.isin(_KIND, ["std", "radius", "cov", "pcc"]))


def _cols(kind, sibling=None):
    """Columns of ``kind`` and, if named, the same key type and decay's
    ``sibling`` columns."""
    own = np.flatnonzero(_KIND == kind)
    if sibling is None:
        return own
    return own, np.array([FEATURE_NAMES.index(
        FEATURE_NAMES[i].rsplit(":", 1)[0] + ":" + sibling) for i in own])


CANCEL_K = 32
COV_TOL = dict(rtol=1e-4, atol=0.02)
PCC_TOL = dict(rtol=1e-4, atol=0.2)
PCC_MAX_LOOSE = 10


def _trace(attack: str, seed: int = 0):
    """Benign background + one attack window, 256 packets (the JAX
    package's backend-parity traces)."""
    rng = np.random.default_rng(seed)
    ben = benign_trace(160, 6.0, rng)
    atk = ATTACKS[attack](120, 1.0, 5.0, rng)
    out = {k: np.concatenate([ben[k], atk[k]]) for k in ben}
    order = np.argsort(out["ts"], kind="stable")
    return {k: v[order][:N_PKTS] for k, v in out.items() if k != "label"}


def _jax(tr):
    return {k: jnp.asarray(v) for k, v in tr.items()}


def _readings(got, want) -> dict:
    """How far the port's features ``got`` lie from the JAX package's
    ``want``, per column kind, in the units the limits above use."""
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    eps = 2.0 ** -23
    std, mean = _cols("std", "mean")
    ex2 = want[:, mean] ** 2 + want[:, std] ** 2
    rad, mag = _cols("radius", "magnitude")
    cov, pcc = _cols("cov"), _cols("pcc")
    slack = lambda c: d[:, c] - 1e-4 * np.abs(want[:, c])   # atol needed
    return {
        "tight_atol": slack(_TIGHT).max(),
        "std_k": (np.abs(got[:, std] ** 2 - want[:, std] ** 2)
                  / (eps * ex2 + 1e-30)).max(),
        "radius_k": (d[:, rad] / (eps * (want[:, mag] ** 2 + want[:, rad])
                                  + 1e-30)).max(),
        "cov_atol": slack(cov).max(),
        "pcc_atol": slack(pcc).max(),
        "pcc_loose": int((slack(pcc) > TOL["atol"]).sum()),
    }


_LIMITS = {"tight_atol": TOL["atol"], "std_k": CANCEL_K, "radius_k": CANCEL_K,
           "cov_atol": COV_TOL["atol"], "pcc_atol": PCC_TOL["atol"],
           "pcc_loose": PCC_MAX_LOOSE}


def _assert_feats(got, want, msg=""):
    r = _readings(got, want)
    over = {k: v for k, v in r.items() if not v <= _LIMITS[k]}
    assert not over, (msg, over)


def _assert_state(got, want, msg=""):
    for g in want:
        for k in want[g]:
            np.testing.assert_allclose(got[g][k].numpy(), np.asarray(want[g][k]),
                                       err_msg=f"{msg} {g}/{k}", **TOL)


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_serial_matches_jax_serial(attack):
    tr = _trace(attack)
    st_j, f_j = jax_compute_features(jax_init_state(N_SLOTS), _jax(tr),
                                     backend="serial", mode="exact")
    st_t, f_t = process_serial(init_state(N_SLOTS, device="cpu"),
                               to_torch(tr, "cpu"))
    assert f_t.shape == (N_PKTS, N_FEATURES) and torch.isfinite(f_t).all()
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _assert_state(st_t, st_j, attack)


@pytest.mark.parametrize("attack", ["mirai", "arp_mitm", "ssh_bruteforce"])
def test_serial_matches_jax_pallas_kernel(attack):
    """The JAX package's Pallas FC kernel (interpret mode) is the kernel the
    CUDA one replaces; the port's plain version matches it too."""
    tr = _trace(attack)
    st_j, f_j = jax_feature_update_full(jax_init_state(N_SLOTS), _jax(tr),
                                        chunk=64, interpret=True)
    st_t, f_t = process_serial(init_state(N_SLOTS, device="cpu"),
                               to_torch(tr, "cpu"))
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    _assert_state(st_t, st_j, attack)


def test_chunked_carry_equals_one_shot():
    """State carried in place across chunks gives the one-shot result bit
    for bit (the per-packet arithmetic does not depend on the chunking)."""
    pk = to_torch(_trace("mirai"), "cpu")
    st1, f_once = process_serial(init_state(N_SLOTS, device="cpu"), pk)
    st2 = init_state(N_SLOTS, device="cpu")
    parts = []
    for i in range(0, N_PKTS, 100):
        st2, f = compute_features(st2, {k: v[i:i + 100] for k, v in pk.items()},
                                  backend="cuda")
        parts.append(f)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), f_once.numpy())
    for g in st1:
        for k in st1[g]:
            assert torch.equal(st1[g][k], st2[g][k]), (g, k)


def test_kernel_backend_on_cpu_runs_plain_version():
    """``backend="pallas"`` (alias of ``cuda``) on CPU tensors resolves to
    the plain version: identical output, no kernel launch."""
    pk = to_torch(_trace("syn_dos"), "cpu")
    st0 = init_state(N_SLOTS, device="cpu")
    reset_launch_counts()
    st_k, f_k = compute_features(clone_state(st0), pk, backend="pallas")
    _, f_s = compute_features(clone_state(st0), pk, backend="serial")
    assert launch_counts() == {"fc_full": 0, "kitnet_ae": 0, "kitnet_score": 0,
                               "sketch_update": 0, "feature_update": 0,
                               "flash_attention": 0}
    assert torch.equal(f_k, f_s)
    assert st_k["uni"]["w"].data_ptr() != st0["uni"]["w"].data_ptr()


def test_state_updated_in_place():
    st = init_state(N_SLOTS, device="cpu")
    before = st["bi"]["sr"].data_ptr()
    out, _ = compute_features(st, to_torch(_trace("mirai"), "cpu"))
    assert out is st and st["bi"]["sr"].data_ptr() == before
    assert (st["uni"]["w"] > 0).any()


def test_registry_names_aliases_and_errors():
    assert available_backends() == ("bucketed", "cuda", "scan", "serial",
                                    "sharded")
    assert resolve_backend("kernel") == "cuda"
    assert resolve_backend("pallas") == "cuda"
    assert resolve_backend("parallel") == "scan"
    for name in ("oracle", "nope"):
        with pytest.raises(ValueError, match="unknown FC backend"):
            resolve_backend(name)
    st = init_state(64, device="cpu")
    pk = to_torch(_trace("syn_dos"), "cpu")
    with pytest.raises(ValueError, match="unknown FC backend"):
        compute_features(st, pk, backend="nope")
    _, f = compute_features(init_state(64, device="cpu"), pk, backend="scan")
    assert f.shape == (N_PKTS, N_FEATURES)
    for name, kw in (("bucketed", {"buckets": 2}), ("sharded", {"shards": 2})):
        _, f = compute_features(init_state(64, device="cpu"), pk, backend=name,
                                **kw)
        assert f.shape == (N_PKTS, N_FEATURES)
    for name in ("cuda", "scan", "bucketed"):
        with pytest.raises(ValueError, match="serial"):
            compute_features(st, pk, backend=name, mode="switch")
    with pytest.raises(TypeError, match="chunk"):
        compute_features(st, pk, backend="pallas", chunk=64)
    with pytest.raises(TypeError, match="buckets"):
        compute_features(st, pk, backend="scan", buckets=4)


def test_empty_batch():
    st, f = compute_features(init_state(64, device="cpu"),
                             {k: v[:0] for k, v in to_torch(_trace("mirai"), "cpu").items()})
    assert f.shape == (0, N_FEATURES)


def test_fc_segments_are_stable_runs_per_key_type():
    """The kernel's segments: per key type, one run per table slot, packets
    in array order inside each run; bi runs key on the channel/socket slot
    (both directions), not on the direction row."""
    pk = to_torch(_trace("active_wiretap"), "cpu")
    rows = packet_rows(pk, N_SLOTS)
    skey, perm = fc_segments(rows, N_SLOTS)
    n = N_PKTS
    assert skey.dtype == torch.int32 and perm.numel() == 4 * n
    assert (skey[1:] >= skey[:-1]).all()
    kt = perm // n
    assert torch.equal(kt, (skey // N_SLOTS).long())
    same = skey[1:] == skey[:-1]
    assert (perm[1:][same] > perm[:-1][same]).all()       # array order
    i = perm % n
    want = torch.cat([rows["urow"].T, rows["bbase"].T + 2 * N_SLOTS])
    assert torch.equal(skey.long(), want.reshape(-1)[perm])
    # both directions of a channel share a segment
    bi = kt >= 2
    assert rows["dir"][i[bi]].unique().numel() == 2


def _segment_walk(state, pkts):
    """The FC kernel's decomposition, run in PyTorch on the CPU: every
    (key type, slot) segment walked alone, segments in sorted-key order,
    packets in sorted order within a segment — what one CUDA thread per
    segment does."""
    n_slots = state["uni"]["w"].shape[1]
    rows = packet_rows(pkts, n_slots)
    skey, perm = fc_segments(rows, n_slots)
    tab = flat_tables(state)
    lam = torch.tensor(LAMBDAS, dtype=torch.float32)
    ts, lens, dirb = pkts["ts"], pkts["length"], rows["dir"]
    n = ts.shape[0]
    feats = torch.full((n, N_FEATURES), float("nan"))
    for p in range(4 * n):
        key = int(skey[p])
        kt, i = key // n_slots, int(perm[p]) % n
        t, x = ts[i], lens[i]
        if kt < 2:
            feats[i, kt * 12:(kt + 1) * 12] = uni_step(
                tab, lam, torch.tensor([key]), t, x)
        else:
            base = key - 2 * n_slots
            d = int(dirb[i])
            c0 = 24 + (kt - 2) * 28
            feats[i, c0:c0 + 28] = bi_step(
                tab, lam, torch.tensor([2 * base + d]),
                torch.tensor([2 * base + 1 - d]), torch.tensor([base]), t, x)
    return state, feats


@pytest.mark.parametrize("attack", ["mirai", "arp_mitm", "active_wiretap",
                                    "ssh_bruteforce", "slowloris"])
def test_kernel_segment_walk_equals_serial(attack):
    """Walking the kernel's segments one by one reproduces the serial
    oracle bit for bit: features land in the oracle's columns, and the
    per-slot order (bi slots with both directions together) is all the
    serial order that matters."""
    pk = to_torch(_trace(attack), "cpu")
    st_s, f_s = process_serial(init_state(N_SLOTS, device="cpu"), pk)
    st_w, f_w = _segment_walk(init_state(N_SLOTS, device="cpu"), pk)
    assert not torch.isnan(f_w).any()
    assert torch.equal(f_w, f_s)
    for g in st_s:
        for k in st_s[g]:
            assert torch.equal(st_w[g][k], st_s[g][k]), (g, k)


# ---------------------------------------------------------------------------
# The kernel's phases in PyTorch (fc_phases_ref): the prelude's links and
# decays, the atom chains per (segment, direction, decay), the residuals, the
# SR chain and the features, each value by the oracle's operations
# ---------------------------------------------------------------------------
def _assert_bitwise(st_a, f_a, st_b, f_b, msg=""):
    assert torch.equal(f_a, f_b), (msg, float((f_a - f_b).abs().max()))
    for g in st_b:
        for k in st_b[g]:
            assert torch.equal(st_a[g][k], st_b[g][k]), (msg, g, k)


@pytest.mark.parametrize("attack", ["mirai", "arp_mitm", "active_wiretap",
                                    "ssh_bruteforce", "slowloris"])
def test_phase_twin_equals_serial(attack):
    """The phase decomposition reproduces the serial oracle bit for bit,
    features and every table, on the segment walk's five attacks."""
    pk = to_torch(_trace(attack), "cpu")
    st_s, f_s = process_serial(init_state(N_SLOTS, device="cpu"), pk)
    st_t, f_t = fc_phases_ref(init_state(N_SLOTS, device="cpu"), pk)
    _assert_bitwise(st_t, f_t, st_s, f_s, attack)


def _two_flows(n: int):
    """Two flows whose packets interleave, each flow's direction flipping
    packet by packet (a, b, a reversed, b reversed, ...)."""
    tr = _trace("mirai")
    flows = [{k: v[j] for k, v in tr.items()} for j in (0, 1)]
    assert (flows[0]["src"], flows[0]["dst"]) != (flows[1]["src"], flows[1]["dst"])
    out = {k: [] for k in tr}
    for i in range(n):
        f = dict(flows[i % 2])
        if (i // 2) % 2:
            f["src"], f["dst"] = f["dst"], f["src"]
            f["sport"], f["dport"] = f["dport"], f["sport"]
        f["ts"] = np.float32(i * 0.003)
        f["length"] = np.asarray(64 + 7 * i % 1400, dtype=tr["length"].dtype)
        for k in tr:
            out[k].append(f[k])
    return {k: np.asarray(v, dtype=tr[k].dtype) for k, v in out.items()}


def test_phase_twin_two_flows_alternating_directions():
    """Both directions of each bi slot in one segment, turn about: every
    packet's stale opposite row and last residual come from the packet just
    before it in its flow."""
    pk = to_torch(_two_flows(300), "cpu")
    assert pk["ts"].shape[0] == 300
    rows = packet_rows(pk, N_SLOTS)
    d = rows["dir"]
    assert bool((d[2:] != d[:-2]).all())          # each flow turns about
    st_s, f_s = process_serial(init_state(N_SLOTS, device="cpu"), pk)
    st_t, f_t = fc_phases_ref(init_state(N_SLOTS, device="cpu"), pk)
    _assert_bitwise(st_t, f_t, st_s, f_s)


def test_phase_twin_chunked_carry():
    """Chunks carried through the twin equal the oracle in one shot, and a
    second pass over the same packets (every row warm, times repeating)
    equals the oracle's second pass."""
    pk = to_torch(_trace("mirai"), "cpu")
    st_s, f_s = process_serial(init_state(N_SLOTS, device="cpu"), pk)
    st_t = init_state(N_SLOTS, device="cpu")
    parts = []
    for i in range(0, N_PKTS, 100):
        st_t, f = fc_phases_ref(st_t, {k: v[i:i + 100] for k, v in pk.items()})
        parts.append(f)
    _assert_bitwise(st_t, torch.cat(parts), st_s, f_s)
    st_s, f_s = process_serial(st_s, pk)
    st_t, f_t = fc_phases_ref(st_t, pk)
    _assert_bitwise(st_t, f_t, st_s, f_s)


def test_phase_twin_empty_batch():
    st = init_state(64, device="cpu")
    before = {g: {k: v.clone() for k, v in st[g].items()} for g in st}
    st, f = fc_phases_ref(st, {k: v[:0] for k, v in to_torch(_trace("mirai"), "cpu").items()})
    assert f.shape == (0, N_FEATURES)
    _assert_bitwise(st, f, before, f)


if __name__ == "__main__":
    worst = {}
    cases = [("serial", a) for a in sorted(ATTACKS)] + [
        ("pallas", a) for a in ("mirai", "arp_mitm", "ssh_bruteforce")]
    for ref, attack in cases:
        tr = _trace(attack)
        if ref == "serial":
            _, f_j = jax_compute_features(jax_init_state(N_SLOTS), _jax(tr),
                                          backend="serial", mode="exact")
        else:
            _, f_j = jax_feature_update_full(jax_init_state(N_SLOTS), _jax(tr),
                                             chunk=64, interpret=True)
        _, f_t = process_serial(init_state(N_SLOTS, device="cpu"),
                                to_torch(tr, "cpu"))
        for k, v in _readings(f_t.numpy(), np.asarray(f_j)).items():
            if k not in worst or v > worst[k][0]:
                worst[k] = (v, f"{ref}:{attack}")
    for k, (v, where) in worst.items():
        print(f"{k:11s} {float(v):.6g} (limit {_LIMITS[k]}) at {where}")
