"""PyTorch port, the scan FC backend (``core/parallel.py``): segmented scans
against the port's serial oracle and against the JAX package's
``process_parallel``, its record-sampled path, and the service on it.

Tolerances.  A scan reassociates the decayed sums, so against the serial
oracle it is held to the JAX package's own scan envelope
(tests/test_backends.py): every non-pcc value within 1 + 1e-3 * |f|, at
least 99.5% of all values (pcc has near-zero denominators), state at
rtol 1e-3, atol 1.0.  Against the JAX package's scan (a different
association order, XLA's exp2 and multiply-add contraction) the features
are held to the per-kind limits of ``tests/test_torch_fc.py`` (the
port's serial oracle against JAX's): w, mean and magnitude at rtol 1e-4,
atol 1e-3; std and radius to the float32 cancellation envelope; cov and
pcc to their own atol.  Measured over the 15 attacks: std needs atol 0.59
and radius 1.01 at rtol 1e-4 (inside the envelope), cov 0.020, pcc 0.075;
the state within rtol 1e-4, atol 1.5e-3 (held at 1e-3 relative, atol 0.01).
The record-sampled path takes the same operations per row, so it equals
the full path's rows and state bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core import process_parallel as jax_process_parallel
from repro.traffic.generator import ATTACKS, benign_trace
from test_torch_fc import _assert_feats

from repro_torch.core import (FEATURE_NAMES, N_FEATURES, clone_state,
                              compute_features, init_state, process_parallel,
                              process_serial)
from repro_torch.core.backends import compute_features_sampled
from repro_torch.core.parallel import process_parallel_sampled
from repro_torch.interop import kitnet_from_arrays, kitnet_to_arrays
from repro_torch.serving import DetectionService
from repro_torch.traffic import synth_trace, to_torch

torch.set_num_threads(1)

N_PKTS = 256
N_SLOTS = 512
_PCC = [i for i, nm in enumerate(FEATURE_NAMES) if nm.endswith(":pcc")]
_NON_PCC = np.setdiff1d(np.arange(N_FEATURES), _PCC)
STATE_TOL = dict(rtol=1e-3, atol=1.0)
JAX_STATE_TOL = dict(rtol=1e-3, atol=0.01)


def _trace(attack: str, seed: int = 0, n: int = N_PKTS):
    """Benign background + one attack window (the JAX package's
    backend-parity traces)."""
    rng = np.random.default_rng(seed)
    ben = benign_trace(160, 6.0, rng)
    atk = ATTACKS[attack](120, 1.0, 5.0, rng)
    out = {k: np.concatenate([ben[k], atk[k]]) for k in ben}
    order = np.argsort(out["ts"], kind="stable")
    return {k: v[order][:n] for k, v in out.items() if k != "label"}


def _envelope(got: np.ndarray, want: np.ndarray, msg: str) -> float:
    ok = np.abs(got - want) <= 1.0 + 1e-3 * np.abs(want)
    assert ok[:, _NON_PCC].all(), msg
    assert ok.mean() >= 0.995, (msg, ok.mean())
    return float(ok.mean())


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_scan_matches_serial_in_jax_envelope(attack):
    pk = to_torch(_trace(attack), "cpu")
    st0 = init_state(N_SLOTS, device="cpu")
    st_s, f_s = process_serial(clone_state(st0), pk)
    st_p, f_p = compute_features(clone_state(st0), pk, backend="scan")
    assert f_p.shape == (N_PKTS, N_FEATURES) and torch.isfinite(f_p).all()
    _envelope(f_p.numpy(), f_s.numpy(), attack)
    for g in st_s:
        for k in st_s[g]:
            np.testing.assert_allclose(st_p[g][k].numpy(), st_s[g][k].numpy(),
                                       err_msg=f"{attack} {g}/{k}", **STATE_TOL)


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_scan_matches_jax_scan(attack):
    tr = _trace(attack)
    st_j, f_j = jax_process_parallel(jax_init_state(N_SLOTS),
                                     {k: jnp.asarray(v) for k, v in tr.items()})
    st_t, f_t = process_parallel(init_state(N_SLOTS, device="cpu"),
                                 to_torch(tr, "cpu"))
    _assert_feats(f_t.numpy(), np.asarray(f_j), attack)
    for g in st_t:
        for k in st_t[g]:
            np.testing.assert_allclose(st_t[g][k].numpy(), np.asarray(st_j[g][k]),
                                       err_msg=f"{attack} {g}/{k}", **JAX_STATE_TOL)


def test_scan_chained_batches_match_one_shot():
    """State carried across batches (JAX tests/test_core.py): >= 99.9% of
    values and every non-pcc value within the envelope of one shot."""
    pk = to_torch(_trace("mirai", seed=3, n=300), "cpu")
    _, f_once = process_parallel(init_state(256, device="cpu"), pk)
    st = init_state(256, device="cpu")
    parts = []
    for i in range(0, 300, 100):
        st, f = process_parallel(st, {k: v[i:i + 100] for k, v in pk.items()})
        parts.append(f)
    fa, fo = torch.cat(parts).numpy(), f_once.numpy()
    ok = np.abs(fa - fo) <= 1.0 + 1e-3 * np.abs(fo)
    assert ok.mean() >= 0.999 and ok[:, _NON_PCC].all(), ok.mean()


@pytest.mark.parametrize("attack", ["mirai", "ssdp_flood", "active_wiretap"])
def test_sampled_equals_full_then_gather(attack):
    """The record-sampled path: the full path's rows and state, bit for bit
    (also through the registry, and with repeated and unsorted rows)."""
    pk = to_torch(_trace(attack), "cpu")
    st0 = init_state(N_SLOTS, device="cpu")
    st_f, f_full = process_parallel(clone_state(st0), pk)
    for idx in (torch.arange(31, N_PKTS, 32), torch.tensor([200, 3, 3, 0, 255])):
        for fn in (process_parallel_sampled,
                   lambda s, p, i: compute_features_sampled(s, p, i, backend="scan")):
            st_s, f_s = fn(clone_state(st0), pk, idx)
            assert torch.equal(f_s, f_full[idx])
            for g in st_f:
                for k in st_f[g]:
                    assert torch.equal(st_s[g][k], st_f[g][k]), (g, k)
    st_e, f_e = process_parallel_sampled(clone_state(st0), pk,
                                         torch.zeros(0, dtype=torch.int64))
    assert f_e.shape == (0, N_FEATURES)
    assert torch.equal(st_e["bi"]["sr"], st_f["bi"]["sr"])


def test_scan_small_batches():
    """Empty and single-packet batches, and the one sort per key group."""
    from torch.profiler import profile
    pk = to_torch(_trace("syn_dos"), "cpu")
    st, f = process_parallel(init_state(64, device="cpu"),
                             {k: v[:0] for k, v in pk.items()})
    assert f.shape == (0, N_FEATURES)
    st1, f1 = process_parallel(init_state(64, device="cpu"),
                               {k: v[:1] for k, v in pk.items()})
    _, f1s = process_serial(init_state(64, device="cpu"),
                            {k: v[:1] for k, v in pk.items()})
    assert torch.equal(f1, f1s)
    with profile() as prof:
        process_parallel(init_state(64, device="cpu"), pk)
    sorts = sum(e.count for e in prof.key_averages() if e.key == "aten::sort")
    assert sorts == 2, sorts          # one for the uni keys, one for the bi


def test_service_scan_matches_cuda_backend():
    """The service on ``backend="scan"`` (fused step through the
    record-sampled path) against ``backend="cuda"`` (the FC kernel's plain
    version here) with one fitted net: equal record indices, scores within
    the scan envelope's effect on the records."""
    data = synth_trace("mirai", n_train=1024, n_benign_eval=512,
                       n_attack=512, seed=4)
    ref = DetectionService(epoch=64, n_slots=1024, device="cpu")
    ref.observe_stream(data["train"], chunk=256)
    ref.fit(seed=0, fpr=0.05)
    scan = DetectionService(epoch=64, n_slots=1024, backend="scan",
                            device="cpu", threshold=ref.threshold)
    assert scan.fused and scan.backend == "scan"
    scan.observe_stream(data["train"], chunk=256)
    scan.net = kitnet_from_arrays(kitnet_to_arrays(ref.net), device="cpu")
    i_r, s_r, _ = ref.process_stream(data["eval"], chunk=256)
    i_s, s_s, _ = scan.process_stream(data["eval"], chunk=256)
    np.testing.assert_array_equal(i_s, i_r)
    np.testing.assert_allclose(s_s, s_r, rtol=1e-3, atol=1e-4)
