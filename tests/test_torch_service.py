"""PyTorch port, the slice as a whole: the detection service against the JAX
package's service on the same traces.

Tolerances.  With the JAX-fitted net, threshold and flow state carried into
the port, the record indices are equal and the scores agree to rtol=1e-3,
atol=1e-4: the scores differ only through the std/radius/cov/pcc feature
columns, whose float32 variance cancellation moves them by O(0.1) on
O(1e6) second moments (tests/test_torch_fc.py); after the min-max
normalisation over the training range that is at most ~1e-3 relative
(about 1e-4 measured).  Alarms are therefore equal except for records whose
score lies within that tolerance of the threshold.  The port's own fit
starts from its own random initial weights, so its AUC is held to a margin
of 0.05 of the JAX package's on an attack both detect (syn_dos); on harder
attacks the spread between initialisations is larger.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving import DetectionService as JaxService
from repro.traffic import synth_trace

from repro_torch.core import clone_state
from repro_torch.detection.metrics import auc
from repro_torch.interop import kitnet_from_arrays, state_from_arrays
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.serving import DetectionService

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=1e-3, atol=1e-4)


def _net_arrays(net):
    d = {"idx": net.idx, "mask": net.mask, **net.params,
         "norm_min": net.norm_min, "norm_max": net.norm_max,
         "out_min": net.out_min, "out_max": net.out_max}
    return {k: np.array(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def fitted():
    """A JAX service (serial FC) fitted on a mirai trace, its eval window's
    results, and everything needed to carry it into the port."""
    data = synth_trace("mirai", n_train=1024, n_benign_eval=512,
                       n_attack=512, seed=4)
    js = JaxService(epoch=64, n_slots=1024, backend="serial")
    js.observe_stream(data["train"], chunk=256)
    js.fit(fpr=0.05)
    carried = {"net": _net_arrays(js.net), "threshold": js.threshold,
               "state": jax.tree_util.tree_map(np.array, js.state),
               "pkt_count": js.pkt_count}
    want = js.process_stream(data["eval"], chunk=256)
    return data, carried, want


def _port(carried) -> DetectionService:
    svc = DetectionService(epoch=64, n_slots=1024, device="cpu",
                           threshold=carried["threshold"])
    svc.net = kitnet_from_arrays(carried["net"], device="cpu")
    svc.state = state_from_arrays(carried["state"], device="cpu")
    svc.pkt_count = carried["pkt_count"]
    return svc


def test_process_stream_matches_jax(fitted):
    data, carried, (j_idx, j_scores, j_alarms) = fitted
    svc = _port(carried)
    reset_launch_counts()
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=256)
    assert launch_counts() == {"fc_full": 0, "kitnet_ae": 0, "kitnet_score": 0,
                               "sketch_update": 0, "feature_update": 0,
                               "flash_attention": 0}
    assert len(idx) == len(data["eval"]["ts"]) // 64
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(scores, j_scores, **SCORE_TOL)
    near = np.abs(j_scores - carried["threshold"]) <= (
        SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(j_scores))
    np.testing.assert_array_equal(alarms[~near], j_alarms[~near])


def test_chunked_equals_one_batch_and_staged(fitted):
    """Chunked streaming (chunks straddling epoch boundaries, state carried
    in place) equals one batch, and the staged path equals the fused one,
    bit for bit."""
    data, carried, _ = fitted
    svc = _port(carried)
    st0, c0 = clone_state(svc.state), svc.pkt_count
    one = svc.process(data["eval"])
    svc.state, svc.pkt_count = clone_state(st0), c0
    chunked = svc.process_stream(data["eval"], chunk=200)
    svc.state, svc.pkt_count = clone_state(st0), c0
    staged = svc.process_stream(data["eval"], chunk=200, fused=False)
    for a, b, c in zip(one, chunked, staged):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_own_fit_auc_close_to_jax():
    data = synth_trace("syn_dos", n_train=4096, n_benign_eval=1024,
                       n_attack=1024, seed=0)
    aucs = []
    for svc in (JaxService(epoch=32, n_slots=1024, backend="scan"),
                DetectionService(epoch=32, n_slots=1024, device="cpu")):
        svc.observe_stream(data["train"], chunk=1024)
        svc.fit(seed=0, fpr=0.05)
        base = svc.pkt_count
        idx, scores, _ = svc.process_stream(data["eval"], chunk=1024)
        aucs.append(auc(scores, data["eval"]["label"][idx - base]))
    assert aucs[0] > 0.9 and abs(aucs[1] - aucs[0]) <= 0.05, aucs


def test_service_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionService()


def test_unported_options_raise():
    svc = DetectionService(device="cpu", mode="switch")
    assert svc.backend == "serial" and not svc.fused
    with pytest.raises(ValueError, match="unknown state backend"):
        DetectionService(device="cpu", state_backend="bloom")
    assert DetectionService(device="cpu", backend="scan").backend == "scan"
    svc = DetectionService(device="cpu", backend="bucketed", buckets=8)
    assert svc.backend_kw == {"buckets": 8} and svc.fused
    svc = DetectionService(device="cpu", mode="switch", backend="sharded",
                           shards=4)
    assert svc.backend == "sharded" and not svc.fused
    with pytest.raises(ValueError, match="serial"):
        DetectionService(device="cpu", mode="switch", backend="cuda")
    with pytest.raises(TypeError, match="chunk"):
        DetectionService(device="cpu", chunk=64)
    with pytest.raises(TypeError, match="buckets"):
        DetectionService(device="cpu", backend="scan", buckets=4)
    # the JAX package's Pallas MD options have no counterpart; the cuda
    # ensemble's design= does not reach its scoring kernel
    for md_kw in ({"bb": 64}, {"interpret": True}, {"design": "tile"}):
        with pytest.raises(TypeError, match=next(iter(md_kw))):
            DetectionService(device="cpu", md_kw=md_kw)
    svc = DetectionService(device="cpu", n_slots=64)
    with pytest.raises(RuntimeError, match="fit"):
        svc.process({"ts": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="no training records"):
        svc.fit()


def _serve(capsys, *args) -> dict:
    import json
    import sys
    from repro_torch.launch import serve
    argv = sys.argv
    sys.argv = ["serve", "--device", "cpu", *args]
    try:
        serve.main()
    finally:
        sys.argv = argv
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_launcher_on_cpu(capsys):
    out = _serve(capsys, "--attack", "syn_dos", "--n-train", "1500",
                 "--n-eval", "1000", "--epoch", "64", "--n-slots", "512",
                 "--chunk", "500")
    assert out["device"] == "cpu" and out["records"] == 2500 // 64 - 1500 // 64
    assert out["launches"] == {"fc_full": 0, "kitnet_ae": 0, "kitnet_score": 0,
                               "sketch_update": 0, "feature_update": 0,
                               "flash_attention": 0}


def test_serve_launcher_switch_mode_on_cpu(capsys):
    out = _serve(capsys, "--fc-mode", "switch", "--attack", "syn_dos",
                 "--n-train", "300", "--n-eval", "200", "--epoch", "16",
                 "--n-slots", "256", "--chunk", "128")
    assert out["device"] == "cpu" and out["records"] == 500 // 16 - 300 // 16
    assert out["fc_mode"] == "switch" and np.isfinite(out["auc"])
    assert set(out["launches"].values()) == {0}
