"""PyTorch port, the four examples (``examples/*_torch.py``) on the CPU,
each through its ``main([..., "--device", "cpu"])`` at a small size, against
the JAX package where it has a counterpart.

  * quickstart: on a 3,000 / 1,500 / 1,500-packet mirai trace, with the
    JAX package's initial KitNET weights carried into the port, the record
    indices equal the JAX ``DetectionService``'s on the same trace, the
    scores and threshold within tests/test_torch_service.py's envelope
    (rtol 1e-3, atol 1e-4), the alarms equal away from the threshold and
    the AUC within 1e-3;
  * sampling_collapse: on a 1,024 / 512 / 512-packet ssdp_flood trace, with
    the JAX package's initial KitNET weights carried into the port (as
    tests/test_torch_eval.py carries them), each system's AUC at rates 1,
    64 and 256 within 1e-3 of JAX's ``sweep_attack`` at the same size,
    the record counts equal; the Kitsune baseline at rate 256 fits on 4
    packet-sampled records, where the clustering turns on float noise
    (tests/test_torch_eval.py), so it is held by its counts alone;
  * serve_lm: with the JAX package's reduced gemma2-2b parameters
    (``init_params(PRNGKey(0))``) carried into the port, every request
    returns the JAX ``ServeEngine``'s ``--max-new`` greedy tokens on the
    same prompts;
  * train_lm: a run stopped at step 10 and started again resumes there
    and ends, at step 30, within rtol 1e-5 / atol 1e-6 (the resume
    envelope of chip_smoke.py) of an uninterrupted 30-step run.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.detection import kitnet as jax_kitnet
from repro.detection.metrics import auc as jax_auc
from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.detection.sweep import sweep_attack as jax_sweep
from repro.models import build_model as jax_build_model
from repro.models.lm_engine import Request as JaxRequest
from repro.models.lm_engine import ServeEngine as JaxServeEngine
from repro.serving import DetectionService as JaxService
from repro.traffic import synth_trace
from repro_torch import tree
from repro_torch.detection import kitnet as port_kitnet
from repro_torch.interop import kitnet_from_arrays, lm_params_from_arrays

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
SCORE_TOL = dict(rtol=1e-3, atol=1e-4)
AUC_TOL = 1e-3
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_init(monkeypatch):
    """The port's ``init_kitnet`` replaced by the JAX package's, on the
    clusters the port's feature map found, carried over as arrays."""
    def init(generator, clusters, n_features, hidden_ratio=0.75, device=None):
        net = jax_kitnet.init_kitnet(jax.random.PRNGKey(generator.initial_seed()),
                                     clusters, n_features, hidden_ratio)
        arrays = {"idx": net.idx, "mask": net.mask, **net.params,
                  "norm_min": net.norm_min, "norm_max": net.norm_max,
                  "out_min": net.out_min, "out_max": net.out_max}
        return kitnet_from_arrays({k: np.array(v) for k, v in arrays.items()},
                                  device=device)
    monkeypatch.setattr(port_kitnet, "init_kitnet", init)


def test_quickstart_matches_jax_service(jax_init, capsys):
    got = _example("quickstart").main(["--n-train", "3000", "--n-benign-eval", "1500",
                                       "--n-attack", "1500", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "attack-record AUC" in out
    data = synth_trace("mirai", n_train=3000, n_benign_eval=1500, n_attack=1500, seed=0)
    svc = JaxService(epoch=256, n_slots=8192, mode="exact")
    svc.observe_stream(data["train"], chunk=4096)
    svc.fit(fpr=0.01)
    start = svc.pkt_count
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=4096)
    np.testing.assert_array_equal(got["idx"], idx)
    np.testing.assert_allclose(got["threshold"], svc.threshold, **SCORE_TOL)
    np.testing.assert_allclose(got["scores"], scores, **SCORE_TOL)
    near = np.abs(scores - svc.threshold) <= SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(scores)
    np.testing.assert_array_equal(got["alarms"][~near], np.asarray(alarms)[~near])
    want = jax_auc(scores, data["eval"]["label"][idx - start])
    assert abs(got["auc"] - want) <= AUC_TOL, (got["auc"], want)


def test_sampling_collapse_matches_jax_sweep(jax_init, capsys):
    got = _example("sampling_collapse").main(["--n-train", "1024", "--n-benign-eval", "512",
                                              "--n-attack", "512", "--device", "cpu"])
    assert "Peregrine AUC" in capsys.readouterr().out
    data = synth_trace("ssdp_flood", n_train=1024, n_benign_eval=512, n_attack=512, seed=0)
    want = jax_sweep(data, rates=(1, 64, 256), mode="switch")
    for system in ("peregrine", "kitsune"):
        for rate in (1, 64, 256):
            g, w = got[system][rate], want[system][rate]
            assert (g["n_records"], g["n_attack"]) == (w["n_records"], w["n_attack"])
            if (system, rate) != ("kitsune", 256):
                assert abs(g["auc"] - w["auc"]) <= AUC_TOL, (system, rate, g, w)


def test_serve_lm_matches_jax_engine(monkeypatch, capsys):
    jcfg = jax_reduced(jax_get_arch("gemma2-2b"))
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    arrays = jax.tree_util.tree_map(np.asarray, jp)
    mod = _example("serve_lm")
    build = mod.build_model

    def with_jax_params(cfg, device=None):
        m = build(cfg, device=device)
        return dataclasses.replace(
            m, init_params=lambda seed: lm_params_from_arrays(cfg, arrays, device=device))
    monkeypatch.setattr(mod, "build_model", with_jax_params)
    got = mod.main(["--requests", "5", "--slots", "2", "--max-new", "7", "--device", "cpu"])
    assert "5 requests, 35 tokens" in capsys.readouterr().out

    engine = JaxServeEngine(jm, jp, batch_slots=2, max_seq=128)
    rng = np.random.default_rng(0)
    for rid in range(5):
        engine.submit(JaxRequest(rid=rid, prompt=jnp.asarray(
            rng.integers(1, jcfg.vocab, 16), jnp.int32), max_new=7))
    want = {rid: [int(t) for t in toks] for rid, toks in engine.run().items()}
    assert all(len(toks) == 7 for toks in want.values())
    assert {rid: [int(t) for t in toks] for rid, toks in got["outputs"].items()} == want


def test_train_lm_resumes_where_it_stopped(tmp_path, capsys):
    train = _example("train_lm").main
    size = ["--batch", "2", "--seq", "32", "--device", "cpu"]
    first = train(["--steps", "10", "--ckpt-dir", str(tmp_path / "a"), *size])
    resumed = train(["--steps", "30", "--ckpt-dir", str(tmp_path / "a"), *size])
    whole = train(["--steps", "30", "--ckpt-dir", str(tmp_path / "b"), *size])
    out = capsys.readouterr().out
    assert (first["start"], resumed["start"], whole["start"]) == (0, 10, 0)
    assert out.count("resumed from checkpoint at step 10") == 1
    assert int(resumed["state"]["step"]) == int(whole["state"]["step"]) == 30
    for a, b in zip(tree.leaves(resumed["state"]), tree.leaves(whole["state"])):
        torch.testing.assert_close(a, b, **RESUME_TOL)
    assert np.isfinite(resumed["loss"]) and abs(resumed["loss"] - whole["loss"]) <= 1e-5
