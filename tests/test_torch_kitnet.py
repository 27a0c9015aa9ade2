"""PyTorch port, KitNET: the ensemble's plain version against the JAX
package's Pallas kernel (interpret mode) and its einsum path, full scoring
(the scoring kernel's plain version among it) with a JAX-fitted net carried
across against the JAX package's einsum and Pallas scoring, bitwise batch
independence, the feature mapper, SGD from carried initial weights, and the
MD registry with its fused scoring path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compute_features as jax_compute_features
from repro.core import init_state as jax_init_state
from repro.detection import kitnet as jk
from repro.detection import md_backends as jmd
from repro.detection import score_records as jax_score_records
from repro.kernels.ops import kitnet_ensemble as jax_kitnet_ensemble
from repro.traffic import ATTACKS, attack_trace, benign_trace, to_jnp

from repro_torch.detection import (available_md_backends, feature_map,
                                   md_score_fn, resolve_md_backend,
                                   score_records, train_kitnet)
from repro_torch.detection.kitnet import ensemble_rmse
from repro_torch.interop import (KITNET_FIELDS, kitnet_from_arrays,
                                 kitnet_to_arrays)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import kitnet_ae
from repro_torch.kernels.kitnet_ae import (kitnet_ensemble, kitnet_ensemble_ref,
                                           kitnet_score, kitnet_score_ref)

torch.set_num_threads(1)

N_SLOTS = 2048
MD_TOL = dict(atol=1e-5, rtol=1e-5)


def _feats(trace):
    _, f = jax_compute_features(jax_init_state(N_SLOTS), to_jnp(trace),
                                backend="scan")
    return np.asarray(f)


def _arrays(net: jk.KitNet):
    """A JAX KitNet as the numpy dict the port's interop takes."""
    d = {"idx": net.idx, "mask": net.mask, **net.params,
         "norm_min": net.norm_min, "norm_max": net.norm_max,
         "out_min": net.out_min, "out_max": net.out_max}
    return {k: np.array(v) for k, v in d.items()}


def _score_args(net):
    """A port KitNet as kitnet_score's arguments after X."""
    p = net.params
    return (net.idx, net.mask, p["W1"], p["b1"], p["W2"], p["b2"], p["V1"],
            p["c1"], p["V2"], p["c2"], net.norm_min, net.norm_max,
            net.out_min, net.out_max)


@pytest.fixture(scope="module")
def train_feats():
    """About 1.5k benign feature records."""
    return _feats(benign_trace(1500, 8.0, np.random.default_rng(0)))


@pytest.fixture(scope="module")
def jax_net(train_feats):
    return jk.train_kitnet(train_feats, seed=0)


@pytest.fixture(scope="module")
def net(jax_net):
    return kitnet_from_arrays(_arrays(jax_net), device="cpu")


def test_ensemble_plain_matches_jax_kernel_and_einsum(jax_net, train_feats):
    xn = jk._normalize(jnp.asarray(train_feats[:300]) * 1.3,
                       jax_net.norm_min, jax_net.norm_max)
    p = jax_net.params
    want_kernel = np.asarray(jax_kitnet_ensemble(
        xn[:, jax_net.idx], p["W1"], p["b1"], p["W2"], p["b2"], jax_net.mask,
        bb=64, interpret=True))
    want_einsum = np.asarray(jk.ensemble_rmse(p, jax_net.idx, jax_net.mask, xn))
    t = {k: torch.from_numpy(v) for k, v in _arrays(jax_net).items()}
    sub = torch.from_numpy(np.array(xn))[:, t["idx"].long()]
    args = (t["W1"], t["b1"], t["W2"], t["b2"], t["mask"])
    got_ref = kitnet_ensemble_ref(sub, *args).numpy()
    reset_launch_counts()
    got_wrapper = kitnet_ensemble(sub, *args).numpy()
    assert launch_counts()["kitnet_ae"] == 0
    np.testing.assert_allclose(got_ref, want_kernel, **MD_TOL)
    np.testing.assert_allclose(got_ref, want_einsum, **MD_TOL)
    np.testing.assert_array_equal(got_wrapper, got_ref)


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_scores_match_jax_with_carried_net(jax_net, net, attack):
    """Full scoring (normalise, gather, ensemble, output AE) with the
    JAX-fitted net carried into the port: both backends and the scoring
    kernel's plain version ≤1e-5 from the JAX einsum path (``kitnet._score``)
    and from its Pallas path (``md_backends._score_pallas_jit``, interpret
    mode)."""
    feats = _feats(attack_trace(attack, 600, 0.0, 10.0, seed=1))
    want = np.asarray(jax_score_records(jax_net, feats, backend="einsum"))
    n = jax_net
    want_pallas = np.asarray(jmd._score_pallas_jit(
        n.params, n.idx, n.mask, n.norm_min, n.norm_max, n.out_min,
        n.out_max, jnp.asarray(feats), bb=128, interpret=True))
    got_ref = kitnet_score_ref(torch.tensor(feats), *_score_args(net)).numpy()
    assert np.isfinite(got_ref).all()
    np.testing.assert_allclose(got_ref, want, err_msg="plain", **MD_TOL)
    np.testing.assert_allclose(got_ref, want_pallas, err_msg="pallas", **MD_TOL)
    for backend in ("cuda", "einsum"):
        got = score_records(net, feats, backend=backend)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, err_msg=backend, **MD_TOL)


@pytest.mark.parametrize("backend", ["cuda", "einsum"])
def test_scores_batch_independent_bitwise(net, backend):
    """Per-record scores do not depend on batch composition, so per-chunk
    streaming scoring is exact (the property the JAX package's Pallas MD
    path loses, tests/test_md_backends.py)."""
    feats = _feats(attack_trace("mirai", 400, 0.0, 10.0, seed=2))
    one = score_records(net, feats, backend=backend)
    chunked = np.concatenate([score_records(net, feats[i:i + 37], backend=backend)
                              for i in range(0, len(feats), 37)])
    np.testing.assert_array_equal(one, chunked)


def test_cuda_backend_on_cpu_is_the_plain_score_bitwise(net):
    """On CPU tensors the cuda backend's scores are the scoring kernel's
    plain version bit for bit, and no kernel launches."""
    feats = _feats(attack_trace("syn_dos", 300, 0.0, 10.0, seed=4))
    want = kitnet_score_ref(torch.tensor(feats), *_score_args(net)).numpy()
    reset_launch_counts()
    got = score_records(net, feats, backend="cuda")
    assert sum(launch_counts().values()) == 0
    np.testing.assert_array_equal(got, want)


def test_md_score_fn_cuda_is_one_fused_call(net, monkeypatch):
    """``md_score_fn("cuda")`` scores through one ``kitnet_score`` call and
    never calls the ensemble wrapper; ``einsum`` calls neither wrapper."""
    calls = []

    def spy(name):
        real = getattr(kitnet_ae, name)

        def wrapped(*a):
            calls.append(name)
            return real(*a)
        monkeypatch.setattr(kitnet_ae, name, wrapped)

    spy("kitnet_score")
    spy("kitnet_ensemble")
    X = torch.rand(8, 80, generator=torch.Generator().manual_seed(1))
    md_score_fn("cuda")(net, X)
    assert calls == ["kitnet_score"]
    calls.clear()
    md_score_fn("einsum")(net, X)
    assert calls == []


def test_wrappers_reject_devices_other_than_cpu_and_cuda(net):
    X = torch.rand(4, 80, device="meta")
    args = tuple(t.to("meta") for t in _score_args(net))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kitnet_score(X, *args)
    p = net.params
    with pytest.raises(ValueError, match="cpu or cuda"):
        kitnet_ensemble(X[:, net.idx.to("meta")], *(t.to("meta") for t in (
            p["W1"], p["b1"], p["W2"], p["b2"], net.mask)))


def test_feature_map_identical_clusters(train_feats):
    want = jk.feature_map(train_feats, 10)
    got = feature_map(train_feats, 10)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    single = feature_map(train_feats[:, :1])
    assert len(single) == 1 and np.array_equal(single[0], [0])


def test_sgd_from_carried_init_tracks_jax(train_feats, jax_net):
    """SGD started from the JAX package's initial weights ends near the JAX
    package's trained weights.  The two frameworks order their float32
    gradient sums differently, and 4 epochs x 5 steps compound that, so
    parameters agree to 1e-4 absolute (the weights are O(0.3)); the
    output-AE bounds, computed from those weights, to 1e-4 as well."""
    clusters = jk.feature_map(train_feats, 10)
    init = jk.init_kitnet(jax.random.PRNGKey(0), clusters, train_feats.shape[1])
    got = train_kitnet(train_feats, init=kitnet_from_arrays(_arrays(init), "cpu"),
                       md_backend="einsum", device="cpu")
    got_a, want_a = kitnet_to_arrays(got), _arrays(jax_net)
    for k in KITNET_FIELDS:
        np.testing.assert_allclose(got_a[k], want_a[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_own_training_scores_benign_low(train_feats):
    """The port's own fit (its own random init) gives a working detector:
    finite scores, and benign training records mostly below attack ones."""
    net = train_kitnet(train_feats, seed=0, device="cpu", md_backend="cuda")
    ben = score_records(net, train_feats)
    atk = score_records(net, _feats(attack_trace("syn_dos", 600, 0.0, 10.0, seed=1)))
    assert np.isfinite(ben).all() and np.isfinite(atk).all()
    assert np.median(atk) > np.median(ben)


def test_registry_and_options(net):
    assert available_md_backends() == ("cuda", "einsum")
    for alias in ("pallas", "kernel"):
        assert resolve_md_backend(alias) == "cuda"
    for name in ("nope", "fused", "batched"):
        with pytest.raises(ValueError, match="unknown MD backend"):
            resolve_md_backend(name)
    feats = np.zeros((4, 80), np.float32)
    with pytest.raises(TypeError, match="bb"):
        score_records(net, feats, backend="cuda", bb=256)
    assert score_records(net, feats, backend="pallas").shape == (4,)


def test_interop_round_trip(jax_net):
    d = _arrays(jax_net)
    back = kitnet_to_arrays(kitnet_from_arrays(d, device="cpu"))
    assert set(back) == set(KITNET_FIELDS)
    for k in KITNET_FIELDS:
        np.testing.assert_array_equal(back[k], d[k].astype(back[k].dtype))
    with pytest.raises(KeyError):
        kitnet_from_arrays({"idx": d["idx"]}, device="cpu")
    with pytest.raises(ValueError, match="idx must lie in"):
        kitnet_from_arrays({**d, "idx": d["idx"] + len(d["norm_min"])}, device="cpu")


@pytest.mark.parametrize("shift", ["past_features", "negative"])
def test_kitnet_rejects_idx_outside_features(net, shift):
    """A KitNet whose feature indices leave [0, F) is refused where it is
    built (the scoring kernel reads idx unchecked), before any scoring;
    one index out of range is enough."""
    F = net.norm_min.shape[0]
    bad = net.idx.clone()
    bad[-1, 0] = F if shift == "past_features" else -1
    with pytest.raises(ValueError, match="idx must lie in"):
        dataclasses.replace(net, idx=bad)
    with pytest.raises(ValueError, match="idx must lie in"):
        dataclasses.replace(net, norm_min=net.norm_min[:int(net.idx.max())],
                            norm_max=net.norm_max[:int(net.idx.max())])


def test_ensemble_design_must_be_known(net):
    """``design`` is validated on every device, though the plain version
    (CPU tensors) has one design."""
    x = torch.rand(4, *net.idx.shape)
    p = net.params
    args = (p["W1"], p["b1"], p["W2"], p["b2"], net.mask)
    for design in ("auto", "tile", "pair"):
        assert torch.equal(kitnet_ensemble(x, *args, design=design),
                           kitnet_ensemble_ref(x, *args))
    with pytest.raises(ValueError, match="design must be one of"):
        kitnet_ensemble(x, *args, design="serial")


def test_ensemble_rmse_is_plain_einsum(net):
    xn = torch.rand(50, 80, generator=torch.Generator().manual_seed(0))
    p = net.params
    want = kitnet_ensemble_ref(xn[:, net.idx], p["W1"], p["b1"], p["W2"],
                               p["b2"], net.mask)
    assert torch.equal(ensemble_rmse(p, net.idx, net.mask, xn), want)
