"""PyTorch port, KitNET: the ensemble's plain version against the JAX
package's Pallas kernel (interpret mode) and its einsum path, full scoring
with a JAX-fitted net carried across, bitwise batch independence, the
feature mapper, SGD from carried initial weights, and the MD registry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compute_features as jax_compute_features
from repro.core import init_state as jax_init_state
from repro.detection import kitnet as jk
from repro.detection import score_records as jax_score_records
from repro.kernels.ops import kitnet_ensemble as jax_kitnet_ensemble
from repro.traffic import ATTACKS, attack_trace, benign_trace, to_jnp

from repro_torch.detection import (available_md_backends, feature_map,
                                   resolve_md_backend, score_records,
                                   train_kitnet)
from repro_torch.detection.kitnet import ensemble_rmse
from repro_torch.interop import (KITNET_FIELDS, kitnet_from_arrays,
                                 kitnet_to_arrays)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.kitnet_ae import kitnet_ensemble, kitnet_ensemble_ref

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
    JAX-fitted net carried into the port: ≤1e-5 from the JAX einsum path."""
    feats = _feats(attack_trace(attack, 600, 0.0, 10.0, seed=1))
    want = np.asarray(jax_score_records(jax_net, feats, backend="einsum"))
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


def test_ensemble_rmse_is_plain_einsum(net):
    xn = torch.rand(50, 80, generator=torch.Generator().manual_seed(0))
    p = net.params
    want = kitnet_ensemble_ref(xn[:, net.idx], p["W1"], p["b1"], p["W2"],
                               p["b2"], net.mask)
    assert torch.equal(ensemble_rmse(p, net.idx, net.mask, xn), want)
