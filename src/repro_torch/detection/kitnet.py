"""KitNET (Kitsune's detector) in PyTorch (port of ``repro.detection.kitnet``).

Architecture (§3.4 of the Peregrine paper):
  * Feature Mapper — clusters the F features into k groups of size <= m by
    correlation distance (hierarchical clustering, as Kitsune's FM).
  * Ensemble layer — one small autoencoder per group
    (d -> ceil(0.75 d) -> d, sigmoid), inputs 0-1 normalised per feature.
  * Output layer — an autoencoder over the k ensemble RMSEs; the final
    anomaly score is its reconstruction RMSE.

Training is single-pass minibatched SGD with torch autograd, the same
objective, learning rate, batch and epochs as the JAX package (DESIGN.md
§3).  Initial weights come from an explicit ``torch.Generator``, so they
differ from the JAX package's for the same seed; ``train_kitnet(init=...)``
starts from given weights instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.cluster.hierarchy import linkage, to_tree

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kitnet_ae import (  # noqa: F401 (output_rmse re-exported)
    _normalize, kitnet_ensemble_ref, output_rmse, sigmoid,
)


# ---------------------------------------------------------------------------
# Feature mapper (numpy/scipy copy of the JAX package's)
# ---------------------------------------------------------------------------
def feature_map(train_feats: np.ndarray, max_size: int = 10) -> List[np.ndarray]:
    """Cluster feature indices by correlation distance; clusters <= max_size.

    Fewer than two features yield a single cluster; NaN/inf correlation
    distances (constant or empty traces) count as uncorrelated.
    """
    X = np.asarray(train_feats, np.float64)
    F = X.shape[1]
    if F < 2:
        return [np.arange(F, dtype=np.int32)] if F else []
    std = X.std(0)
    Xn = (X - X.mean(0)) / np.where(std > 1e-9, std, 1.0)
    corr = np.clip((Xn.T @ Xn) / max(X.shape[0], 1), -1.0, 1.0)
    dist = 1.0 - np.abs(corr)
    np.fill_diagonal(dist, 0.0)
    dist = np.clip(np.nan_to_num(dist, nan=1.0, posinf=1.0, neginf=1.0),
                   0.0, 1.0)
    iu = np.triu_indices(F, 1)
    Z = linkage(dist[iu], method="average")
    root = to_tree(Z)

    clusters: List[np.ndarray] = []

    def walk(node):
        ids = node.pre_order(lambda x: x.id)
        if len(ids) <= max_size or node.is_leaf():
            clusters.append(np.asarray(sorted(ids), np.int32))
        else:
            walk(node.left)
            walk(node.right)

    walk(root)
    return clusters


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KitNet:
    idx: torch.Tensor         # (k, m) int64 feature indices per AE (padded)
    mask: torch.Tensor        # (k, m) 1 for real slots
    params: Dict[str, torch.Tensor]
    norm_min: torch.Tensor    # (F,)
    norm_max: torch.Tensor    # (F,)
    out_min: torch.Tensor     # (k,) RMSE normalisation for the output AE
    out_max: torch.Tensor

    def __post_init__(self):
        # the scoring kernel reads idx unchecked: every index must name a
        # feature, checked once here rather than at each launch
        n_features = self.norm_min.shape[0]
        if self.idx.numel():
            lo, hi = int(self.idx.min()), int(self.idx.max())
            if lo < 0 or hi >= n_features:
                raise ValueError(f"KitNET idx must lie in [0, {n_features}), "
                                 f"got [{lo}, {hi}]")

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def to(self, device) -> "KitNet":
        """This net on ``device`` (itself when it lies there already)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return KitNet(idx=self.idx.to(device), mask=self.mask.to(device),
                      params={k: v.to(device) for k, v in self.params.items()},
                      **{f: getattr(self, f).to(device) for f in
                         ("norm_min", "norm_max", "out_min", "out_max")})


def _pad_clusters(clusters: List[np.ndarray]):
    k = len(clusters)
    m = max(len(c) for c in clusters)
    idx = np.zeros((k, m), np.int64)
    mask = np.zeros((k, m), np.float32)
    for i, c in enumerate(clusters):
        idx[i, :len(c)] = c
        mask[i, :len(c)] = 1.0
    return idx, mask


def init_kitnet(generator: torch.Generator, clusters: List[np.ndarray],
                n_features: int, hidden_ratio: float = 0.75,
                device: DeviceLike = None) -> KitNet:
    """Random initial weights drawn on the CPU from ``generator`` (so the
    same seed gives the same net on every device), then moved."""
    dev = resolve_device(device)
    idx, mask = _pad_clusters(clusters)
    k, m = idx.shape
    h = max(1, int(np.ceil(hidden_ratio * m)))
    kh = max(1, int(np.ceil(hidden_ratio * k)))
    s1, s2 = 1.0 / np.sqrt(m), 1.0 / np.sqrt(k)
    randn = lambda *shape: torch.randn(shape, generator=generator)
    params = {
        "W1": randn(k, m, h) * s1, "b1": torch.zeros(k, h),
        "W2": randn(k, h, m) * s1, "b2": torch.zeros(k, m),
        "V1": randn(k, kh) * s2, "c1": torch.zeros(kh),
        "V2": randn(kh, k) * s2, "c2": torch.zeros(k),
    }
    return KitNet(idx=torch.from_numpy(idx).to(dev),
                  mask=torch.from_numpy(mask).to(dev),
                  params={n: p.to(dev) for n, p in params.items()},
                  norm_min=torch.zeros(n_features, device=dev),
                  norm_max=torch.ones(n_features, device=dev),
                  out_min=torch.zeros(k, device=dev),
                  out_max=torch.ones(k, device=dev))


def ensemble_rmse(params, idx, mask, xb) -> torch.Tensor:
    """xb: (B, F) normalised features -> per-AE RMSE (B, k)."""
    return kitnet_ensemble_ref(xb[:, idx], params["W1"], params["b1"],
                               params["W2"], params["b2"], mask)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _sgd(params: Dict[str, torch.Tensor], loss_fn, batches: torch.Tensor,
         lr: float, epochs: int) -> Dict[str, torch.Tensor]:
    """Plain minibatched SGD, ``p <- p - lr * grad``, over ``batches``
    (nb, batch, ...) for ``epochs`` passes; returns detached params."""
    p = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
    for _ in range(epochs):
        for xb in batches:
            grads = torch.autograd.grad(loss_fn(p, xb), list(p.values()))
            with torch.no_grad():
                for t, g in zip(p.values(), grads):
                    t.sub_(lr * g)
    return {n: t.detach() for n, t in p.items()}


def train_kitnet(feats_train, seed: int = 0, max_size: int = 10,
                 lr: float = 0.05, batch: int = 256, epochs: int = 4,
                 md_backend: str = "einsum", device: DeviceLike = None,
                 init: Optional[KitNet] = None,
                 md_kw: Optional[Dict] = None) -> KitNet:
    """Fit FM + normalisation on the benign training records, then SGD.

    ``feats_train``: (n, F) records, numpy or a tensor (whose device is the
    default).  ``md_backend`` runs the training-set ensemble-RMSE pass (which
    fixes the output AE's normalisation and training data) through the
    backend used later for scoring, with its ensemble options ``md_kw``
    (e.g. ``{"design": "pair"}`` for ``cuda``).  ``init`` supplies the
    feature map and initial weights instead of ``feature_map`` +
    ``init_kitnet(seed)``.  SGD itself runs on the plain einsum graph (it
    needs gradients).
    """
    from repro_torch.detection.md_backends import (ensemble_rmse_records,
                                                   validate_md_options)
    md_kw = dict(md_kw or {})
    validate_md_options(md_backend, md_kw, stage="ensemble")
    if device is None and isinstance(feats_train, torch.Tensor):
        device = feats_train.device
    dev = resolve_device(device)
    X = torch.as_tensor(feats_train, dtype=torch.float32).to(dev)
    n, F = X.shape
    if init is None:
        clusters = feature_map(X.cpu().numpy(), max_size)
        init = init_kitnet(torch.Generator().manual_seed(seed), clusters, F,
                           device=dev)
    idx, mask = init.idx, init.mask
    lo, hi = X.min(0).values, X.max(0).values
    batch = max(1, min(batch, n))
    nb = max(1, n // batch)
    Xb = X[:nb * batch].reshape(nb, batch, F)

    def ens_loss(p, xb):
        sub = _normalize(xb, lo, hi)[:, idx] * mask[None]
        h = sigmoid(torch.einsum("bkm,kmh->bkh", sub, p["W1"]) + p["b1"][None])
        y = sigmoid(torch.einsum("bkh,khm->bkm", h, p["W2"]) + p["b2"][None])
        return torch.mean(((y - sub) ** 2) * mask[None])

    ens = _sgd({n_: init.params[n_] for n_ in ("W1", "b1", "W2", "b2")},
               ens_loss, Xb, lr, epochs)
    params = {**init.params, **ens}

    r_train = ensemble_rmse_records(params, idx, mask, _normalize(X, lo, hi),
                                    backend=md_backend, **md_kw)
    r_lo, r_hi = r_train.min(0).values, r_train.max(0).values
    rn = _normalize(r_train, r_lo, r_hi)
    Rb = rn[:nb * batch].reshape(nb, batch, rn.shape[1])

    def out_loss(p, rb):
        h = sigmoid(rb @ p["V1"] + p["c1"][None])
        y = sigmoid(h @ p["V2"] + p["c2"][None])
        return torch.mean((y - rb) ** 2)

    out = _sgd({n_: params[n_] for n_ in ("V1", "c1", "V2", "c2")},
               out_loss, Rb, lr, epochs)
    return KitNet(idx=idx, mask=mask, params={**params, **out},
                  norm_min=lo, norm_max=hi, out_min=r_lo, out_max=r_hi)


def score_kitnet(net: KitNet, feats) -> np.ndarray:
    """Anomaly RMSE score per record through the plain einsum path, on the
    net's device, as a host array (``detection.md_backends.score_records``
    selects backends by name)."""
    from repro_torch.detection.md_backends import score_records
    return score_records(net, feats, backend="einsum")
