"""MD (scoring) backend registry (port of ``repro.detection.md_backends``).

    scores = score_records(net, feats, backend="cuda")

Backends (per-record anomaly scores agree to ≤1e-5):

  * ``einsum`` — plain PyTorch: the ensemble as two batched einsums
    (detection/kitnet.py).  The training-time reference.
  * ``cuda``   — the hand-written kernels (kernels/kitnet_ae.py); aliases
    ``pallas`` and ``kernel``.  Scoring is one launch of
    ``csrc/kitnet_score.cu`` from records to scores (normalise, gather,
    ensemble, output AE: the JAX package's ``_score_pallas_jit``); the
    ensemble stage alone is ``csrc/kitnet_ae.cu``.  For CPU tensors both
    run their plain versions.

Each backend supplies the ensemble stage ``fn(params, idx, mask, xn) ->
(B, k)`` and a full scoring function, by default the plain stages built
around its ensemble; ``train_kitnet`` runs its training-set RMSE pass
through the same backend it scores with (DESIGN.md §3).

Options reach a backend as keywords (``md_kw`` in the service, the engine
and the runners).  A backend declares the options its scoring path takes
and those its ensemble stage takes, only the ones that reach its kernels;
any other raises ``TypeError``, so a misspelt option never measures the
default.  The ``cuda`` ensemble takes ``design=`` (``kitnet_ensemble``'s
``"tile"`` or ``"pair"``); its scoring kernel takes none, so ``design``
is refused wherever scoring would drop it.  The JAX package's Pallas
options ``bb`` and ``interpret`` have no counterpart here and are refused
like any unknown option.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.detection.kitnet import _normalize, ensemble_rmse, output_rmse
from repro_torch.kernels import kitnet_ae


class _MDBackend(NamedTuple):
    score: Callable      # fn(net, X (B,F) tensor, **options) -> (B,) scores
    ensemble: Callable   # fn(params, idx, mask, xn (B,F), **options) -> (B,k)
    options: frozenset   # options the scoring path takes
    ensemble_options: frozenset   # options the ensemble stage takes


_REGISTRY: Dict[str, _MDBackend] = {}

_ALIASES = {"pallas": "cuda", "kernel": "cuda"}


def _scorer(ensemble: Callable) -> Callable:
    """The full scoring path around one ensemble stage: normalise, the
    ensemble RMSEs, normalise those, then the output AE."""
    def score(net, X, **kw):
        xn = _normalize(X, net.norm_min, net.norm_max)
        r = ensemble(net.params, net.idx, net.mask, xn, **kw)
        return output_rmse(net.params, _normalize(r, net.out_min, net.out_max))
    return score


def register_md_backend(name: str, *, ensemble: Callable,
                        score: Optional[Callable] = None,
                        options: Tuple[str, ...] = (),
                        ensemble_options: Optional[Tuple[str, ...]] = None):
    """Register an MD backend by its ensemble stage and, optionally, its own
    scoring function (else the plain stages around the ensemble).

    ``options`` names the keyword options the scoring path takes,
    ``ensemble_options`` those the ensemble stage takes (by default the
    same); anything else passed raises ``TypeError``.
    """
    _REGISTRY[name] = _MDBackend(
        score=score or _scorer(ensemble), ensemble=ensemble,
        options=frozenset(options),
        ensemble_options=frozenset(options if ensemble_options is None
                                   else ensemble_options))


def validate_md_options(backend: str, kw: Dict, stage: str = "score") -> str:
    """Resolve ``backend`` and reject options its ``stage`` (``score``, the
    whole scoring path, or ``ensemble``) does not take."""
    name = resolve_md_backend(backend)
    b = _REGISTRY[name]
    accepted = b.options if stage == "score" else b.ensemble_options
    unknown = set(kw) - accepted
    if unknown:
        raise TypeError(
            f"MD backend {name!r} got unexpected {stage} options "
            f"{sorted(unknown)}; accepted: {sorted(accepted)}")
    return name


def available_md_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_md_backend(name: str) -> str:
    """Canonical MD backend name (alias-aware); raises on unknown names."""
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown MD backend {name!r}; "
                         f"available: {available_md_backends()}")
    return name


def default_md_backend() -> str:
    return "cuda"


def _ensemble_einsum(params, idx, mask, xn):
    return ensemble_rmse(params, idx, mask, xn)


def _ensemble_cuda(params, idx, mask, xn, design: str = "auto"):
    return kitnet_ae.kitnet_ensemble(xn[:, idx], params["W1"], params["b1"],
                                     params["W2"], params["b2"], mask,
                                     design=design)


def _score_cuda(net, X):
    p = net.params
    return kitnet_ae.kitnet_score(X, net.idx, net.mask, p["W1"], p["b1"],
                                  p["W2"], p["b2"], p["V1"], p["c1"], p["V2"],
                                  p["c2"], net.norm_min, net.norm_max,
                                  net.out_min, net.out_max)


register_md_backend("einsum", ensemble=_ensemble_einsum)
register_md_backend("cuda", ensemble=_ensemble_cuda, score=_score_cuda,
                    ensemble_options=("design",))


def md_score_fn(backend: str = "cuda", **kw) -> Callable:
    """The selected backend's scoring callable ``fn(net, X) -> (B,)``, with
    ``X`` a (B, F) tensor on the net's device; the result stays there.
    ``kw``: the backend's scoring options."""
    score = _REGISTRY[validate_md_options(backend, kw)].score
    return (lambda net, X: score(net, X, **kw)) if kw else score


def score_records(net, feats, backend: str = "cuda", **kw) -> np.ndarray:
    """Anomaly RMSE per feature record through the selected MD backend, as
    a host array.  Per-record scores do not depend on the batch."""
    score = md_score_fn(backend, **kw)
    X = torch.as_tensor(feats, dtype=torch.float32).to(net.device)
    with torch.no_grad():
        return score(net, X).cpu().numpy()


def ensemble_rmse_records(params, idx, mask, xn, backend: str = "cuda",
                          **kw) -> torch.Tensor:
    """The ensemble stage alone: normalised records (B, F) -> (B, k) RMSE.
    ``kw``: the backend's ensemble options (``design=`` for ``cuda``)."""
    name = validate_md_options(backend, kw, stage="ensemble")
    with torch.no_grad():
        return _REGISTRY[name].ensemble(params, idx, mask, xn, **kw)
