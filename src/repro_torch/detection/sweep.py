"""Evaluation sweep (Figures 1/7/14/15): AUC and F1 across sampling rates
for Peregrine (record sampling after FC) against the Kitsune baseline
(raw-packet sampling before FC); port of ``repro.detection.sweep``.

Faithful protocol (§5.2/§5.4): the detector is trained on the benign prefix
*as seen by the deployed system*: Peregrine trains on feature records
sampled 1:x, the baseline on the packet-sampled stream.  Peregrine's
feature computation runs once per call; per-rate work is slicing and KitNET
training.  Everything runs on ``device`` (``cuda`` unless the caller asks
for another).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.core.backends import compute_features, default_backend
from repro_torch.core.records import epoch_indices
from repro_torch.core.state import init_state, state_device
from repro_torch.detection.kitnet import train_kitnet
from repro_torch.detection.md_backends import (default_md_backend,
                                               score_records,
                                               validate_md_options)
from repro_torch.detection.metrics import auc, f1_at_fpr
from repro_torch.detection.runner import take
from repro_torch.device import DeviceLike
from repro_torch.traffic.generator import to_torch


def _fc(trace: Dict, n_slots: int, mode: str, state: Optional[Dict] = None,
        backend: Optional[str] = None, state_backend: str = "dense",
        state_kw: Optional[Dict] = None, device: DeviceLike = None):
    st = state if state is not None else init_state(
        n_slots, state_backend=state_backend, device=device,
        **(state_kw or {}))
    if backend is None:
        backend = default_backend(mode)
    return compute_features(st, to_torch(trace, state_device(st)),
                            backend=backend, mode=mode)


def sweep_attack(data: Dict, rates: Iterable[int], n_slots: int = 8192,
                 mode: str = "switch", seed: int = 0,
                 min_train_records: int = 16, backend: Optional[str] = None,
                 md_backend: Optional[str] = None,
                 md_kw: Optional[Dict] = None,
                 state_backend: str = "dense",
                 state_kw: Optional[Dict] = None,
                 device: DeviceLike = None) -> Dict[str, Dict[int, Dict]]:
    """Returns {system: {rate: {auc, f1_fpr10, f1_fpr01, n_records,
    n_attack}}}.

    ``backend`` names the Peregrine FC implementation (serial/scan/cuda);
    ``md_backend`` the KitNET scoring implementation (einsum/cuda), with
    options in ``md_kw``, used for both systems.  ``state_backend``/``state_kw`` pick the Peregrine
    flow-table layout (dense slots or the Count-Min sketch); the Kitsune
    baseline always computes exact features over dense state, so a sketch
    sweep measures the accuracy cost of the compressed flow tables alone.
    """
    if md_backend is None:
        md_backend = default_md_backend()
    md_kw = dict(md_kw or {})
    validate_md_options(md_backend, md_kw)   # before any FC or training
    out = {"peregrine": {}, "kitsune": {}}

    # ---------------- Peregrine: FC over ALL packets, once ----------------
    st, f_train = _fc(data["train"], n_slots, mode, backend=backend,
                      state_backend=state_backend, state_kw=state_kw,
                      device=device)
    _, f_eval = _fc(data["eval"], n_slots, mode, state=st, backend=backend)
    ev_labels = data["eval"]["label"]
    for rate in rates:
        tr_idx = epoch_indices(len(f_train), rate)
        if len(tr_idx) < min_train_records:  # keep detector trainable
            tr_idx = epoch_indices(len(f_train), max(1, len(f_train) //
                                                     min_train_records))
        net = train_kitnet(take(f_train, tr_idx), seed=seed,
                           md_backend=md_backend, md_kw=md_kw)
        ev_idx = epoch_indices(len(f_eval), rate)
        scores = score_records(net, take(f_eval, ev_idx), backend=md_backend,
                               **md_kw)
        out["peregrine"][rate] = _metrics(scores, ev_labels[ev_idx])

    # ---------------- Kitsune baseline: packet sampling -------------------
    n_tr = len(data["train"]["ts"])
    for rate in rates:
        tr_idx = epoch_indices(n_tr, rate)
        ev_idx = epoch_indices(len(data["eval"]["ts"]), rate, offset=n_tr)
        tr_s = {k: v[tr_idx] for k, v in data["train"].items()}
        ev_s = {k: v[ev_idx] for k, v in data["eval"].items()}
        st, f_tr = _fc(tr_s, n_slots, "exact", device=device)
        if len(f_tr) < 4:   # cannot even fit normalisation: classifier dead
            out["kitsune"][rate] = _metrics(
                np.zeros(max(len(ev_idx), 1)), ev_s["label"]
                if len(ev_idx) else np.array([0, 1], np.uint8))
            continue
        net = train_kitnet(f_tr, seed=seed, md_backend=md_backend,
                           md_kw=md_kw)
        _, f_ev = _fc(ev_s, n_slots, "exact", state=st)
        scores = score_records(net, f_ev, backend=md_backend, **md_kw)
        out["kitsune"][rate] = _metrics(scores, ev_s["label"])
    return out


def _metrics(scores: np.ndarray, labels: np.ndarray) -> Dict:
    return {
        "auc": auc(scores, labels),
        "f1_fpr10": f1_at_fpr(scores, labels, 0.1),
        "f1_fpr01": f1_at_fpr(scores, labels, 0.01),
        "n_records": int(len(labels)),
        "n_attack": int(np.asarray(labels).sum()),
    }
