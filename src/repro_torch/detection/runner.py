"""End-to-end detection runners: Peregrine against the Kitsune-style
baseline (port of ``repro.detection.runner``).

The two systems differ ONLY in where sampling happens (Figure 3):

  Peregrine: FC on ALL packets (data plane) -> sample feature RECORDS 1:x
  Kitsune:   sample raw PACKETS 1:x -> FC on the sampled packets only

Both feed the same KitNET.  ``mode`` selects exact or switch arithmetic for
the Peregrine data plane (the baseline always computes exact statistics in
software, as the real Kitsune does).  Both run on ``device`` (``cuda``
unless the caller asks for another).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends import compute_features, default_backend
from repro_torch.core.records import epoch_indices
from repro_torch.core.state import init_state, state_device
from repro_torch.detection.kitnet import score_kitnet, train_kitnet
from repro_torch.device import DeviceLike
from repro_torch.traffic.generator import to_torch


def _features(trace: Dict, n_slots: int, mode: str,
              backend: Optional[str] = None, state: Optional[Dict] = None,
              device: DeviceLike = None) -> Tuple[Dict, torch.Tensor]:
    """FC over a whole trace, from ``state`` or fresh dense tables on
    ``device``; the features stay on the state's device."""
    st = state if state is not None else init_state(n_slots, device=device)
    if backend is None:
        backend = default_backend(mode)
    return compute_features(st, to_torch(trace, state_device(st)),
                            backend=backend, mode=mode)


def take(feats: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``feats[idx]`` for host indices, gathered on the features' device."""
    return feats[torch.as_tensor(idx, device=feats.device)]


def run_peregrine(data: Dict, sampling: int, n_slots: int = 8192,
                  mode: str = "switch", train_epoch: int = 1,
                  seed: int = 0, backend: Optional[str] = None,
                  chunk: int = 8192, md_backend: Optional[str] = None,
                  md_kw: Optional[Dict] = None, device: DeviceLike = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (scores, labels) per sampled feature record of the eval set.

    ``backend`` selects the FC implementation by name
    (serial/scan/cuda/bucketed/sharded); the default follows the arithmetic
    mode.  ``md_backend`` selects the KitNET scoring implementation
    (einsum/cuda), ``md_kw`` its options.  The trace is streamed
    through ``DetectionService`` in ``chunk``-sized batches: flow state and
    epoch accounting carry across chunks and each chunk's records are
    scored as they arrive.
    """
    # deferred: repro_torch.serving imports this package for its service
    from repro_torch.serving.detect_service import DetectionService
    svc = DetectionService(epoch=train_epoch, n_slots=n_slots, mode=mode,
                           backend=backend, md_backend=md_backend,
                           md_kw=md_kw, device=device)
    svc.observe_stream(data["train"], chunk=chunk)
    svc.fit(seed=seed)
    # eval is a fresh capture: restart epoch accounting at the sampling rate
    # (flow tables stay warm), so record indices are eval-local
    svc.epoch = sampling
    svc.reset_stream()
    idx, scores, _ = svc.process_stream(data["eval"], chunk=chunk)
    return scores, data["eval"]["label"][idx]


def run_kitsune_baseline(data: Dict, sampling: int, n_slots: int = 8192,
                         train_epoch: int = 1, seed: int = 0,
                         device: DeviceLike = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Packet-sampled baseline: FC sees ONLY the 1:x sampled packets."""
    tr, ev = data["train"], data["eval"]
    tr_idx = epoch_indices(len(tr["ts"]), sampling)
    ev_idx = epoch_indices(len(ev["ts"]), sampling, offset=len(tr["ts"]))
    tr_s = {k: v[tr_idx] for k, v in tr.items()}
    ev_s = {k: v[ev_idx] for k, v in ev.items()}
    st, f_train = _features(tr_s, n_slots, "exact", device=device)
    net = train_kitnet(take(f_train, epoch_indices(len(f_train), train_epoch)),
                       seed=seed)
    _, f_eval = _features(ev_s, n_slots, "exact", state=st)
    return score_kitnet(net, f_eval), ev_s["label"]
