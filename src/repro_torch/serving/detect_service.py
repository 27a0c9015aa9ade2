"""Peregrine control-plane service (port of
``repro.serving.detect_service``).

Consumes packet batches, runs feature computation, samples one record per
epoch, and scores the records with KitNET — the paper's §3.2 workflow as
one object.  It keeps the running packet count, so epochs are continuous
across batches, and keeps the flow tables on the device between calls.
Record indices are global stream positions (DESIGN.md §5).

Both compute stages are selected by name: ``backend=`` the FC
implementation (``core.backends``: ``cuda`` by default, ``scan``,
``bucketed``, ``sharded`` or ``serial``), ``md_backend=`` the scoring
implementation (``detection.md_backends``: ``cuda`` by default, or
``einsum``).  On the CPU the ``cuda`` names run the plain PyTorch versions.
The FC backend's options are the service's remaining keywords (e.g.
``backend="bucketed", buckets=4`` or ``backend="sharded", shards=4``), the
MD backend's go in ``md_kw``; both reach every FC and MD call the service
makes, and an option a backend does not take raises ``TypeError`` here.

Exact-mode inference runs the per-chunk step of ``serving/fused.py`` by
default (only the sampled ``(indices, scores, alarms)`` leave the device),
and ``process_stream`` dispatches chunk k+1 before draining chunk k.  The
flow state is updated in place (DESIGN.md §8 donation, as PyTorch does
it): ``clone_state(svc.state)`` is the snapshot.

``state_backend=`` picks the flow-table layout: ``dense`` slots (the
default) or the Count-Min ``sketch``, with ``state_kw`` such as
``{"rows": 2, "evict_age": 60.0}`` (``core/sketch.py``); with a sketch
state the ``cuda`` FC name runs the sketch kernel.

``mode="switch"`` selects the switch's shift arithmetic with round-robin
decay (``core/arith.py``).  Only the ``serial`` FC backend supports it, so
it is the default there, and inference defaults to the staged path, as in
the JAX package's service; ``fused=True`` runs the per-chunk step through
the same backend.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends import (check_backend_mode,
                                       check_backend_options, compute_features,
                                       default_backend, resolve_backend)
from repro_torch.core.records import epoch_indices
from repro_torch.core.state import init_state
from repro_torch.data.pipeline import phv_batches
from repro_torch.detection.kitnet import KitNet, train_kitnet
from repro_torch.detection.md_backends import (default_md_backend,
                                               score_records,
                                               validate_md_options)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.fused import make_fused_step
from repro_torch.traffic.generator import to_torch


class DetectionService:
    def __init__(self, epoch: int = 1024, n_slots: int = 8192,
                 mode: str = "exact", threshold: Optional[float] = None,
                 backend: Optional[str] = None,
                 md_backend: Optional[str] = None,
                 md_kw: Optional[Dict] = None,
                 fused: Optional[bool] = None,
                 state_backend: str = "dense",
                 state_kw: Optional[Dict] = None,
                 device: DeviceLike = None, **backend_kw):
        self.device = resolve_device(device)
        self.epoch = epoch
        self.mode = mode
        self.backend = resolve_backend(backend if backend is not None
                                       else default_backend(mode))
        check_backend_mode(self.backend, mode)
        self.backend_kw = backend_kw            # e.g. shards= for "sharded"
        check_backend_options(self.backend, backend_kw)
        self.md_kw = dict(md_kw or {})
        self.md_backend = validate_md_options(
            md_backend if md_backend is not None else default_md_backend(),
            self.md_kw)
        # the per-chunk device step by default wherever the exact batch
        # pipeline runs; the switch mode's oracle stays on the staged path
        self.fused = (mode == "exact") if fused is None else bool(fused)
        self.state = init_state(n_slots, state_backend=state_backend,
                                device=self.device, **(state_kw or {}))
        self.net: Optional[KitNet] = None
        # thresholds are kept f32-representable so the device (f32) and
        # host comparisons agree bit for bit
        self.threshold = (None if threshold is None
                          else float(np.float32(threshold)))
        self.pkt_count = 0
        self._train_feats = []
        self._step = None

    # ---- data-plane step ----
    def _fc(self, pkts: Dict[str, np.ndarray]) -> torch.Tensor:
        self.state, feats = compute_features(
            self.state, to_torch(pkts, self.device), backend=self.backend,
            mode=self.mode, **self.backend_kw)
        return feats

    def reset_stream(self, pkt_count: int = 0) -> None:
        """Restart epoch accounting (a new capture); flow tables persist."""
        self.pkt_count = pkt_count

    # ---- training phase ----
    def observe_benign(self, pkts: Dict[str, np.ndarray]) -> np.ndarray:
        """Feed one benign batch; returns the *global* indices of the
        feature records collected for training."""
        feats = self._fc(pkts)
        base = self.pkt_count
        idx = epoch_indices(len(feats), self.epoch, base)
        self.pkt_count += len(feats)
        if len(idx):
            self._train_feats.append(
                feats[torch.as_tensor(idx, device=feats.device)])
        return idx + base

    def observe_stream(self, pkts: Dict[str, np.ndarray],
                       chunk: int = 4096) -> np.ndarray:
        """Stream a long benign trace through ``observe_benign`` in
        fixed-size chunks.  Returns all global record indices."""
        out = [self.observe_benign(c) for c in phv_batches(pkts, chunk)]
        return (np.concatenate(out) if out
                else np.zeros((0,), dtype=np.int64))

    def fit(self, seed: int = 0, fpr: float = 0.01) -> None:
        if not self._train_feats:
            raise RuntimeError(
                "no training records collected: observe_benign() never "
                f"crossed an epoch boundary (epoch={self.epoch}, "
                f"{self.pkt_count} packets seen) — feed more benign traffic "
                "or lower `epoch`")
        train = torch.cat(self._train_feats)
        self.net = train_kitnet(train, seed=seed, md_backend=self.md_backend,
                                device=self.device, md_kw=self.md_kw)
        scores = score_records(self.net, train, backend=self.md_backend,
                               **self.md_kw)
        if self.threshold is None:
            self.threshold = float(np.float32(np.quantile(scores, 1.0 - fpr)))
        self._train_feats = []

    # ---- inference phase ----
    def _fused_step(self):
        if self._step is None:
            self._step = make_fused_step(
                backend=self.backend, mode=self.mode,
                backend_kw=self.backend_kw, md_backend=self.md_backend,
                md_kw=self.md_kw, epoch=self.epoch)
        return self._step

    def _dispatch_fused(self, pkts: Dict[str, np.ndarray]):
        """Queue one chunk's step on the device; does NOT wait for it."""
        n = len(pkts["ts"])
        base = self.pkt_count
        self.state, idx, scores, alarms, count = self._fused_step()(
            self.state, self.net, self.threshold, base % self.epoch,
            to_torch(pkts, self.device))
        self.pkt_count += n
        return base, idx, scores, alarms, count

    @staticmethod
    def _drain_fused(out) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for one dispatched chunk; only the sampled rows transfer."""
        base, idx, scores, alarms, count = out
        return (idx[:count].cpu().numpy().astype(np.int64) + base,
                scores[:count].cpu().numpy(), alarms[:count].cpu().numpy())

    def process(self, pkts: Dict[str, np.ndarray],
                fused: Optional[bool] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (global_record_indices, rmse_scores, alarms).

        ``fused=`` overrides the service default: True runs the per-chunk
        device step, False the staged FC → host sampling → MD path.
        """
        if self.net is None:
            raise RuntimeError("call fit() first")
        if self.fused if fused is None else fused:
            return self._drain_fused(self._dispatch_fused(pkts))
        feats = self._fc(pkts)
        base = self.pkt_count
        idx = epoch_indices(len(feats), self.epoch, base)
        self.pkt_count += len(feats)
        if not len(idx):
            return idx + base, np.zeros((0,), np.float32), np.zeros((0,), bool)
        scores = score_records(self.net,
                               feats[torch.as_tensor(idx, device=feats.device)],
                               backend=self.md_backend, **self.md_kw)
        return idx + base, scores, scores > np.float32(self.threshold)

    def process_stream(self, pkts: Dict[str, np.ndarray], chunk: int = 4096,
                       fused: Optional[bool] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stream a long trace in fixed-size chunks, carrying flow-table
        state and the running packet count across chunk boundaries.
        Returns concatenated (global_record_indices, scores, alarms),
        identical to one ``process`` call on the whole trace.

        On the fused path chunk k+1 is dispatched before chunk k's sampled
        results are drained, so the host never waits on a chunk it could
        already have queued."""
        if self.net is None:
            raise RuntimeError("call fit() first")
        use_fused = self.fused if fused is None else fused
        outs = []
        if use_fused:
            pending = None
            for c in phv_batches(pkts, chunk):
                nxt = self._dispatch_fused(c)
                if pending is not None:
                    outs.append(self._drain_fused(pending))
                pending = nxt
            if pending is not None:
                outs.append(self._drain_fused(pending))
        else:
            outs = [self.process(c, fused=False)
                    for c in phv_batches(pkts, chunk)]
        if not outs:
            return (np.zeros((0,), dtype=np.int64), np.zeros((0,), np.float32),
                    np.zeros((0,), bool))
        return tuple(np.concatenate(parts) for parts in zip(*outs))
