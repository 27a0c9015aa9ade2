"""Device-resident per-chunk step: FC → epoch gather → MD → threshold
(port of ``repro.serving.fused``, single stream).

    state, idx, scores, alarms, count = step(state, net, thr, base_mod, pkts)

* ``state`` stays on the device and is updated IN PLACE; the returned
  handle is the same dict.  This replaces the JAX package's donated jit
  (DESIGN.md §8): there is no second copy of the flow tables, and a caller
  that needs a restore point clones the state first (``clone_state``).
* Epoch sampling is the static-shape ``core.records.epoch_gather``: no
  ``nonzero``, no device-to-host sync inside the step.
* FC runs through ``compute_features_sampled``: the ``scan`` backend's
  record-sampled path updates the flow state for every packet but computes
  feature statistics only at the epoch records; the other backends compute
  the full (n, 80) matrix and the records are gathered on the device.
* Any registered FC backend and mode it supports: ``mode="switch"`` runs
  with the ``serial`` backend, as the JAX package's step does.
* Only ``(idx, scores, alarms)`` (``count`` rows each) need to cross to the
  host, and the step does not wait for them: kernels are queued on the
  current stream, so ``DetectionService.process_stream`` can dispatch chunk
  k+1 before it drains chunk k.

PyTorch runs eagerly, so the step is a plain function; there is no
compilation cache and no placement token.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.backends import (check_backend_mode,
                                       compute_features_sampled,
                                       resolve_backend)
from repro_torch.core.records import epoch_gather
from repro_torch.detection.md_backends import md_score_fn


def make_fused_step(backend: str = "cuda", mode: str = "exact",
                    md_backend: str = "cuda", epoch: int = 1024) -> Callable:
    """Build the per-chunk step.

    Returns ``step(state, net, threshold, base_mod, pkts)`` →
    ``(state, idx, scores, alarms, count)``: ``idx`` (ceil(n/epoch),) int64
    within-chunk record positions, zero-padded past ``count`` (a host int);
    ``scores``/``alarms`` aligned with ``idx`` (rows past ``count`` are
    padding).  ``base_mod`` is the running packet count modulo ``epoch``;
    ``threshold`` is compared in float32 on the device.
    """
    backend = resolve_backend(backend)
    check_backend_mode(backend, mode)
    score = md_score_fn(md_backend)

    @torch.no_grad()
    def step(state, net, threshold: float, base_mod: int, pkts):
        n = pkts["ts"].shape[0]
        idx, count = epoch_gather(n, epoch, base_mod, device=pkts["ts"].device)
        state, recs = compute_features_sampled(state, pkts, idx,
                                               backend=backend, mode=mode)
        scores = score(net, recs)
        return state, idx, scores, scores > threshold, count

    return step
