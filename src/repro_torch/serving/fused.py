"""Device-resident per-chunk step: FC → epoch gather → MD → threshold
(port of ``repro.serving.fused``, single stream).

    state, idx, scores, alarms, count = step(state, net, thr, base_mod, pkts)

* ``state`` stays on the device and is updated IN PLACE; the returned
  handle is the same dict.  This replaces the JAX package's donated jit
  (DESIGN.md §8): there is no second copy of the flow tables, and a caller
  that needs a restore point clones the state first (``clone_state``).
* Epoch sampling is the static-shape ``core.records.epoch_gather``: no
  ``nonzero``, no device-to-host sync inside the step.
* FC runs through ``compute_features_sampled``: the ``scan`` and
  ``bucketed`` backends' record-sampled path updates the flow state for
  every packet but computes feature statistics only at the epoch records;
  the other backends (``cuda``, ``serial``, ``sharded``) compute the full
  (n, 80) matrix and the records are gathered on the device.
* ``backend_kw`` and ``md_kw`` carry the FC and MD backends' options (e.g.
  ``{"buckets": 8}``); an option a backend does not take raises
  ``TypeError`` when the step is built.
* Any registered FC backend and mode it supports: ``mode="switch"`` runs
  with the ``serial`` backend, as the JAX package's step does.
* Only ``(idx, scores, alarms)`` (``count`` rows each) need to cross to the
  host, and the step does not wait for them: kernels are queued on the
  current stream, so ``DetectionService.process_stream`` can dispatch chunk
  k+1 before it drains chunk k.

The same per-chunk core serves the multi-tenant ``DetectionEngine``
(``make_tenant_step``, DESIGN.md §10): T tenants' chunks advance in one
step over a stacked state pool, tenant ids carried with every lane so
states and epoch counters never mix.  On a dense pool with the ``cuda``
backend that step is one ``fc_full`` launch over every lane and one
``kitnet_score`` launch over every lane's records; other backends and the
sketch layout run the single-stream step lane by lane on each tenant's view
of the pool.

PyTorch runs eagerly, so each step is a plain function; there is no
compilation cache and so no placement token: the partitioned FC backends
resolve the ambient mesh (``distributed.sharding.flow_mesh``) at every
call.  A pool built under a bound ``tenants`` rule is placed
(``core.state.PlacedPool``), and the tenant step spreads its lanes by
home place, the port's ``_tenant_sharding``: on each place one ``fc_full``
launch over that place's lanes and one ``kitnet_score`` launch with the
place's copy of the net (:func:`place_net`); other backends run each lane
on its home place.  Only packets go to a place, and only the records'
positions, scores and alarms come back, to place 0.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core.backends import (check_backend_mode,
                                       check_backend_options,
                                       compute_features_sampled,
                                       resolve_backend)
from repro_torch.core.records import epoch_gather, epoch_gather_lanes
from repro_torch.core.state import PlacedPool, state_backend_of, tenant_view
from repro_torch.detection.md_backends import md_score_fn
from repro_torch.distributed.sharding import without_rule
from repro_torch.kernels.feature_update import feature_update_full_tenants


def make_fused_step(backend: str = "cuda", mode: str = "exact",
                    backend_kw: Optional[Dict] = None,
                    md_backend: str = "cuda", md_kw: Optional[Dict] = None,
                    epoch: int = 1024) -> Callable:
    """Build the per-chunk step (FC options ``backend_kw``, MD options
    ``md_kw``).

    Returns ``step(state, net, threshold, base_mod, pkts)`` →
    ``(state, idx, scores, alarms, count)``: ``idx`` (ceil(n/epoch),) int64
    within-chunk record positions, zero-padded past ``count`` (a host int);
    ``scores``/``alarms`` aligned with ``idx`` (rows past ``count`` are
    padding).  ``base_mod`` is the running packet count modulo ``epoch``;
    ``threshold`` is compared in float32 on the device.
    """
    backend = resolve_backend(backend)
    check_backend_mode(backend, mode)
    fc_kw = dict(backend_kw or {})
    check_backend_options(backend, fc_kw)
    score = md_score_fn(md_backend, **dict(md_kw or {}))

    @torch.no_grad()
    def step(state, net, threshold: float, base_mod: int, pkts):
        n = pkts["ts"].shape[0]
        idx, count = epoch_gather(n, epoch, base_mod, device=pkts["ts"].device)
        state, recs = compute_features_sampled(state, pkts, idx,
                                               backend=backend, mode=mode,
                                               **fc_kw)
        scores = score(net, recs)
        return state, idx, scores, scores > threshold, count

    return step


def place_net(net, pool):
    """One copy of ``net`` on each place of a placed pool (the net itself
    for an unplaced pool): what the tenant step scores with."""
    if not isinstance(pool, PlacedPool):
        return net
    return tuple(net.to(dev) for dev in pool.ctx.devices)


def make_tenant_step(backend: str = "cuda", mode: str = "exact",
                     backend_kw: Optional[Dict] = None,
                     md_backend: str = "cuda", md_kw: Optional[Dict] = None,
                     epoch: int = 1024) -> Callable:
    """Build the TENANT-BATCHED per-chunk step.

    Returns ``step(pool, tenant_ids, net, threshold, base_mods, pkts)`` →
    ``(pool, idx, scores, alarms, counts)``: the per-chunk core of
    :func:`make_fused_step` over a leading lane axis.  ``pool`` is a stacked
    state (``core.state.init_state_stacked`` / ``StatePool.stacked``),
    updated in place; ``tenant_ids`` the L pool tenants of the lanes (host
    ints, no repeats); ``base_mods`` each lane's running packet count modulo
    ``epoch``; ``pkts`` packet tensors stacked to ``(L, chunk)``.  ``idx``,
    ``scores`` and ``alarms`` are (L, ceil(chunk/epoch)) device tensors,
    padded past ``counts`` (host ints).  Each lane's results and end state
    are those of the single-stream step on that tenant alone, bit for bit.
    ``net``/``threshold`` are shared: one fitted detector, many streams.

    A dense pool with the ``cuda`` backend runs one batched step: the
    records' positions of every lane at once, hashing once on the stacked
    packets, one ``fc_full`` launch over all lanes
    (``kernels/feature_update.feature_update_full_tenants``), the records
    gathered and scored in one ``kitnet_score`` launch, the threshold
    compared on the device.  Everything else (``scan``, ``bucketed``,
    ``sharded``, ``serial``, sketch pools, switch mode) runs
    :func:`make_fused_step` lane by lane.  ``backend_kw``/``md_kw`` as
    there.

    A :class:`~repro_torch.core.state.PlacedPool` runs that per home place,
    in place order: the batched step on each place's lanes, or each lane's
    step there with the ``flow_shards`` rule unbound (a tenant's FC is not
    spread again).  ``net`` is then a copy a place (:func:`place_net`) or
    one net that lies on every place's device; ``pkts`` is ``(L, chunk)``
    tensors on place 0's device, or a list of each place's ``(L_p,
    chunk)`` tensors already there, in the order of ``pool.groups``.  The
    results come back to place 0's device in lane order.
    """
    lane_step = make_fused_step(backend=backend, mode=mode,
                                backend_kw=backend_kw, md_backend=md_backend,
                                md_kw=md_kw, epoch=epoch)
    backend = resolve_backend(backend)
    score = md_score_fn(md_backend, **dict(md_kw or {}))

    def run(pool, tids, net, threshold, base_mods, pkts):
        """The step on one stacked dict (an unplaced pool or a place's)."""
        L, n = pkts["ts"].shape
        if backend == "cuda" and mode == "exact" and state_backend_of(pool) == "dense":
            dev = pkts["ts"].device
            idx, counts = epoch_gather_lanes(n, epoch, base_mods, device=dev)
            pool, feats = feature_update_full_tenants(pool, tids, pkts)
            lane0 = torch.arange(L, dtype=torch.int64, device=dev)[:, None] * n
            recs = feats.reshape(L * n, -1)[(idx + lane0).reshape(-1)]
            scores = score(net, recs).view(idx.shape)
            return idx, scores, scores > threshold, counts
        outs = [lane_step(tenant_view(pool, t), net, threshold, int(bm),
                          {k: v[lane] for k, v in pkts.items()})
                for lane, (t, bm) in enumerate(zip(tids, base_mods))]
        idx, scores, alarms = (torch.stack([o[j] for o in outs])
                               for j in (1, 2, 3))
        return idx, scores, alarms, tuple(o[4] for o in outs)

    def run_placed(pool: PlacedPool, tids, nets, threshold, base_mods,
                   pkts: Union[Dict, List[Dict]]):
        ctx = pool.ctx
        groups = pool.groups(tids)
        if isinstance(pkts, dict):
            home = pkts["ts"].device
            pkts = [{k: ctx.to_place(v[torch.tensor(lanes, device=home)], p)
                     for k, v in pkts.items()} for p, lanes, _ in groups]
        dev0 = ctx.devices[0]
        parts, counts, order = [], {}, []
        with without_rule("flow_shards"):
            for (p, lanes, local), pk in zip(groups, pkts):
                idx, scores, alarms, cnt = run(
                    pool.parts[p], local, nets[p], threshold,
                    [base_mods[j] for j in lanes], pk)
                parts.append([ctx.to_home(t, p, dev0)
                              for t in (idx, scores, alarms)])
                counts.update(zip(lanes, cnt))
                order += lanes
        inv = torch.tensor(order).argsort().to(dev0)
        idx, scores, alarms = (torch.cat([q[j] for q in parts])[inv]
                               for j in range(3))
        return idx, scores, alarms, tuple(counts[j] for j in range(len(tids)))

    @torch.no_grad()
    def step(pool, tenant_ids: Sequence[int], net, threshold: float,
             base_mods: Sequence[int], pkts):
        tids = [int(t) for t in tenant_ids]
        if len(set(tids)) != len(tids):
            raise ValueError(f"tenant_ids must not repeat a tenant, got {tids}")
        if isinstance(pool, PlacedPool):
            nets = (net if isinstance(net, (tuple, list))
                    else (net,) * pool.size)
            return (pool,) + run_placed(pool, tids, nets, threshold,
                                        base_mods, pkts)
        return (pool,) + run(pool, tids, net, threshold, base_mods, pkts)

    return step
