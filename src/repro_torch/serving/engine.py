"""Multi-tenant detection engine: N tenant streams, one device or a mesh
(port of ``repro.serving.engine``).

``DetectionService`` is one synchronous loop over one stream; deployment is
a switch feeding MANY concurrent tenant streams into one control-plane
detector.  ``DetectionEngine`` multiplexes them (DESIGN.md §10):

* **Bounded state pool.**  Per-tenant flow tables live in a
  ``core.state.StatePool``: one stacked dict with a leading tenant axis, so
  N tenants cost one device allocation per table; tenant slots are
  alloc'd/freed/reset as streams attach and detach.
* **Cross-tenant batching.**  Ready tenants' chunks are packed into ONE
  tenant-batched step (``serving/fused.make_tenant_step``): on a dense pool
  with the ``cuda`` backend one ``fc_full`` launch over every lane, the
  pool written in place, and one ``kitnet_score`` launch over every lane's
  records; tenant ids ride with every lane so states and per-tenant epoch
  counters never mix.  Per-lane results are bitwise the single-stream
  step's, so one tenant through the engine reproduces
  ``DetectionService.process_stream`` bit for bit.
* **Backpressure.**  Each tenant has a bounded ingress buffer
  (``queue_depth`` chunks); ``submit`` sheds overflow (drop-tail), never
  blocks, and the shed count is reported per tenant.
* **Dispatch before drain.**  A batch's kernels are queued on the current
  stream and the host goes on; batch k+1 is dispatched before batch k's
  O(records) results are copied back (``.cpu()``), so one batch is in
  flight.
* **Operational surface.**  Per-tenant p50/p99 chunk latency, aggregate
  pps, per-tenant drop/record/alarm/slot-collision counters (``stats()``),
  and a per-tenant CSV or JSONL alarm log (``alarm_dir=``).  Slot
  collisions are counted on the device for every lane of a batch at once
  (``core.state.slot_collisions_lanes``) and drained with its records; the
  JAX package counts them on the host, a lane at a time.

* **Placement.**  An engine built under ``distributed.sharding.flow_mesh``
  (a bound ``tenants`` rule) places its pool: tenant t's tables live on
  place ``t % D`` for the pool's life (``core.state.PlacedPool``), and the
  net is copied to every place once.  A batch then sends each lane's
  packets straight to its tenant's place, runs one step a place
  (``make_tenant_step``), counts slot collisions there, and brings back
  only the records' positions, scores, alarms and counts.  The state
  never moves.

One fitted detector (net + threshold) serves every tenant; isolation is
state isolation, not model isolation.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends import (check_backend_options, default_backend,
                                       resolve_backend)
from repro_torch.core.state import (StatePool, slot_collisions_lanes,
                                    state_backend_of, state_config,
                                    state_device, state_slots)
from repro_torch.detection.md_backends import (default_md_backend,
                                               validate_md_options)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import count_transfer
from repro_torch.serving.fused import make_tenant_step, place_net
from repro_torch.traffic.generator import to_torch


class DetectionEngine:
    """Continuous-batching detection engine over a bounded tenant pool.

    Parameters
    ----------
    net, threshold:
        The fitted KitNET and alarm threshold shared by every tenant (train
        once via ``DetectionService``, then ``from_service``).
    epoch, n_slots, backend, md_backend, mode:
        The per-chunk pipeline configuration, identical in meaning to
        ``DetectionService``; only exact mode is supported.  The defaults
        are the port's: FC ``default_backend("exact")`` (``cuda``, the
        ``fc_full`` kernel, whose batched launch takes every lane) and MD
        ``default_md_backend()`` (``cuda``).  The JAX package's engine
        defaults to ``scan``.
    backend_kw, md_kw:
        The FC and MD backends' options (e.g. ``backend="bucketed",
        backend_kw={"buckets": 4}``); an option a backend does not take
        raises ``TypeError``.
    n_tenants:
        State-pool capacity: the hard bound on concurrently attached
        tenant streams.
    chunk:
        Packets per lane of a batched step.  Full chunks are batched across
        tenants; partial tails are flushed at ``flush()``.
    queue_depth:
        Ingress bound per tenant, in chunks: at most ``queue_depth * chunk``
        packets may sit buffered; ``submit`` sheds the excess.
    max_batch:
        Most tenant lanes per step (default: ``n_tenants``).
    alarm_dir / alarm_format:
        When set, every drained alarm is appended to a per-tenant
        structured log ``<alarm_dir>/tenant<id>.{csv|jsonl}``.
    state_backend / state_kw:
        Flow-table layout of the tenant pool: ``"dense"`` (default) or
        ``"sketch"`` (``state_kw={"rows": R, "evict_age": ...}``).  Dense
        pools also report per-tenant ``slot_collisions``: the distinct flow
        keys that aliased an occupied slot per chunk.
    device:
        Where the pool and the steps live: ``cuda`` unless ``"cpu"`` is
        asked for (the plain versions then run); the net must be there.
        Built under a bound ``tenants`` rule, the pool lives on the mesh's
        places instead, and the net is copied to each.

    ``from_service`` inherits the service's net, threshold, epoch, backends
    and their options, mode, state layout, ``state_config`` and device.
    """

    def __init__(self, net, threshold: float, *, epoch: int = 1024,
                 n_slots: int = 8192, n_tenants: int = 4, chunk: int = 2048,
                 queue_depth: int = 8, max_batch: Optional[int] = None,
                 backend: Optional[str] = None,
                 backend_kw: Optional[Dict] = None,
                 md_backend: Optional[str] = None,
                 md_kw: Optional[Dict] = None,
                 mode: str = "exact", alarm_dir: Optional[str] = None,
                 alarm_format: str = "csv",
                 state_backend: str = "dense",
                 state_kw: Optional[Dict] = None,
                 device: DeviceLike = None):
        if mode != "exact":
            raise ValueError("DetectionEngine runs the exact-mode per-chunk "
                             f"step; mode {mode!r} is not supported")
        if chunk < 1 or queue_depth < 1:
            raise ValueError("chunk and queue_depth must be positive")
        if alarm_format not in ("csv", "jsonl"):
            raise ValueError(f"alarm_format must be csv|jsonl, "
                             f"got {alarm_format!r}")
        self.device = resolve_device(device)
        self.net = net
        self.threshold = float(np.float32(threshold))
        self.epoch = int(epoch)
        self.mode = mode
        self.backend = resolve_backend(backend if backend is not None
                                       else default_backend(mode))
        self.backend_kw = dict(backend_kw or {})
        check_backend_options(self.backend, self.backend_kw)
        self.md_kw = dict(md_kw or {})
        self.md_backend = validate_md_options(
            md_backend if md_backend is not None else default_md_backend(),
            self.md_kw)
        self.chunk = int(chunk)
        self.queue_depth = int(queue_depth)
        self.max_batch = int(max_batch if max_batch is not None else n_tenants)
        self.state_backend = state_backend
        self.state_kw = dict(state_kw or {})
        self.n_slots = int(n_slots)
        self.pool = StatePool(n_tenants, n_slots, state_backend=state_backend,
                              device=self.device, **self.state_kw)
        self._net = place_net(net, self.pool.stacked)
        self.alarm_dir = alarm_dir
        self.alarm_format = alarm_format
        self._step = make_tenant_step(backend=self.backend, mode=self.mode,
                                      backend_kw=self.backend_kw,
                                      md_backend=self.md_backend,
                                      md_kw=self.md_kw, epoch=self.epoch)
        # per-tenant host-side stream state (created by add_tenant)
        self._buf: Dict[int, collections.deque] = {}
        self._buffered: Dict[int, int] = {}
        self._pkt_count: Dict[int, int] = {}
        self._results: Dict[int, List] = {}
        self._lat: Dict[int, List[float]] = {}
        self._counters: Dict[int, Dict[str, int]] = {}
        self._alarm_files: Dict[int, object] = {}
        # in-flight batches, oldest first (dispatch before drain)
        self._inflight: collections.deque = collections.deque()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._pkts_done = 0

    # ------------------------------------------------------------------
    # construction from a trained service
    # ------------------------------------------------------------------
    @classmethod
    def from_service(cls, svc, **kw) -> "DetectionEngine":
        """Build an engine that runs the SAME per-chunk pipeline as a
        fitted ``DetectionService`` (net, threshold, epoch, slot budget,
        FC/MD backends and their options, mode, state layout and device
        inherited; override via ``kw``)."""
        if svc.net is None:
            raise RuntimeError("fit the service first")
        cfg = dict(epoch=svc.epoch, n_slots=state_slots(svc.state),
                   backend=svc.backend, backend_kw=svc.backend_kw,
                   md_backend=svc.md_backend, md_kw=svc.md_kw,
                   mode=svc.mode, state_backend=state_backend_of(svc.state),
                   state_kw=state_config(svc.state),
                   device=state_device(svc.state))
        cfg.update(kw)
        return cls(svc.net, svc.threshold, **cfg)

    # ------------------------------------------------------------------
    # tenant lifecycle
    # ------------------------------------------------------------------
    def add_tenant(self) -> int:
        """Attach a new tenant stream: claims a pool slot (fresh flow
        tables, epoch counter at zero) and an empty ingress queue."""
        tid = self.pool.alloc()
        self._buf[tid] = collections.deque()
        self._buffered[tid] = 0
        self._pkt_count[tid] = 0
        self._results[tid] = [[], [], []]
        self._lat[tid] = []
        self._counters[tid] = {"pkts_in": 0, "pkts_dropped": 0,
                               "pkts_processed": 0, "records": 0, "alarms": 0,
                               "slot_collisions": 0}
        return tid

    def remove_tenant(self, tid: int) -> None:
        """Detach a tenant and free its pool slot.  Buffered packets are
        discarded; drain in-flight work first (``flush``) if the tenant's
        remaining results matter."""
        if self._inflight:
            self._drain_all()
        self.pool.free(tid)
        for d in (self._buf, self._buffered, self._pkt_count, self._results,
                  self._lat, self._counters):
            d.pop(tid, None)
        f = self._alarm_files.pop(tid, None)
        if f is not None:
            f.close()

    def seed_tenant(self, tid: int, state: Dict, pkt_count: int = 0) -> None:
        """Start tenant ``tid`` from an existing flow-table state (a COPY
        is installed) and stream position, e.g. hand a
        ``DetectionService``'s post-training tables over so the tenant
        stream continues exactly where the training capture stopped."""
        if self._inflight:
            self._drain_all()
        self.pool.write(tid, state)
        self._pkt_count[tid] = int(pkt_count)

    def reset_tenant(self, tid: int) -> None:
        """Fresh capture on an attached tenant: zero its flow tables and
        epoch counter, drop its buffered packets (results are kept)."""
        if self._inflight:
            self._drain_all()
        self.pool._check(tid)
        self.pool.reset(tid)
        self._buf[tid].clear()
        self._buffered[tid] = 0
        self._pkt_count[tid] = 0

    # ------------------------------------------------------------------
    # ingress with backpressure
    # ------------------------------------------------------------------
    def room(self, tid: int) -> int:
        """Packets tenant ``tid``'s bounded ingress buffer still accepts."""
        return self.queue_depth * self.chunk - self._buffered[tid]

    def submit(self, tid: int, pkts: Dict[str, np.ndarray]) -> int:
        """Offer a packet batch to tenant ``tid``'s ingress queue.

        Never blocks: accepts up to ``room(tid)`` packets (FIFO order
        preserved), SHEDS the rest (drop-tail), and returns the accepted
        count; ``stats()["tenants"][tid]["pkts_dropped"]`` accumulates the
        shed packets.  A slow device can cost coverage, never liveness."""
        n = len(pkts["ts"])
        self._counters[tid]["pkts_in"] += n
        take = max(0, min(n, self.room(tid)))
        if take:
            piece = {k: np.asarray(v[:take]) for k, v in pkts.items()
                     if k != "label"}
            self._buf[tid].append(piece)
            self._buffered[tid] += take
        dropped = n - take
        if dropped:
            self._counters[tid]["pkts_dropped"] += dropped
        return take

    def _pop(self, tid: int, size: int) -> Dict[str, np.ndarray]:
        """Pop exactly ``size`` packets from the front of the queue
        (splitting a buffered piece when the boundary lands inside it)."""
        buf = self._buf[tid]
        parts, got = [], 0
        while got < size:
            piece = buf.popleft()
            n = len(piece["ts"])
            if got + n > size:
                cut = size - got
                parts.append({k: v[:cut] for k, v in piece.items()})
                buf.appendleft({k: v[cut:] for k, v in piece.items()})
                got = size
            else:
                parts.append(piece)
                got += n
        self._buffered[tid] -= size
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------
    def _dispatch(self, tids: List[int], size: int) -> None:
        """Pack one chunk from each tenant in ``tids`` into a single
        tenant-batched step.  Returns with the batch queued on the device;
        the pool is updated in place."""
        chunks = [self._pop(t, size) for t in tids]

        def stack(lanes, device):
            return to_torch({k: np.stack([chunks[j][k] for j in lanes])
                             for k in chunks[0]}, device)

        pool = self.pool.stacked
        if self.pool.placed:      # each lane's packets straight to its place
            groups = pool.groups(tids)
            pk = [stack(lanes, pool.ctx.devices[p]) for p, lanes, _ in groups]
            for (p, _, _), part in zip(groups, pk):
                for v in part.values():
                    count_transfer(v, None, p)
        else:
            pk = stack(range(len(tids)), self.device)
        base_mods = [self._pkt_count[t] % self.epoch for t in tids]
        t0 = time.perf_counter()
        out = self._step(pool, tids, self._net, self.threshold, base_mods, pk)
        self.pool.stacked = out[0]
        self.pool.mark_dirty(tids)
        # dense-mode aliasing telemetry: distinct flow keys whose slots
        # collide inside each lane's chunk, counted on the device beside the
        # step (on each place) and drained with its records.  Sketch pools
        # absorb collisions by design and keep it at zero.
        coll = None
        if self.state_backend == "dense" and self.pool.placed:
            dev0 = pool.ctx.devices[0]
            coll = torch.empty(len(tids), dtype=torch.int64, device=dev0)
            for (p, lanes, _), part in zip(groups, pk):
                coll[torch.tensor(lanes, device=dev0)] = pool.ctx.to_home(
                    slot_collisions_lanes(part, self.n_slots), p, dev0)
        elif self.state_backend == "dense":
            coll = slot_collisions_lanes(pk, self.n_slots)
        bases = [self._pkt_count[t] for t in tids]
        for t in tids:
            self._pkt_count[t] += size
        if self._t_first is None:
            self._t_first = t0
        self._inflight.append((tids, bases, out[1:], coll, t0, size))

    def _drain_one(self) -> None:
        """Wait for the OLDEST in-flight batch; only the O(records) sampled
        outputs cross to the host."""
        tids, bases, (idx, scores, alarms, counts), coll, t0, size = \
            self._inflight.popleft()
        idx, scores = idx.cpu().numpy(), scores.cpu().numpy()
        alarms = alarms.cpu().numpy()
        coll = coll.cpu().numpy() if coll is not None else np.zeros(len(tids))
        now = time.perf_counter()
        self._t_last = now
        for lane, tid in enumerate(tids):
            c = int(counts[lane])
            gi = idx[lane, :c].astype(np.int64) + bases[lane]
            sc, al = scores[lane, :c], alarms[lane, :c]
            acc = self._results[tid]
            acc[0].append(gi)
            acc[1].append(sc)
            acc[2].append(al)
            self._lat[tid].append(now - t0)
            cnt = self._counters[tid]
            cnt["pkts_processed"] += size
            cnt["records"] += c
            cnt["slot_collisions"] += int(coll[lane])
            n_al = int(al.sum())
            cnt["alarms"] += n_al
            if n_al and self.alarm_dir is not None:
                self._log_alarms(tid, gi[al], sc[al])
        self._pkts_done += size * len(tids)

    def _drain_all(self) -> None:
        while self._inflight:
            self._drain_one()

    def step(self) -> int:
        """One engine tick: every READY tenant (a full chunk buffered) into
        tenant-batched steps, at most ``max_batch`` lanes each, dispatching
        each batch before the previous one is drained.  Returns the number
        of batches dispatched."""
        dispatched = 0
        while True:
            ready = [t for t in self.pool.live
                     if self._buffered.get(t, 0) >= self.chunk]
            if not ready:
                break
            for i in range(0, len(ready), self.max_batch):
                self._dispatch(ready[i:i + self.max_batch], self.chunk)
                dispatched += 1
                while len(self._inflight) > 1:   # keep ONE batch in flight
                    self._drain_one()
        return dispatched

    def flush(self) -> None:
        """Drain everything: remaining full chunks, then partial tails
        (tenants with equal tail length share a batch), then every
        in-flight batch.  After ``flush`` all submitted-and-accepted
        packets are reflected in ``results``."""
        self.step()
        tails: Dict[int, List[int]] = {}
        for t in self.pool.live:
            n = self._buffered.get(t, 0)
            if n:
                tails.setdefault(n, []).append(t)
        for size, tids in sorted(tails.items()):
            for i in range(0, len(tids), self.max_batch):
                self._dispatch(tids[i:i + self.max_batch], size)
                while len(self._inflight) > 1:   # keep ONE batch in flight
                    self._drain_one()
        self._drain_all()

    # ------------------------------------------------------------------
    # results / telemetry / alarm delivery
    # ------------------------------------------------------------------
    def results(self, tid: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenated (global_record_indices, scores, alarms) drained so
        far for tenant ``tid``: the same triple ``process_stream``
        returns."""
        gi, sc, al = self._results[tid]
        if not gi:
            return (np.zeros((0,), np.int64), np.zeros((0,), np.float32),
                    np.zeros((0,), bool))
        return np.concatenate(gi), np.concatenate(sc), np.concatenate(al)

    def stats(self) -> Dict:
        """Operational counters: per-tenant ingress/drop/record/alarm
        counts and p50/p99 per-chunk latency (ms), plus the aggregate
        processed-packet count and pps over the dispatch→drain window."""
        per = {}
        for tid in self._counters:
            lat = np.asarray(self._lat[tid]) * 1e3
            per[tid] = dict(self._counters[tid])
            per[tid]["p50_ms"] = float(np.percentile(lat, 50)) if len(lat) else 0.0
            per[tid]["p99_ms"] = float(np.percentile(lat, 99)) if len(lat) else 0.0
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        return {"tenants": per,
                "aggregate": {"pkts_processed": self._pkts_done,
                              "wall_s": wall,
                              "pps": self._pkts_done / wall if wall else 0.0}}

    def _log_alarms(self, tid: int, gi: np.ndarray, sc: np.ndarray) -> None:
        f = self._alarm_files.get(tid)
        if f is None:
            os.makedirs(self.alarm_dir, exist_ok=True)
            path = os.path.join(self.alarm_dir,
                                f"tenant{tid}.{self.alarm_format}")
            f = open(path, "a")
            if self.alarm_format == "csv" and f.tell() == 0:
                f.write("tenant,record_index,score\n")
            self._alarm_files[tid] = f
        if self.alarm_format == "csv":
            f.writelines(f"{tid},{i},{s}\n" for i, s in zip(gi, sc))
        else:
            f.writelines(json.dumps({"tenant": tid, "record": int(i),
                                     "score": float(s)}) + "\n"
                         for i, s in zip(gi, sc))
        f.flush()

    def close(self) -> None:
        for f in self._alarm_files.values():
            f.close()
        self._alarm_files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # convenience runner
    # ------------------------------------------------------------------
    def run(self, traces: Dict[int, Dict[str, np.ndarray]],
            feed: Optional[int] = None) -> Dict[int, Tuple]:
        """Feed whole traces through the engine, respecting backpressure
        (a tenant's feed pauses instead of shedding), and run to
        completion: round-robin submit → tick → flush.  Returns
        ``{tid: (indices, scores, alarms)}``.  The deployment entry points
        remain ``submit``/``step``/``flush``; this is the offline and
        benchmark loop."""
        feed = self.chunk if feed is None else int(feed)
        cursors = {t: 0 for t in traces}
        total = {t: len(tr["ts"]) for t, tr in traces.items()}
        while True:
            moved = False
            for t, tr in traces.items():
                if cursors[t] >= total[t]:
                    continue
                take = min(feed, total[t] - cursors[t], self.room(t))
                if take:
                    piece = {k: v[cursors[t]:cursors[t] + take]
                             for k, v in tr.items()}
                    self.submit(t, piece)
                    cursors[t] += take
                    moved = True
            self.step()
            if not moved and all(cursors[t] >= total[t] for t in traces):
                break
        self.flush()
        return {t: self.results(t) for t in traces}
