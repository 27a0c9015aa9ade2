"""Flow-state tables and flow-key hashing (port of ``repro.core.state``).

Slots are direct-indexed by ``hash(flow_key) % n_slots`` with no collision
resolution, exactly like the switch's register arrays (DESIGN.md §1).  Four
decay instances per atom (lambda = 10, 1, 1/10, 1/60).

The state is a dict of device tensors with the JAX package's shapes.  The
feature step updates these tensors in place; that takes the place of the
JAX package's buffer donation (DESIGN.md §8): a caller that needs a restore
point clones the tensors (``clone_state``) before the step.

The multi-tenant engine keeps N tenants' tables as one pool
(``init_state_stacked``, :class:`StatePool`): every table gains a leading
tenant axis, so tenant t's state is the contiguous view ``pool[g][k][t]``
(``tenant_view``) and the tenant-batched FC kernel writes the pool in place.
Built under a bound ``tenants`` rule (``distributed.sharding.flow_mesh``),
the pool is a :class:`PlacedPool`: tenant t's tables live on place ``t %
D`` for the pool's life, one stacked dict a place.

The layout is pluggable (DESIGN.md §11): ``init_state(n, state_backend=...)``
selects a registered :class:`StateBackend`, ``dense`` (the direct-indexed
slot tables below, the default) or ``sketch`` (Count-Min rows with
conservative update, ``core/sketch.py``).  ``compute_features`` and the
fused step identify a state's layout structurally (``state_spec_of``) and
route accordingly.

Hashing runs on int64 tensors that hold uint32 values: every product is
split so that it stays below 2^63, and masked back to 32 bits, which keeps
the slot mapping bit-identical to the JAX package's uint32 arithmetic.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import tenant_placement

LAMBDAS = (10.0, 1.0, 0.1, 1.0 / 60.0)
N_DECAY = len(LAMBDAS)

# key types
UNI_KEYS = ("src_mac_ip", "src_ip")            # unidirectional stats
BI_KEYS = ("channel", "socket")                # bidirectional stats
N_UNI, N_BI = len(UNI_KEYS), len(BI_KEYS)

UNI_STATS = ("w", "mean", "std")
BI_STATS = ("w", "mean", "std", "magnitude", "radius", "cov", "pcc")
N_FEATURES = N_UNI * N_DECAY * len(UNI_STATS) + N_BI * N_DECAY * len(BI_STATS)

FEATURE_NAMES = tuple(
    f"{k}:{lam}:{s}"
    for k in UNI_KEYS for lam in LAMBDAS for s in UNI_STATS
) + tuple(
    f"{k}:{lam}:{s}"
    for k in BI_KEYS for lam in LAMBDAS for s in BI_STATS
)

# per-key-type base hash salts
KEY_SALTS = {"src_mac_ip": 1, "src_ip": 2, "channel": 3, "socket": 4}

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
_FNV = 0x811C9DC5


# ---------------------------------------------------------------------------
# State-backend registry
# ---------------------------------------------------------------------------
class StateBackend(NamedTuple):
    """One pluggable flow-state layout."""
    name: str
    #: (n_slots, device=..., **cfg) -> fresh state dict
    init: Callable[..., Dict]
    #: state -> slot count (dense) / table width (sketch), from shapes
    slots: Callable[[Dict], int]
    #: state -> does this dict belong to this layout?  Key presence only.
    matches: Callable[[Dict], bool]
    #: state -> everything ``init`` needs besides ``n_slots`` and the device
    config: Callable[[Dict], Dict]
    #: (state, pkts, mode=..., fc_backend=...) -> (state, feats) for layouts
    #: whose update does not go through the FC registry; None for dense
    compute: Optional[Callable] = None


_STATE_BACKENDS: Dict[str, StateBackend] = {}

# layouts that register themselves when their module is first imported
_LAZY_STATE_MODULES = {"sketch": "repro_torch.core.sketch"}


def register_state_backend(backend: StateBackend) -> StateBackend:
    _STATE_BACKENDS[backend.name] = backend
    return backend


def available_state_backends() -> Tuple[str, ...]:
    return tuple(sorted(set(_STATE_BACKENDS) | set(_LAZY_STATE_MODULES)))


def resolve_state_backend(name: str) -> StateBackend:
    """The registered :class:`StateBackend` for ``name`` (importing a lazy
    layout's module first); raises on unknown names."""
    if name not in _STATE_BACKENDS and name in _LAZY_STATE_MODULES:
        importlib.import_module(_LAZY_STATE_MODULES[name])
    if name not in _STATE_BACKENDS:
        raise ValueError(f"unknown state backend {name!r}; "
                         f"available: {available_state_backends()}")
    return _STATE_BACKENDS[name]


def state_spec_of(state: Dict) -> StateBackend:
    """The :class:`StateBackend` a state dict belongs to, by its keys."""
    for name in available_state_backends():
        spec = resolve_state_backend(name)
        if spec.matches(state):
            return spec
    raise ValueError("state dict matches no registered state backend "
                     f"(available: {available_state_backends()})")


def state_backend_of(state: Dict) -> str:
    return state_spec_of(state).name


def state_config(state: Dict) -> Dict:
    """Keyword arguments that rebuild a fresh state of the same layout with
    ``init_state(n_slots, state_backend=..., **cfg)``."""
    return dict(state_spec_of(state).config(state))


def init_state(n_slots: int, state_backend: str = "dense",
               device: DeviceLike = None, **state_kw) -> Dict:
    """Fresh flow tables of the selected layout on ``device`` (default
    ``cuda``).

    ``dense`` (default): direct-indexed slot tables, see ``_dense_init``.
    ``sketch``: Count-Min tables of width ``n_slots`` (``core/sketch.py``);
    pass ``rows=R`` and ``evict_age=seconds``.
    """
    return resolve_state_backend(state_backend).init(
        n_slots, device=resolve_device(device), **state_kw)


def _dense_init(n_slots: int, device: torch.device
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Uni tables are (N_UNI, n_slots, N_DECAY); bi tables carry a direction
    axis (N_BI, n_slots, 2, N_DECAY) plus channel-level SR state.  The
    ``rr`` round-robin counters belong to switch mode and are only carried.
    """
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def neg(*shape):
        return torch.full(shape, -1.0, dtype=torch.float32, device=device)

    return {
        "uni": {
            "last_t": neg(N_UNI, n_slots, N_DECAY),
            "w": z(N_UNI, n_slots, N_DECAY),
            "ls": z(N_UNI, n_slots, N_DECAY),
            "ss": z(N_UNI, n_slots, N_DECAY),
            "rr": z(N_UNI, n_slots, dtype=torch.int32),
        },
        "bi": {
            "last_t": neg(N_BI, n_slots, 2, N_DECAY),
            "w": z(N_BI, n_slots, 2, N_DECAY),
            "ls": z(N_BI, n_slots, 2, N_DECAY),
            "ss": z(N_BI, n_slots, 2, N_DECAY),
            "sr": z(N_BI, n_slots, N_DECAY),
            "sr_last_t": neg(N_BI, n_slots, N_DECAY),
            "res_last": z(N_BI, n_slots, 2, N_DECAY),
            "rr": z(N_BI, n_slots, dtype=torch.int32),
        },
    }


register_state_backend(StateBackend(
    name="dense",
    init=_dense_init,
    slots=lambda s: s["uni"]["w"].shape[1],
    # rr counters exist only in the dense layout (round-robin switch mode)
    matches=lambda s: isinstance(s, dict) and "rr" in s.get("uni", {}),
    config=lambda s: {},
))


def state_slots(state: Dict) -> int:
    """Slot count (dense) or table width (sketch), read from the shapes."""
    return state_spec_of(state).slots(state)


def state_device(state: Dict) -> torch.device:
    # every layout keeps its uni atoms under uni/w
    return state["uni"]["w"].device


def clone_state(state: Dict) -> Dict:
    """A copy of every table (and of the sketch's ``evict_age``): the
    restore point for an in-place step."""
    return _map_state(torch.Tensor.clone, state)


def _leaves(state: Dict):
    """(group, key, tensor) of every table, and of a sketch's ``evict_age``
    (group ``None``), in a fixed order."""
    for g, v in state.items():
        if isinstance(v, dict):
            for k, t in v.items():
                yield g, k, t
        else:
            yield None, g, v


def _map_state(fn, state: Dict) -> Dict:
    return {g: ({k: fn(t) for k, t in v.items()} if isinstance(v, dict)
                else fn(v)) for g, v in state.items()}


class PlacedPool:
    """A stacked pool spread over the places of a mesh: tenant t lives on
    place ``t % D`` at index ``t // D`` of that place's stacked dict
    (``parts[t % D]``, on ``ctx.devices[t % D]``), for the pool's life.
    Round robin, so the lowest tenants a pool hands out first spread over
    every place; a tenant count need not divide the places."""

    def __init__(self, parts: List[Dict], ctx):
        self.parts = parts
        self.ctx = ctx

    @property
    def size(self) -> int:
        return self.ctx.size

    def home(self, tid: int) -> Tuple[int, int]:
        """(place, index in the place's stacked dict) of tenant ``tid``."""
        return tid % self.size, tid // self.size

    def groups(self, tids: Sequence[int]) -> List[Tuple[int, List[int], List[int]]]:
        """The lanes of ``tids`` by home place, places in order: ``(place,
        lane positions, tenants' indices on the place)`` for each place
        that holds one of them."""
        out = []
        for p in range(self.size):
            lanes = [j for j, t in enumerate(tids) if t % self.size == p]
            if lanes:
                out.append((p, lanes, [tids[j] // self.size for j in lanes]))
        return out


def _stacked(n_tenants: int, one: Dict) -> Dict:
    return _map_state(lambda t: t[None].expand((n_tenants,) + t.shape).clone(),
                      one)


def init_state_stacked(n_tenants: int, n_slots: int,
                       state_backend: str = "dense", device: DeviceLike = None,
                       **state_kw):
    """N fresh flow-table states as ONE stacked dict (a leading tenant axis
    on every table, and on a sketch's ``evict_age``): the single-allocation
    layout :class:`StatePool` manages.  Dense: ``uni/*`` (T, N_UNI, n_slots,
    N_DECAY), ``bi/*`` (T, N_BI, n_slots, 2, N_DECAY).

    Under a bound ``tenants`` rule the pool is a :class:`PlacedPool`: place
    p's stacked dict holds tenants p, p + D, ... on the place's device (the
    mesh's devices, not ``device``)."""
    ctx = tenant_placement()
    if ctx is None:
        return _stacked(n_tenants, init_state(n_slots, state_backend=state_backend,
                                              device=device, **state_kw))
    return PlacedPool([_stacked(len(range(p, n_tenants, ctx.size)),
                                init_state(n_slots, state_backend=state_backend,
                                           device=dev, **state_kw))
                       for p, dev in enumerate(ctx.devices)], ctx)


def tenant_view(pool, tid: int) -> Dict:
    """Tenant ``tid``'s state in a stacked (or placed) pool as views (same
    storage, on its home place): a step on it updates the pool in place."""
    if isinstance(pool, PlacedPool):
        p, tid = pool.home(tid)
        pool = pool.parts[p]
    return _map_state(lambda t: t[tid], pool)


class StatePool:
    """Bounded pool of per-tenant flow-table states, stacked on the device.

    The pool owns ``n_tenants`` tenant slots stored as one stacked dict
    (``init_state_stacked``): each table carries a leading tenant axis, so
    the whole pool is a single allocation per table, not N, and the
    tenant-batched step (serving/fused.py) advances any subset of tenant
    states in place without the states ever mixing.

    Lifecycle: ``alloc()`` claims a free slot (its state is freshly
    reset), ``free(tid)`` releases it, ``reset(tid)`` zeroes a live
    tenant's tables in place (a new capture on the same slot).  The stacked
    dict lives at ``pool.stacked``; a step updates it in place.  Built
    under a bound ``tenants`` rule, ``pool.stacked`` is a
    :class:`PlacedPool` and every tenant keeps its home place: ``reset``,
    ``read`` and ``write`` act there.
    """

    def __init__(self, n_tenants: int, n_slots: int,
                 state_backend: str = "dense", device: DeviceLike = None,
                 **state_kw):
        if n_tenants < 1:
            raise ValueError(f"need at least one tenant slot, got {n_tenants}")
        self.n_tenants = int(n_tenants)
        self.n_slots = int(n_slots)
        self.device = resolve_device(device)
        self.state_backend = resolve_state_backend(state_backend).name
        self.state_kw = dict(state_kw)
        self.stacked = init_state_stacked(n_tenants, n_slots,
                                          state_backend=self.state_backend,
                                          device=self.device, **self.state_kw)
        self._live: List[bool] = [False] * n_tenants
        # one fresh single-tenant state (a place) kept as the reset
        # template so reset() never rebuilds it per call
        devices = (self.stacked.ctx.devices if self.placed else (self.device,))
        self._fresh = [init_state(n_slots, state_backend=self.state_backend,
                                  device=dev, **self.state_kw) for dev in devices]
        # pristine[t] <=> slot t is known to hold a fresh state, letting
        # alloc() skip the copy a reset costs; anything that writes a slot
        # outside reset() must clear the flag (write() and the engine's
        # dispatch do: mark_dirty)
        self._pristine: List[bool] = [True] * n_tenants

    @property
    def placed(self) -> bool:
        return isinstance(self.stacked, PlacedPool)

    # ---- slot lifecycle ----
    @property
    def live(self) -> Tuple[int, ...]:
        """Currently allocated tenant ids, ascending."""
        return tuple(t for t, on in enumerate(self._live) if on)

    @property
    def free_slots(self) -> int:
        return self.n_tenants - len(self.live)

    def alloc(self) -> int:
        """Claim the lowest free tenant slot (freshly reset); raises
        ``RuntimeError`` when the pool is exhausted: the caller decides
        whether that means shed, queue, or grow a new pool."""
        for t, on in enumerate(self._live):
            if not on:
                self._live[t] = True
                if not self._pristine[t]:
                    self.reset(t)
                return t
        raise RuntimeError(
            f"StatePool exhausted: all {self.n_tenants} tenant slots live")

    def free(self, tid: int) -> None:
        """Release a tenant slot.  The table reset is deferred to the next
        ``alloc`` of the slot (pristine tracking), so detach is O(1) and a
        later alloc still always starts clean."""
        self._check(tid)
        self._live[tid] = False

    def reset(self, tid: int) -> None:
        """Zero tenant ``tid``'s flow tables in place (fresh capture)."""
        if not 0 <= tid < self.n_tenants:
            raise IndexError(f"tenant {tid} out of range 0..{self.n_tenants - 1}")
        self._install(tid, self._fresh[self.stacked.home(tid)[0]
                                       if self.placed else 0])
        self._pristine[tid] = True

    def mark_dirty(self, tids) -> None:
        """Record that ``tids``' slots no longer hold fresh state.  Callers
        that step ``pool.stacked`` directly (the engine's dispatch does)
        must call this so a freed slot's next alloc knows to reset it."""
        for t in tids:
            self._pristine[int(t)] = False

    def _check(self, tid: int) -> None:
        if not 0 <= tid < self.n_tenants:
            raise IndexError(f"tenant {tid} out of range 0..{self.n_tenants - 1}")
        if not self._live[tid]:
            raise KeyError(f"tenant {tid} is not allocated")

    def _install(self, tid: int, state: Dict) -> None:
        pairs = []
        for g, k, dst in _leaves(tenant_view(self.stacked, tid)):
            src = (state.get(g, {}) if g is not None else state).get(k)
            if src is None or tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"state does not match the pool's layout at {g}/{k} "
                    f"({self.state_backend}, {self.n_slots} slots)")
            pairs.append((dst, src))
        for dst, src in pairs:
            dst.copy_(src)

    # ---- state access ----
    def read(self, tid: int) -> Dict:
        """A standalone COPY of tenant ``tid``'s state (safe to keep across
        later steps of the pool), on its home place."""
        self._check(tid)
        return _map_state(torch.Tensor.clone, tenant_view(self.stacked, tid))

    def write(self, tid: int, state: Dict) -> None:
        """Install a copy of a single-tenant state into slot ``tid``."""
        self._check(tid)
        self._install(tid, state)
        self._pristine[tid] = False


# ---------------------------------------------------------------------------
# Flow-key hashing (CRC-like mix, vectorised)
# ---------------------------------------------------------------------------
def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 tensors holding uint32 values.  The
    product is split at bit 16 of ``c`` so no partial product reaches 2^49."""
    hi = (h * (c >> 16)) & 0xFFFF
    return ((hi << 16) + h * (c & 0xFFFF)) & _MASK32


def _mix(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    h = _mul32(h ^ v, _GOLDEN)
    return h ^ (h >> 15)


def hash_fields(fields, salt) -> torch.Tensor:
    """uint32 multiply-xorshift hash of a tuple of uint32 fields (held in
    int64 tensors); returns int64 values in [0, 2^32).  ``salt`` is an int,
    or a sequence of S ints: then the S hashes come from one pass over the
    fields, stacked on a new leading axis."""
    one = isinstance(salt, int)
    inits = [torch.full_like(fields[0], (s ^ _FNV) & _MASK32, dtype=torch.int64)
             for s in ((salt,) if one else salt)]
    h = inits[0] if one else torch.stack(inits)
    for f in fields:
        h = _mix(h, f.to(torch.int64) & _MASK32)
    return h


def key_fields(pkts) -> Tuple[Dict[str, Tuple], torch.Tensor]:
    """Canonicalised per-key-type hash-field tuples + channel dir bit.

    Addresses and ports are uint32 values held in int64 tensors, so the
    ``src < dst`` canonicalisation compares them unsigned.
    """
    src, dst = pkts["src"], pkts["dst"]
    sport, dport = pkts["sport"], pkts["dport"]
    lo_is_src = (src < dst) | ((src == dst) & (sport <= dport))
    ip_lo = torch.where(lo_is_src, src, dst)
    ip_hi = torch.where(lo_is_src, dst, src)
    p_lo = torch.where(lo_is_src, sport, dport)
    p_hi = torch.where(lo_is_src, dport, sport)
    fields = {
        "src_mac_ip": (src,),
        "src_ip": (src,),
        "channel": (ip_lo, ip_hi),
        "socket": (ip_lo, ip_hi, p_lo, p_hi, pkts["proto"]),
    }
    return fields, (~lo_is_src).to(torch.int64)


def packet_slots(pkts: Dict[str, torch.Tensor],
                 n_slots: int) -> Dict[str, torch.Tensor]:
    """Per-packet slot indices (int64) + channel direction bit.

    Channel/socket keys are canonicalised (min/max endpoint) so both
    directions land in the same slot; ``dir`` = 0 if src is the canonical
    low endpoint else 1.  Equal IPs break the tie on ports.
    """
    fields, dirb = key_fields(pkts)
    out = {k: hash_fields(f, KEY_SALTS[k]) % n_slots
           for k, f in fields.items()}
    out["dir"] = dirb
    return out


# ---------------------------------------------------------------------------
# Dense-path slot-collision telemetry: the host count (numpy, as in the JAX
# package) and the device count the engine runs, equal lane by lane
# ---------------------------------------------------------------------------
# salt for the collision fingerprint: independent of every table salt
# (KEY_SALTS and the sketch row salts), so two flows sharing a slot almost
# never share a fingerprint
_FP_SALT = 0x7F4A7C15


def np_hash_fields(fields, salt: int) -> np.ndarray:
    """Numpy twin of :func:`hash_fields` on uint32 values, bit for bit: the
    host count :func:`slot_collisions` hashes with it."""
    h = np.full(np.shape(fields[0]), np.uint32((salt ^ _FNV) & _MASK32), np.uint32)
    for f in fields:
        h = (h ^ np.asarray(f, np.uint32)) * np.uint32(_GOLDEN)
        h = h ^ (h >> np.uint32(15))
    return h


def _np_key_fields(pkts) -> Dict[str, Tuple]:
    src = np.asarray(pkts["src"])
    dst = np.asarray(pkts["dst"])
    sport = np.asarray(pkts["sport"])
    dport = np.asarray(pkts["dport"])
    lo_is_src = (src < dst) | ((src == dst) & (sport <= dport))
    ip_lo = np.where(lo_is_src, src, dst)
    ip_hi = np.where(lo_is_src, dst, src)
    p_lo = np.where(lo_is_src, sport, dport)
    p_hi = np.where(lo_is_src, dport, sport)
    return {
        "src_mac_ip": (src,),
        "src_ip": (src,),
        "channel": (ip_lo, ip_hi),
        "socket": (ip_lo, ip_hi, p_lo, p_hi, np.asarray(pkts["proto"])),
    }


def slot_collisions(pkts: Dict[str, np.ndarray],
                    n_slots: int) -> Dict[str, int]:
    """Distinct flow keys aliased onto an occupied slot in this chunk.

    Per key type: hash every packet to its dense slot, fingerprint the flow
    key with an independent salt, and count ``distinct (slot, key) pairs -
    distinct slots``, i.e. how many distinct flows merged into a slot some
    other flow already claims.  0 everywhere <=> the chunk was
    collision-free.  Pure numpy on the host.
    """
    out = {}
    total = 0
    for name, f in _np_key_fields(pkts).items():
        slot = np_hash_fields(f, KEY_SALTS[name]) % np.uint32(n_slots)
        fp = np_hash_fields(f, _FP_SALT)
        pair = slot.astype(np.uint64) << np.uint64(32) | fp.astype(np.uint64)
        c = int(np.unique(pair).size - np.unique(slot).size)
        out[name] = c
        total += c
    out["total"] = total
    return out


def slot_collisions_lanes(pkts: Dict[str, torch.Tensor],
                          n_slots: int) -> torch.Tensor:
    """:func:`slot_collisions`' ``total`` for every lane of ``(L, chunk)``
    packet tensors at once, on their device: an int64 ``(L,)`` tensor, and
    no host sync.  Each key type's ``(slot, fingerprint)`` pairs (both
    hashes from one pass, ``slot << 32 | fp``) are sorted within the lane,
    all key types in one sort; a flow key aliased onto a claimed slot is
    an adjacent pair that differs while its slot does not."""
    fields, _ = key_fields(pkts)
    pairs = []
    for name, f in fields.items():
        slot, fp = hash_fields(f, (KEY_SALTS[name], _FP_SALT))
        pairs.append(((slot % n_slots) << 32) | fp)
    s = torch.stack(pairs).sort(dim=-1).values
    merged = (s[..., 1:] != s[..., :-1]) & ((s[..., 1:] >> 32) == (s[..., :-1] >> 32))
    return merged.sum(dim=(0, -1))
