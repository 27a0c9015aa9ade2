"""Flow-state tables and flow-key hashing (port of ``repro.core.state``).

Slots are direct-indexed by ``hash(flow_key) % n_slots`` with no collision
resolution, exactly like the switch's register arrays (DESIGN.md §1).  Four
decay instances per atom (lambda = 10, 1, 1/10, 1/60).

The state is a dict of device tensors with the JAX package's shapes.  The
feature step updates these tensors in place; that takes the place of the
JAX package's buffer donation (DESIGN.md §8): a caller that needs a restore
point clones the tensors (``clone_state``) before the step.

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
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

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
    return {g: ({k: t.clone() for k, t in v.items()} if isinstance(v, dict)
                else v.clone()) for g, v in state.items()}


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


def hash_fields(fields, salt: int) -> torch.Tensor:
    """uint32 multiply-xorshift hash of a tuple of uint32 fields (held in
    int64 tensors); returns int64 values in [0, 2^32)."""
    h = torch.full_like(fields[0], (salt ^ _FNV) & _MASK32, dtype=torch.int64)
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
