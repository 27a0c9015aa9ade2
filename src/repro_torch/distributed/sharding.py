"""Placement of the Peregrine path over a device mesh (port of the Peregrine
half of ``repro.distributed.sharding``).

Code names *logical* axes (``flow_shards``: the buckets of the bucketed FC
and the shards of the sharded tables; ``tenants``: the multi-tenant
engine's pool); the caller binds them to a mesh axis.  With no mesh or no
rule bound, nothing is placed and the same code runs on one device.

The mesh is single-controller, as in the JAX package: one process holds a
list of ``torch.device``s and queues each place's work on its device.
:func:`flow_mesh` takes ``devices=`` (repeats allowed), the stand-in for
XLA's ``--xla_force_host_platform_device_count``: ``["cpu"] * 4`` gives four
places on the CPU, ``["cuda:0"] * 4`` four places on one card.  A place is
an index along the bound axes, so places that share a device are still
counted apart.

:class:`ShardContext` carries what the JAX module runs inside ``shard_map``:
``scatter`` hands each place its slice of the leading (chunk) axis,
``map`` runs a function on every place's slice, ``gather_tails`` copies the
O(S) per-chunk tail summaries to every place (the one collective of the
bucketed scans), ``local_chunks`` slices a place's chunks back out, and
``join`` brings the places' results home.  The caller's tensors count as
lying on place 0; every byte handed from one place to another is counted
(:func:`transfer_counts`), whether or not the two places share a device.

The LM half: ``P`` (a PartitionSpec: a mesh-axis name, a tuple of them or
None a dimension), ``AxisRules.spec`` and ``logical_spec`` (logical names to
a ``P``), ``NamedSharding`` and ``named_shardings``, and ``Placed``: a tensor
held over the mesh as a spec cuts it, every place holding exactly its block
(replicated axes give copies).  :func:`place` cuts a tensor into a
``Placed``, :func:`gather` joins one again; both count the bytes they hand
between places.  ``lshard`` checks a logical annotation's rank and returns
its tensor unchanged: the port has no compiler that propagates layouts, so
the placed steps (``training/train_step.make_placed_train_step``,
``distributed/tensor_parallel.py``: the dense layers' compute split over the
model axis, the placed prefill and decode) and ``moe_ffn_local`` decide
where each block lives and runs.  ``at_place`` and ``work_scope`` say which
place and which part of a step the work inside belongs to (the dry run's
counts read them).  This module imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]

# Default production rules: batch over (pod, data); model-parallel dims over
# model; experts over model (EP); sequence sharding (decode long-context KV)
# over data.
PRODUCTION_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "expert_cap": ("pod", "data"),
    "vocab": "model",
    "embed": None,
    "seq": None,
    "kv_seq": None,          # overridden to ("pod", "data") for long-context
    "ssm_inner": "model",
    "opt": ("pod", "data"),  # ZeRO-1 optimizer-state axis
    # Peregrine flow-table partitions (core/sharded.py): the shard axis of
    # the hash-partitioned flow state spreads over the DP axes
    "flow_shards": ("pod", "data"),
    # Peregrine multi-tenant engine (serving/engine.py): the tenant lanes of
    # the tenant-batched fused step spread over the DP axes
    "tenants": ("pod", "data"),
}


class Mesh:
    """Devices laid out row-major over named axes, held by one process.

    ``devices``: ``prod(shape)`` ``torch.device``s (repeats allowed);
    ``shape``: ``{axis: size}`` in axis order, as ``jax.sharding.Mesh``.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = (len(self.devices),) if shape is None else tuple(shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"shape {sizes} does not name axes {self.axis_names}")
        n = 1
        for s in sizes:
            n *= s
        if n != len(self.devices) or n < 1:
            raise ValueError(f"shape {sizes} needs {n} devices, got "
                             f"{len(self.devices)}")
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, place: int) -> Dict[str, int]:
        """Place ``place``'s index along each axis (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            out[a] = place % self.shape[a]
            place //= self.shape[a]
        return out

    def place_at(self, coords: Dict[str, int]) -> int:
        """The place at ``coords`` (an axis left out is at 0): the inverse
        of :meth:`coords`."""
        flat = 0
        for a in self.axis_names:
            flat = flat * self.shape[a] + coords.get(a, 0)
        return flat

    def _key(self):
        return self.devices, self.axis_names, tuple(self.shape.values())

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _canonical(entry):
    """A spec entry as ``jax.sharding.PartitionSpec`` keeps it: a list or
    tuple of one name is the name, an empty one None."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """A PartitionSpec: for each dimension a mesh-axis name, a tuple of
    them (the dimension cut over their product, row-major) or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


class AxisRules:
    def __init__(self, rules: Dict[str, Axis]):
        self.rules = dict(rules)

    def spec(self, names: Sequence[Optional[str]]) -> P:
        return P(*[self.rules.get(n) if n else None for n in names])


class _State(threading.local):
    def __init__(self):
        self.rules: Optional[AxisRules] = None
        self.mesh: Optional[Mesh] = None


_STATE = _State()


@contextlib.contextmanager
def use_rules(rules: Optional[Dict[str, Axis]]):
    prev = _STATE.rules
    _STATE.rules = AxisRules(rules) if rules is not None else None
    try:
        yield _STATE.rules
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[AxisRules]:
    return _STATE.rules


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Bind ``mesh`` as the ambient mesh (``jax.set_mesh``)."""
    prev = _STATE.mesh
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def ambient_mesh() -> Optional[Mesh]:
    """The mesh bound by :func:`set_mesh`, or ``None``."""
    return _STATE.mesh


def _rule_binding(name: str):
    rules = current_rules()
    binding = rules.rules.get(name) if rules is not None else None
    if isinstance(binding, list):
        binding = tuple(binding)
    return binding


def flow_shards_binding():
    """The normalised ``flow_shards`` rule of the ambient axis rules, or
    ``None`` when unbound: where the bucketed and sharded FC place
    themselves (``core/bucketed._resolve_placement``)."""
    return _rule_binding("flow_shards")


def tenant_binding():
    """The normalised ``tenants`` rule, the mesh axis (or axes) a tenant
    pool spreads over (``core/state.init_state_stacked``), or ``None``."""
    return _rule_binding("tenants")


@contextlib.contextmanager
def without_rule(name: str):
    """The ambient rules with ``name`` unbound: a tenant's step runs whole
    on its home place, its FC not placed again over the mesh."""
    rules = current_rules()
    if rules is None or name not in rules.rules:
        yield rules
        return
    with use_rules({k: v for k, v in rules.rules.items() if k != name}) as r:
        yield r


# ---------------------------------------------------------------------------
# bytes handed between places, and the place a step's work runs on
# ---------------------------------------------------------------------------
_TRANSFERS = {"between_places": 0, "host_to_place": 0}
_KIND_BYTES: Dict[str, int] = {}
_KIND_COUNT: Dict[str, int] = {}
_SCOPED: Dict[str, Dict[str, Dict[str, int]]] = {}


def reset_transfer_counts() -> None:
    for k in _TRANSFERS:
        _TRANSFERS[k] = 0
    _KIND_BYTES.clear()
    _KIND_COUNT.clear()
    _SCOPED.clear()


def transfer_counts() -> Dict:
    """Bytes handed from one place to another (``between_places``) and from
    the host to a place (``host_to_place``) since
    :func:`reset_transfer_counts`; ``bytes`` and ``count`` split the
    hand-overs between places by kind (the caller's name for what moved),
    ``scoped`` the same inside each :func:`work_scope`."""
    return {**_TRANSFERS, "bytes": dict(_KIND_BYTES), "count": dict(_KIND_COUNT),
            "scoped": {k: {"bytes": dict(v["bytes"]), "count": dict(v["count"])}
                       for k, v in _SCOPED.items()}}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def count_transfer(t: torch.Tensor, src: Optional[int], dst: int,
                   kind: str = "other") -> None:
    """Count ``t``'s bytes as handed from place ``src`` (``None``: the host)
    to place ``dst``, under ``kind``; nothing when they are one place."""
    if src is None:
        _TRANSFERS["host_to_place"] += _nbytes(t)
    elif src != dst:
        n = _nbytes(t)
        _TRANSFERS["between_places"] += n
        _KIND_BYTES[kind] = _KIND_BYTES.get(kind, 0) + n
        _KIND_COUNT[kind] = _KIND_COUNT.get(kind, 0) + 1
        if _PLACE.scope is not None:
            sc = _SCOPED.setdefault(_PLACE.scope, {"bytes": {}, "count": {}})
            sc["bytes"][kind] = sc["bytes"].get(kind, 0) + n
            sc["count"][kind] = sc["count"].get(kind, 0) + 1


class _Place(threading.local):
    def __init__(self):
        self.place: Optional[int] = None      # the place whose share runs now
        self.forced = False                   # a copy landing on ``place``
        self.alias = False                    # ... that one card would not make
        self.scope: Optional[str] = None      # the step's part running now


_PLACE = _Place()


@contextlib.contextmanager
def work_scope(name: Optional[str]):
    """The step's work inside is of part ``name``: ``"replica"`` (a data
    replica's work on its own places) or ``"sink"`` (a replica's results
    handed to place 0).  Hand-overs inside are counted apart too
    (``transfer_counts()["scoped"]``); the dry run reads it to run one
    replica of several alike (``launch/dryrun.py``)."""
    prev = _PLACE.scope
    _PLACE.scope = name
    try:
        yield
    finally:
        _PLACE.scope = prev


def current_scope() -> Optional[str]:
    return _PLACE.scope


@contextlib.contextmanager
def at_place(place: Optional[int], forced: bool = False, alias: bool = False):
    """The work inside runs on mesh place ``place``: what it creates lives
    there.  ``forced``: even what it makes from tensors of other places (a
    copy landing on ``place``); ``alias``: a copy that places sharing one
    card would not make (a hand-over on the meta device).  Read by the dry
    run's memory count (``launch/dryrun.py``); nothing else depends on it."""
    prev = _PLACE.place, _PLACE.forced, _PLACE.alias
    _PLACE.place, _PLACE.forced, _PLACE.alias = place, forced, alias
    try:
        yield
    finally:
        _PLACE.place, _PLACE.forced, _PLACE.alias = prev


def current_place() -> Tuple[Optional[int], bool, bool]:
    """(the place set by :func:`at_place`, whether forced, whether an
    alias)."""
    return _PLACE.place, _PLACE.forced, _PLACE.alias


def _to(t: torch.Tensor, device, copy: bool = False) -> torch.Tensor:
    """``t`` on ``device``; a copy to a card does not wait for the host (a
    copy to the CPU must)."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda", copy=copy)


class _Hand(torch.autograd.Function):
    """A hand-over that carries autograd: the gradient goes back from
    ``dst`` to ``src`` and is counted as handed, under ``kind + "_grad"``."""

    @staticmethod
    def forward(ctx, t, src, dst, device, kind):
        ctx.back = (t.device, src, dst, kind)
        out = _moved(t, src, dst, device)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        device, src, dst, kind = ctx.back
        count_transfer(g, dst, src, kind + "_grad")
        return _moved(g, dst, src, device), None, None, None, None


def _moved(t, src, dst, device) -> torch.Tensor:
    """``t`` on ``device`` as it lands on place ``dst``.  On the meta device
    (the dry run), a hand-over between two places is a new tensor, as it
    would be between two cards; on one card it is the same memory."""
    device = torch.device(device)
    copy = device.type == "meta" and src != dst
    with at_place(dst, forced=True, alias=copy):
        return _to(t, device, copy=copy)


def hand(t: torch.Tensor, src: Optional[int], dst: int, device,
         kind: str = "other") -> torch.Tensor:
    """``t`` on ``device``, counted as handed from place ``src`` (``None``:
    the host) to place ``dst`` under ``kind``; under autograd its gradient
    is handed back, counted too."""
    count_transfer(t, src, dst, kind)
    if torch.is_grad_enabled() and t.requires_grad:
        return _Hand.apply(t, src, dst, device, kind)
    return _moved(t, src, dst, device)


class ShardContext:
    """Resolved placement of a leading axis over the bound mesh axes.

    ``size`` places, place ``i`` on ``devices[i]`` (other axes of the mesh
    at index 0).  Built once per (mesh, binding) and cached
    (``core/bucketed._shard_ctx``).
    """

    def __init__(self, mesh: Mesh, binding):
        self.mesh = mesh
        self.binding = binding
        self.axes: Tuple[str, ...] = (binding if isinstance(binding, tuple)
                                      else (binding,))
        size = 1
        for a in self.axes:
            size *= mesh.shape[a]
        self.size = size
        names = mesh.axis_names
        strides = {}
        s = 1
        for a in reversed(names):
            strides[a] = s
            s *= mesh.shape[a]
        devices = []
        for i in range(size):
            flat, rest = 0, i
            for a in reversed(self.axes):
                flat += (rest % mesh.shape[a]) * strides[a]
                rest //= mesh.shape[a]
            devices.append(mesh.devices[flat])
        self.devices: Tuple[torch.device, ...] = tuple(devices)

    def to_place(self, t: torch.Tensor, dst: int, src: Optional[int] = 0
                 ) -> torch.Tensor:
        """``t`` on place ``dst``'s device, counted as handed from ``src``."""
        return hand(t, src, dst, self.devices[dst], "flow")

    def scatter(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Each place's equal slice of ``t``'s leading axis, on its device."""
        n_local = t.shape[0] // self.size
        return [self.to_place(t[i * n_local:(i + 1) * n_local], i)
                for i in range(self.size)]

    def map(self, fn: Callable, *per_place):
        """``fn`` on every place's arguments (lists from :meth:`scatter`),
        in place order: the per-place body of ``shard_map``."""
        return [fn(*args) for args in zip(*per_place)]

    def gather_tails(self, tails: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-place ``(chunks/size, ...)`` tail summaries -> the global
        ``(chunks, ...)`` on every place, in chunk order: the one collective
        the bucketed scans pay, O(S) elements."""
        return [torch.cat([self.to_place(t, i, src=j)
                           for j, t in enumerate(tails)])
                for i in range(self.size)]

    def local_chunks(self, x: torch.Tensor, place: int, n_local: int
                     ) -> torch.Tensor:
        """Place ``place``'s ``n_local`` chunks of a combined ``(chunks,
        ...)`` array (the inverse of :meth:`gather_tails`)."""
        return x[place * n_local:(place + 1) * n_local]

    def to_home(self, t: torch.Tensor, src: int, device) -> torch.Tensor:
        """Place ``src``'s ``t`` on ``device``, the caller's (place 0)."""
        return hand(t, src, 0, device, "flow")

    def join(self, parts: Sequence[torch.Tensor], device, dim: int = 0
             ) -> torch.Tensor:
        """The places' parts, in place order, concatenated along ``dim`` on
        ``device``, the caller's (place 0)."""
        return torch.cat([self.to_home(p, j, device) for j, p in enumerate(parts)],
                         dim)


def resolve_placement(binding, count: Optional[int] = None
                      ) -> Tuple[Optional[Mesh], Axis]:
    """(mesh, binding) placing an axis of ``count`` over the ambient mesh,
    or (None, None): no mesh bound, ``binding`` unbound, an axis the mesh
    lacks, or ``count`` not a multiple of the places."""
    if binding is None:
        return None, None
    mesh = ambient_mesh()
    if mesh is None:
        return None, None
    axes = binding if isinstance(binding, tuple) else (binding,)
    if not all(a in mesh.axis_names for a in axes):
        return None, None
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if size < 1 or (count is not None and count % size):
        return None, None
    return mesh, binding


@functools.lru_cache(maxsize=None)
def shard_context(mesh: Optional[Mesh], binding) -> Optional[ShardContext]:
    """The cached :class:`ShardContext` of (mesh, binding), or ``None``
    when unplaced."""
    if mesh is None:
        return None
    return ShardContext(mesh, binding)


def tenant_placement() -> Optional[ShardContext]:
    """Where a tenant pool built now spreads its tenants: the ambient
    ``tenants`` rule on the ambient mesh (any tenant count), or ``None``."""
    return shard_context(*resolve_placement(tenant_binding()))


def _default_devices(n_devices: Optional[int]) -> List[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise RuntimeError(
            f"flow_mesh needs {n if n_devices is not None else 'a'} CUDA "
            f"device(s), {count} visible; pass devices=['cpu'] * N to place "
            "on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


@contextlib.contextmanager
def flow_mesh(n_devices: Optional[int] = None, axis: str = "data",
              rules: Optional[Dict[str, Axis]] = None,
              devices: Optional[Sequence] = None):
    """Bind an N-place mesh with the Peregrine placement rules in one shot.

    Builds a 1-D mesh on logical axis ``axis`` over ``devices`` (default:
    ``cuda:0`` .. ``cuda:{n_devices-1}``, every card when ``n_devices`` is
    None; raises without a card), sets it ambient, and binds
    ``{"flow_shards": axis, "tenants": axis}`` (override with ``rules``):
    the two rules the bucketed and sharded FC and the tenant pool place
    themselves by.  ``devices`` may repeat a device (``["cpu"] * 4``).
    """
    if devices is None:
        devices = _default_devices(n_devices)
    elif n_devices is not None and int(n_devices) != len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices given")
    mesh = Mesh(devices, (axis,))
    with contextlib.ExitStack() as es:
        es.enter_context(set_mesh(mesh))
        es.enter_context(use_rules(
            {"flow_shards": axis, "tenants": axis} if rules is None
            else rules))
        yield mesh


# ---------------------------------------------------------------------------
# the LM half: logical specs, shardings and placed tensors
# ---------------------------------------------------------------------------
def logical_spec(names: Sequence[Optional[str]]) -> P:
    r = _STATE.rules
    if r is None:
        return P(*[None] * len(names))
    return r.spec(names)


def lshard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """JAX's sharding constraint on logical axis ``names``: with rules bound
    it checks that ``x`` has one name a dimension, and returns ``x``
    unchanged either way.  The port has no compiler to propagate a layout
    from it; the placed steps split the compute themselves
    (``distributed/tensor_parallel.py``)."""
    if _STATE.rules is not None and x.dim() != len(names):
        raise ValueError(f"lshard: {tuple(x.shape)} against names {names}")
    return x


class NamedSharding:
    """A spec ``P`` bound to a ``Mesh`` (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((self.mesh, self.spec))

    def __repr__(self):
        return f"NamedSharding({self.spec!r}, {self.mesh!r})"


def named_shardings(mesh: Mesh, t):
    """``P`` leaves -> ``NamedSharding(mesh, spec)``; ``None`` leaves pass
    through (nothing placed)."""
    if isinstance(t, P):
        return NamedSharding(mesh, t)
    if isinstance(t, dict):
        return {k: named_shardings(mesh, v) for k, v in t.items()}
    if type(t) in (list, tuple):
        return type(t)(named_shardings(mesh, v) for v in t)
    return t


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_slices(sharding: NamedSharding, shape, place: int) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that place ``place`` holds.
    Raises ``ValueError`` for a spec longer than the shape, an axis the mesh
    lacks or names twice, or a dimension its axes do not divide."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    used = [a for e in spec for a in _spec_axes(e)]
    if len(set(used)) != len(used) or not set(used) <= set(mesh.axis_names):
        raise ValueError(f"spec {spec} against mesh axes {mesh.axis_names}")
    coords = mesh.coords(place)
    out = []
    for dim, size in enumerate(shape):
        n, idx = 1, 0
        for a in _spec_axes(spec[dim] if dim < len(spec) else None):
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not divide "
                             f"over {n} places (spec {spec})")
        b = size // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


class Placed:
    """A tensor of ``shape`` held over ``sharding.mesh``: ``blocks[i]`` is
    exactly place i's block as the spec cuts it, on ``mesh.devices[i]``
    (places on a replicated axis hold copies of one block)."""

    def __init__(self, blocks: List[torch.Tensor], shape, sharding: NamedSharding):
        self.blocks = list(blocks)
        self.shape = torch.Size(shape)
        self.sharding = sharding

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def slices(self, place: int) -> Tuple[slice, ...]:
        return block_slices(self.sharding, self.shape, place)

    def __repr__(self):
        return f"Placed({tuple(self.shape)}, {self.dtype}, {self.sharding.spec!r})"


def place(t: torch.Tensor, sharding: NamedSharding, src: Optional[int] = 0) -> Placed:
    """``t`` cut by ``sharding``: every place gets its own copy of its
    block on its device, counted as handed from place ``src`` (``None``:
    the host)."""
    mesh = sharding.mesh
    blocks = []
    for i, dev in enumerate(mesh.devices):
        b = t[block_slices(sharding, t.shape, i)]
        count_transfer(b, src, i, "place")
        with at_place(i, forced=True):
            blocks.append(b.to(dev, copy=True, memory_format=torch.contiguous_format,
                               non_blocking=dev.type == "cuda"))
    return Placed(blocks, t.shape, sharding)


def gather(p: Placed, device, dst: Optional[int] = 0) -> torch.Tensor:
    """The whole tensor on ``device``, counted as landing on place ``dst``
    (``None``: the host, not counted): each block taken from ``dst`` where
    it holds it, else from its first holder."""
    with at_place(dst, forced=True):
        out = torch.empty(p.shape, dtype=p.dtype, device=device)
    done = set()
    for i in range(len(p.blocks)):
        sl = p.slices(i)
        if sl in done:
            continue
        done.add(sl)
        j = dst if dst is not None and p.slices(dst) == sl else i
        if dst is not None:
            count_transfer(p.blocks[j], j, dst, "gather")
        out[sl].copy_(p.blocks[j])
    return out

