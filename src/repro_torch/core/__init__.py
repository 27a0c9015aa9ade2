"""Peregrine core in PyTorch: flow state (dense and Count-Min sketch layouts),
hashing, serial, scan, bucketed and sharded feature computation, the FC
backend registry and record sampling."""
from repro_torch.core.state import (  # noqa: F401
    FEATURE_NAMES, LAMBDAS, N_DECAY, N_FEATURES, clone_state, init_state,
    packet_slots, state_slots,
)
from repro_torch.core.pipeline import process_serial  # noqa: F401
from repro_torch.core.parallel import process_parallel  # noqa: F401
from repro_torch.core.bucketed import process_bucketed  # noqa: F401
from repro_torch.core.sharded import process_sharded  # noqa: F401
from repro_torch.core.backends import (  # noqa: F401
    available_backends, compute_features, compute_features_sampled,
    default_backend, register_backend, resolve_backend,
)
from repro_torch.core.records import epoch_gather, epoch_indices  # noqa: F401
