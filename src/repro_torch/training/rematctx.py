from repro_torch.distributed.rematctx import (  # noqa: F401
    use_remat, current_remat, maybe_remat, recomputing,
)
