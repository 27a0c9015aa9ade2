"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors; ``KERNELS`` lists every kernel with its launch
count.  Nothing is compiled at import.
"""
from repro_torch.kernels.flash_attention import (  # noqa: F401
    FLASH_ATTENTION, flash_attention,
)
from repro_torch.kernels.feature_update import (  # noqa: F401
    FC_FULL, FEATURE_UPDATE, feature_update, feature_update_full,
)
from repro_torch.kernels.kitnet_ae import (  # noqa: F401
    KITNET_AE, KITNET_SCORE, kitnet_ensemble, kitnet_score,
)
from repro_torch.kernels.sketch_update import (  # noqa: F401
    SKETCH_UPDATE, sketch_update_full,
)

KERNELS = (FC_FULL, KITNET_AE, KITNET_SCORE, SKETCH_UPDATE, FEATURE_UPDATE,
           FLASH_ATTENTION)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
