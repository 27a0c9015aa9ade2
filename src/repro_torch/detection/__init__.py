"""KitNET detection in PyTorch: model, training, scoring backends, metrics,
and the paper's evaluation protocol (``runner``, ``sweep``)."""
from repro_torch.detection.kitnet import (  # noqa: F401
    KitNet, feature_map, init_kitnet, score_kitnet, train_kitnet,
)
from repro_torch.detection.md_backends import (  # noqa: F401
    available_md_backends, default_md_backend, ensemble_rmse_records,
    md_score_fn, register_md_backend, resolve_md_backend, score_records,
    validate_md_options,
)
from repro_torch.detection.metrics import auc, f1_at_fpr  # noqa: F401
from repro_torch.detection.runner import (  # noqa: F401
    run_kitsune_baseline, run_peregrine,
)
