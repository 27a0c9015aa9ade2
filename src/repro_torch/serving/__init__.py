"""Peregrine serving plane in PyTorch: the single-stream
``DetectionService``, the multi-tenant ``DetectionEngine`` and their
per-chunk device steps."""
from repro_torch.serving.detect_service import DetectionService  # noqa: F401
from repro_torch.serving.engine import DetectionEngine  # noqa: F401
from repro_torch.serving.fused import make_fused_step, make_tenant_step  # noqa: F401
