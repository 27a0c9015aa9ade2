"""Peregrine serving plane in PyTorch: the single-stream
``DetectionService`` and its per-chunk device step."""
from repro_torch.serving.detect_service import DetectionService  # noqa: F401
from repro_torch.serving.fused import make_fused_step  # noqa: F401
