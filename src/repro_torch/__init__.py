"""Peregrine in PyTorch and CUDA: the detection service on an NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference).  The
subpackages mirror it: ``core`` (flow state, hashing, feature computation),
``kernels`` (hand-written CUDA kernels and their build), ``detection``
(KitNET, scoring backends, metrics), ``serving`` (the streaming
``DetectionService``), ``traffic``/``data`` (trace generation, batching)
and ``launch`` (command-line entry points).

Entry points run on ``device="cuda"`` unless the caller passes another
device; without a card they raise.  Flow state is a dict of device tensors
that each step updates in place.  This package never imports JAX.
"""
from repro_torch.device import resolve_device  # noqa: F401
