"""Mesh construction for the LM stack: a port of the JAX package's
``launch/mesh.py`` on the single-controller ``distributed.sharding.Mesh``.

Functions, not module constants, so importing this module touches no
device.  ``devices=`` takes any list of ``torch.device``s, repeats allowed
(``["cpu"] * 8`` is the CPU's stand-in for XLA's forced host devices).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: one card a place, ``cuda:0`` on; raises when fewer cards
    are visible and ``devices`` is not given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(f"the production mesh needs {n} devices, {count} "
                               "CUDA devices are visible; pass devices=")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices, axes, shape)


def make_host_mesh(n_data: int = 2, n_model: int = 4,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A small (data, model) mesh for tests, on the CPU unless ``devices``
    is given."""
    if devices is None:
        devices = ["cpu"] * (n_data * n_model)
    return Mesh(devices, ("data", "model"), (n_data, n_model))


def mesh_shape_dict(mesh: Mesh) -> Dict[str, int]:
    return dict(mesh.shape)
