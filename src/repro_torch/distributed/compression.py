"""Int8 gradient compression with error feedback (1-bit-Adam-style EF).

In a multi-host deployment the quantised tensors are what crosses the
network: the all-reduce runs over int8 payloads, and the quantisation
error is fed back into the next step's gradient so the optimizer sees an
unbiased long-run signal.  On one device this models the numerics
(quantise -> dequantise, plus error feedback), as the JAX package's
``distributed/compression.py`` does.  One scale per leaf of the JAX
package's tree: a stacked layer leaf takes one scale over all its layers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import tree


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads: Dict, err: Dict) -> Tuple[Dict, Dict]:
    """Returns (dequantised grads to feed the optimizer, new error buffers).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    deq, new_err = [], []
    for g, e in zip(tree.leaves(grads), tree.leaves(err)):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        d = q.float() * scale
        deq.append(d)
        new_err.append(g32 - d)
    return tree.unflatten(grads, deq), tree.unflatten(grads, new_err)
