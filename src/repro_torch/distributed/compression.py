"""Int8 gradient compression with error feedback (1-bit-Adam-style EF).

In a multi-host deployment the quantised tensors are what crosses the
network: the all-reduce runs over int8 payloads, and the quantisation
error is fed back into the next step's gradient so the optimizer sees an
unbiased long-run signal.  On one device this models the numerics
(quantise -> dequantise, plus error feedback), as the JAX package's
``distributed/compression.py`` does.  One scale per leaf of the JAX
package's tree: a stacked layer leaf takes one scale over all its layers.
A leaf held in blocks over places (the placed step) takes the same scale
from its blocks' maxima, which is exact (``ef_amax``, ``ef_scale``), and
each block is compressed at it (``ef_compress_block``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import tree


def ef_amax(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """max |g + e| of a leaf, or of a block of it."""
    return (g.float() + e).abs().max()


def ef_scale(amax: torch.Tensor) -> torch.Tensor:
    """A leaf's quantisation scale from its max |g + e|."""
    return amax / 127.0 + 1e-12


def _quantize(x: torch.Tensor, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = ef_scale(x.abs().max()) if scale is None else scale
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress_block(g: torch.Tensor, e: torch.Tensor,
                      scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of a leaf (its gradient and error buffer) compressed at the
    leaf's scale (``ef_scale`` of the blocks' ``ef_amax`` maxima): (the
    dequantised gradient, the new error), each element as ``ef_compress``
    gives it for the whole leaf."""
    g32 = g.float() + e
    q, _ = _quantize(g32, scale)
    d = q.float() * scale
    return d, g32 - d


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
