"""Exact-mode arithmetic (port of the exact branch of ``repro.core.arith``).

The switch's shift-approximated arithmetic (``mode="switch"``) is not
ported yet (ROADMAP queue 1 item 10); asking for it raises.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def check_mode(mode: str) -> None:
    if mode != "exact":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet; only exact arithmetic is "
            "(ROADMAP queue 1 item 10: switch-mode arithmetic)")


def div(a: torch.Tensor, b: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """``a / b`` where ``b > 0``, else 0."""
    check_mode(mode)
    return torch.where(b > 0, a / b.clamp_min(_EPS), torch.zeros_like(a))


def sqrt(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    check_mode(mode)
    return torch.sqrt(x.clamp_min(0.0))


def square(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    check_mode(mode)
    return x * x
