"""Exact and switch arithmetic (port of ``repro.core.arith``).

The switch has no multiply, divide or square root.  Peregrine approximates:

  * mul/div     -> round one operand to a power of two, then shift;
  * sqrt/square -> the Tofino math unit: a 16-entry lookup on the operand's
                   top mantissa bits and an exponent rescale.

``mode="exact"`` uses real arithmetic; ``mode="switch"`` the approximations.

Switch mode is ported as the integer semantics it models, not call for
call.  The JAX package takes ``floor``/``ceil``/``round`` of ``log2`` and
multiplies by ``exp2`` of an integer; neither is exact in float32.  On the
CPU, XLA's ``log2`` falls just below the integer at 7 of the 51 powers of
two from 2^-20 to 2^30 (``log2(8192) = 12.999999``), ``torch.log2`` rounds
2^22 - 2 up to 22.0, and XLA's ``exp2`` at integer exponents is one ulp
off for 30 of the 63 exponents from -31 to 31.  The switch does none of
that: it shifts.  So here every exponent comes from ``torch.frexp``
(``x = m * 2^E``, ``m`` in [0.5, 1)) and every shift multiplies by a power
of two built from its float32 bits (an ``ldexp``; ``torch.ldexp`` itself
goes through ``pow``), so the results are the same bits on every device and
no transcendental is evaluated.  For ``x >= 1``:

  * ``floor(log2 x) = E - 1``;
  * ``ceil(log2 x)  = E``, or ``E - 1`` where ``m`` is exactly 0.5;
  * ``round(log2 x) = E``, or ``E - 1`` where ``m < sqrt(2)/2``.

Operands below 1 never matter: every switch function masks them to 0, as
the JAX package does.  The port therefore differs from the JAX package
exactly where XLA's ``log2``/``exp2`` misses the integer exponent;
``tests/test_torch_switch.py`` counts those operands.  Each function is
written in few tensor operations, since the switch-mode oracle calls them
once per packet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12
MODES = ("exact", "switch")
_LUT_N = 16

# the least float32 >= sqrt(2)/2: a mantissa m rounds log2 up iff m >= it
# (sqrt(2)/2 is irrational, so no mantissa equals it)
_HALF_SQRT2 = np.float32(math.sqrt(0.5))
if float(_HALF_SQRT2) ** 2 < 0.5:        # exact: a 24-bit square fits a double
    _HALF_SQRT2 = np.nextafter(_HALF_SQRT2, np.float32(1.0))
_HALF_SQRT2 = float(_HALF_SQRT2)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown arithmetic mode {mode!r}; "
                         f"available: {MODES}")


def invert_perm(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation: ``invert_perm(order)[order[i]] == i``
    (one scatter, cheaper than a second argsort)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


# ---------------------------------------------------------------------------
# the switch's operations: exponents from frexp, shifts by exact powers of two
# ---------------------------------------------------------------------------
def _pow2(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` as float32 built from its bits, for int32 ``e`` in [-126,
    128] (``2**128`` is inf, as float32 ``exp2(128)``)."""
    return ((e + 127) * (1 << 23)).view(torch.float32)


def shift_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with ``b`` rounded up to a power of two (a right shift),
    floored; 0 where ``b < 1`` (a divisor that truncates to 0).  Exact for
    divisors up to 2^126."""
    m, e = torch.frexp(b)
    e = torch.where(m == 0.5, e - 1, e).clamp_max(126)      # ceil(log2 b)
    return torch.where(b >= 1.0, torch.floor(a * _pow2(-e)), 0.0)


def shift_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` with ``b`` rounded to the nearest power of two (a left
    shift), floored; 0 where ``b < 1``."""
    m, e = torch.frexp(b)
    e = torch.where(m < _HALF_SQRT2, e - 1, e)              # round(log2 b)
    return torch.where(b >= 1.0, torch.floor(a * _pow2(e)), 0.0)


def mathunit_square(x: torch.Tensor) -> torch.Tensor:
    """Math-unit square: with ``x = m' * 2^e``, ``m'`` in [1, 2), the square
    of bucket ``i = floor((m' - 1) * 16)``'s centre ``1 + (i + 0.5) / 16``,
    times ``(2^e)^2``, floored; 0 where ``x < 1``.  The centre is computed
    from the frexp mantissa ``m = m' / 2`` as ``(floor(32 m) + 0.5) / 16``,
    the same float32 value; its square is exact."""
    m, e = torch.frexp(x)
    c = (torch.floor(m * 32.0) + 0.5) / _LUT_N
    p = _pow2(e - 1)
    return torch.where(x >= 1.0, torch.floor(c * c * (p * p)), 0.0)


def mathunit_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Math-unit square root: the exponent split at an even ``2h``, ``m'``
    = ``x / 2^(2h)`` in [1, 4); the root of bucket ``i = floor((m' - 1) / 3
    * 16)``'s centre ``1 + (i + 0.5) * 3/16``, times ``2^h``, floored; 0
    where ``x < 1``."""
    _, e = torch.frexp(x)
    h = torch.div(e - 1, 2, rounding_mode="floor")
    m = x * _pow2(-2 * h)                                   # [1, 4)
    i = torch.floor((m - 1.0) / 3.0 * _LUT_N)
    c = 1.0 + (i + 0.5) * (3.0 / _LUT_N)
    return torch.where(x >= 1.0, torch.floor(torch.sqrt(c) * _pow2(h)), 0.0)


def quantized_decay(lam: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Switch decay ``2^-floor(lam * dt)``, k clipped to [0, 31]: iterated
    halvings; below the decay window (``lam * dt < 1``) no decay."""
    k = torch.floor(lam * dt.clamp_min(0.0)).clamp(0.0, 31.0)
    return _pow2(-k.to(torch.int32))


def exact_decay(lam: torch.Tensor, dt: torch.Tensor,
                exp2=torch.exp2) -> torch.Tensor:
    """``delta = 2^(-lam * dt)`` (Equation 1), through ``exp2``."""
    return exp2(-lam * dt.clamp_min(0.0))


# ---------------------------------------------------------------------------
# mode dispatch
# ---------------------------------------------------------------------------
def div(a: torch.Tensor, b: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """``a / b`` where ``b > 0``, else 0 (exact); ``shift_div`` (switch)."""
    if mode == "switch":
        return shift_div(a, b)
    return torch.where(b > 0, a / b.clamp_min(_EPS), torch.zeros_like(a))


def sqrt(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    if mode == "switch":
        return mathunit_sqrt(x)
    return torch.sqrt(x.clamp_min(0.0))


def square(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    if mode == "switch":
        return mathunit_square(x)
    return x * x


def decay(lam: torch.Tensor, dt: torch.Tensor, mode: str = "exact",
          exp2=torch.exp2) -> torch.Tensor:
    """The decay factor of ``dt``; exact mode evaluates it through ``exp2``
    (switch mode evaluates no transcendental)."""
    if mode == "switch":
        return quantized_decay(lam, dt)
    return exact_decay(lam, dt, exp2)
