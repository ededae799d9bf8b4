"""The block-divisibility contract, copied from ``consul_tpu/ops/divisibility.py``.

The reference's Pallas dissemination kernel tiles the observer axis into
``fused_nb`` column blocks and refuses an ``n`` they do not tile.  The
Hopper kernel picks its own tiling, but the port keeps the same
``ValueError`` for ``SwimParams(dissem="fused")`` so that a configuration
the reference rejects is rejected here too.

Host-only integer math.
"""

from __future__ import annotations


def divides(n: int, d: int) -> bool:
    """True iff ``d`` is a positive exact divisor of ``n``."""
    return d > 0 and n % d == 0


def require_divisible(n: int, d: int, *, what: str = "n",
                      by: str = "divisor") -> None:
    """Raise ``ValueError`` unless ``divides(n, d)``."""
    if not divides(n, d):
        raise ValueError(
            f"{what}={n} must be divisible by {by}={d} "
            f"(block windows must tile the axis exactly)")
