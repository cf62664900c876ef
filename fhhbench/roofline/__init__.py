"""Frozen work counts of the port's six kernels and the card's peaks.

Each ``<kernel>.py`` names the program's wrapper (``WRAPPER``: module and
function), the device kernel it launches (``KERNEL``: a substring of the
profiler's kernel name) and ``work(args, kwargs, out) -> (bytes, ops)``,
the bytes and 32-bit integer operations one call needs, reckoned from its
shapes: each input byte read once, each output byte written once, and the
ChaCha8 blocks the call must hash.  :func:`bound_s` is the least time of
that work on the card."""

from __future__ import annotations

# H100 SXM HBM3 at 3.35 TB/s: NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
# derived, not published (the data sheet gives no integer rate): one warp
# instruction per clock per SM quarter, 128 thread ops per SM per clock,
# x 132 SMs x 1.98 GHz = 33.45e12 32-bit integer ops/s
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# one ChaCha8 block: 4 double rounds x 8 quarter-rounds x 12 ops + the feed-forward
CHACHA8_OPS = 4 * 8 * 12 + 16
# output word 8 alone (the derived t/y bits a level without a child cache
# reads): 3 double rounds, 4 column quarter-rounds and 10 ops of one
# diagonal quarter-round of the last, one feed-forward add and the seed mask
CHACHA8_WORD8_OPS = 7 * 4 * 12 + 10 + 1 + 1


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds the card needs at least: the larger of bytes at the HBM rate
    and operations at the derived integer rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
