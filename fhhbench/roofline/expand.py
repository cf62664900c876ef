"""Kernel 2: one level's expansion of B = F x N rows over d2 planes."""

from fhhbench.roofline import CHACHA8_OPS, CHACHA8_WORD8_OPS

WRAPPER = ("fuzzyheavyhitters_torch.ops.expand_cuda", "expand_packed")
KERNEL = "fhh_expand_kernel"


def count(B: int, N: int, d2: int, want_children: bool, derived: bool) -> tuple[float, float]:
    """Read seed + t + y per (row, plane) and the cw planes once; write the
    packed word per row and, with the child cache, 8 seed words and a flag
    byte per (row, plane); hash a whole block per (row, plane) with the
    cache, without it only what output word 8 needs."""
    if not want_children:
        return B * d2 * 18 + N * d2 + B * 4, B * d2 * (CHACHA8_WORD8_OPS if derived else 0)
    return B * d2 * (18 + 33) + N * d2 * 17 + B * 4, B * d2 * CHACHA8_OPS


def work(args, kwargs, out):
    d2, B = args[1].shape  # t bool[d2, B]
    N = args[4].shape[-1]  # cwf uint8[d2, N]
    want_children = out[1] is not None  # the child cache is returned when built
    derived = kwargs.get("derived_bits", args[5] if len(args) > 5 else None)
    if derived is None:
        from fuzzyheavyhitters_torch.ops import prg
        derived = prg.DERIVED_BITS
    return count(B, N, d2, want_children, bool(derived))
