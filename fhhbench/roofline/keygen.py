"""Kernel 1: ibDCF keygen of K keys over L levels."""

from fhhbench.roofline import CHACHA8_OPS

WRAPPER = ("fuzzyheavyhitters_torch.ops.keygen_cuda", "gen_cw")
KERNEL = "fhh_keygen_kernel"


def count(K: int, L: int) -> tuple[float, float]:
    """Read root seeds (2 x 16 B), alpha bytes and side; write per level 16 B
    of seed and 2 + 2 flag bytes; hash both parties' seeds at every level."""
    return K * 32 + K * L + K + K * L * (16 + 2 + 2), K * L * 2 * CHACHA8_OPS


def work(args, kwargs, out):
    K, L = args[1].shape  # alpha bool[K, L]
    return count(K, L)
