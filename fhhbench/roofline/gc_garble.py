"""Kernel 5: garbling bp equality circuits of S-bit strings."""

from fhhbench.roofline import CHACHA8_OPS

WRAPPER = ("fuzzyheavyhitters_torch.ops.gc_cuda", "garble_planar")
KERNEL = "fhh_gc_garble_kernel"


def count(S: int, W: int, bp: int) -> tuple[float, float]:
    """Read both label planes, choice bits, mask and both payloads; write
    the S - 1 AND-gate tables, the evaluator's labels, the decode bit and
    both ciphertexts; hash 4 blocks an AND gate and 2 for the output."""
    nbytes = bp * (32 * S + 4 * S + 4 + 8 * W + 32 * (S - 1) + 16 * S + 4 + 8 * W)
    return nbytes, bp * (4 * (S - 1) + 2) * CHACHA8_OPS


def work(args, kwargs, out):
    S, bp, W = args[3].shape[0], args[1].shape[1], args[5].shape[0]  # xb [S, n], X0, mv0 [W, n]
    return count(S, W, bp)
