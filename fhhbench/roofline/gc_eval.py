"""Kernel 6: evaluating bp garbled equality circuits."""

from fhhbench.roofline import CHACHA8_OPS

WRAPPER = ("fuzzyheavyhitters_torch.ops.gc_cuda", "eval_planar")
KERNEL = "fhh_gc_eval_kernel"


def count(S: int, W: int, bp: int) -> tuple[float, float]:
    """Read both label planes, the S - 1 gate tables, the decode bit and
    both ciphertexts; write the output bit and W payload words; hash 2
    blocks an AND gate and 1 for the output."""
    nbytes = bp * (32 * S + 32 * (S - 1) + 4 + 4 * W + 4 + 4 * W)
    return nbytes, bp * (2 * (S - 1) + 1) * CHACHA8_OPS


def work(args, kwargs, out):
    S, bp, W = args[0].shape[0] // 4, args[0].shape[1], args[4].shape[0] // 2  # gbl [4S, n], cts [2W, n]
    return count(S, W, bp)
