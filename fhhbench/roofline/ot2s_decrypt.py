"""Kernel 4: the receiver's open of B tests."""

from fhhbench.roofline import CHACHA8_OPS

WRAPPER = ("fuzzyheavyhitters_torch.ops.otext_cuda", "dec_planar")
KERNEL = "fhh_ot2s_dec_kernel"


def count(S: int, W: int, B: int) -> tuple[float, float]:
    """Read rows, choice bytes and the one opened slot (W words) of each
    test, write W payload words; hash one block a test.  The input bytes,
    not the 32-byte sectors the opened slots touch."""
    return B * (16 * S + S + 4 * W + 4 * W), B * CHACHA8_OPS


def work(args, kwargs, out):
    B, S = args[1].shape  # y bool[B, S]
    W = out.shape[1]  # pay int32[B, W]
    return count(S, W, B)
