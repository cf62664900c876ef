"""Kernel 3: the sender's 1-of-2^S table of B real tests over bp slots."""

from fhhbench.roofline import CHACHA8_OPS

WRAPPER = ("fuzzyheavyhitters_torch.ops.otext_cuda", "enc_planar")
KERNEL = "fhh_ot2s_enc_kernel"


def count(S: int, W: int, bp: int, B: int) -> tuple[float, float]:
    """Read rows (16 B x S), choice bytes and both payloads of the B real
    tests; write the whole table of bp tests x 2^S slots x W words; hash a
    block per slot."""
    return B * (16 * S + S + 8 * W) + bp * (1 << S) * 4 * W, bp * (1 << S) * CHACHA8_OPS


def work(args, kwargs, out):
    B, S = args[2].shape  # x bool[B, S]
    W = args[3].shape[1]  # m_v0 int32[B, W]
    bp = out.numel() // ((1 << S) * W)  # the table the kernel wrote
    return count(S, W, bp, B)
