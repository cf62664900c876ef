"""Fixed-key length-doubling PRG on 128-bit seeds, as plain PyTorch.

The same construction as ``fuzzyheavyhitters_tpu/ops/prg.py``: a fixed-key
ChaCha permutation with the 128-bit seed as the input block and the
feed-forward add (the Davies-Meyer role of the reference's fixed-key AES,
ref: src/prg.rs:92-122).  Semantics kept bit for bit:

- ``expand``: seed -> (left child seed, right child seed, 2 t bits, 2 y
  bits) (prg.rs:92-122);
- the low 4 bits of seed byte 0 are masked to zero before expansion
  (prg.rs:97, ``key_short``) — word 0 & 0xFFFFFFF0;
- ``DERIVED_BITS = True`` derives the t/y bits from output word 8;
  ``False`` reproduces the reference's constant-bit quirk (prg.rs:103-104
  reads the masked byte, so the bits are the constants (1, 1)/(1, 1)).

Seeds are ``int32[..., 4]`` bit patterns (little-endian word order).  The
arithmetic runs on ``int64`` words masked to 32 bits: PyTorch's ``uint32``
has no add or shift on the CPU, and int32 right shifts are arithmetic.
This module is the plain version that the CUDA kernels are held against
(``csrc/chacha.cuh`` is the same function for the card).
"""

from __future__ import annotations

import torch

SEED_WORDS = 4  # 128-bit seeds as int32[..., 4], little-endian word order
N_ROUNDS = 8  # ChaCha rounds (4 double rounds); csrc/chacha.cuh matches

# "expand 32-byte k" — the standard ChaCha constant words.
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# Fixed 256-bit key, public by construction: the first 8 words of pi's
# fractional part (as in Blowfish's P-array), as in the JAX package.
_FIXED_KEY = (
    0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344,
    0xA4093822, 0x299F31D0, 0x082EFA98, 0xEC4E6C89,
)

# Honest seed-derived t/y bits by default; False is the reference's
# constant-bit quirk (parity mode).  Read at call time.
DERIVED_BITS = True

M32 = 0xFFFFFFFF
SEED_MASK = 0xFFFFFFF0  # prg.rs:97 key_short on word 0


def to_u64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & M32


def to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return (((values & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & M32


def _qr(a, b, c, d):
    a = (a + b) & M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha_words(blk: list) -> list:
    """ChaCha block function on 4 input words (int64 tensors in [0, 2^32),
    any common shape) -> the 16 output words, same form."""
    x = [torch.full_like(blk[0], w) for w in _SIGMA + _FIXED_KEY] + list(blk)
    init = list(x)
    for _ in range(N_ROUNDS // 2):
        x[0], x[4], x[8], x[12] = _qr(x[0], x[4], x[8], x[12])
        x[1], x[5], x[9], x[13] = _qr(x[1], x[5], x[9], x[13])
        x[2], x[6], x[10], x[14] = _qr(x[2], x[6], x[10], x[14])
        x[3], x[7], x[11], x[15] = _qr(x[3], x[7], x[11], x[15])
        x[0], x[5], x[10], x[15] = _qr(x[0], x[5], x[10], x[15])
        x[1], x[6], x[11], x[12] = _qr(x[1], x[6], x[11], x[12])
        x[2], x[7], x[8], x[13] = _qr(x[2], x[7], x[8], x[13])
        x[3], x[4], x[9], x[14] = _qr(x[3], x[4], x[9], x[14])
    return [(a + b) & M32 for a, b in zip(x, init)]


def chacha_block(block: torch.Tensor) -> torch.Tensor:
    """int32[..., 4] input blocks -> int32[..., 16] output blocks."""
    if block.shape[-1] != SEED_WORDS:
        raise ValueError(f"input blocks must be int32[..., 4], got {tuple(block.shape)}")
    b = to_u64(block)
    out = chacha_words([b[..., i] for i in range(SEED_WORDS)])
    return to_i32(torch.stack(out, dim=-1))


def expand_words(blk: list, derived_bits: bool):
    """Masked expansion on int64 words: -> (left words, right words,
    (t_l, t_r), (y_l, y_r)) with the bits as bool tensors."""
    out = chacha_words([blk[0] & SEED_MASK] + list(blk[1:]))
    if derived_bits:
        w8 = out[8]
        bits = ((w8 & 1) == 0, (w8 & 2) == 0)
        ybits = ((w8 & 4) == 0, (w8 & 8) == 0)
    else:  # prg.rs:103-104 reads the masked byte -> constants (1, 1)
        one = torch.ones_like(blk[0], dtype=torch.bool)
        bits = ybits = (one, one)
    return out[0:4], out[4:8], bits, ybits


def expand(seed: torch.Tensor, derived_bits: bool | None = None):
    """Length-doubling expansion of int32[..., 4] seeds -> ``(s_l, s_r,
    bits, y_bits)``: child seeds int32[..., 4] and bool[..., 2] t/y bit
    pairs, the reference's ``PrgOutput`` (prg.rs:56-60, 92-122)."""
    if derived_bits is None:
        derived_bits = DERIVED_BITS
    s = to_u64(seed)
    sl, sr, bits, ybits = expand_words(
        [s[..., i] for i in range(SEED_WORDS)], derived_bits
    )
    return (
        to_i32(torch.stack(sl, dim=-1)),
        to_i32(torch.stack(sr, dim=-1)),
        torch.stack(bits, dim=-1),
        torch.stack(ybits, dim=-1),
    )
