"""Bit-vector codecs and bitstring arithmetic (the port's own copy).

Host-side numpy helpers used by client key generation and the workload
samplers; identical to ``fuzzyheavyhitters_tpu/utils/bits.py``, kept here
so the port imports nothing of the JAX package.

Semantics follow the reference's utilities (ref: src/lib.rs:56-190):

- ``u32_to_bits``     LSB-first bit expansion           (lib.rs:56)
- ``msb_u32_to_bits`` MSB-first bit expansion           (lib.rs:67)
- ``bits_to_u32``     interprets ``bits[0]`` as the MSB (lib.rs:78)
- ``string_to_bits``  per-byte LSB-first                (lib.rs:90)
- ``all_bit_vectors`` all 2^d bit patterns, bit j of pattern i = (i >> j) & 1
                      (lib.rs:125)
- ``add_bitstrings`` / ``subtract_bitstrings``: MSB-first fixed-point
  arithmetic (lib.rs:131, 153).

Divergence from the reference, by design: the reference's ``add_bitstrings``
grows the result by one bit on carry-out (which would misalign key levels
against the tree depth) and its subtract wraps modulo 2^n.  Our ball-bound
helpers saturate at the domain edges instead — identical behavior on every
non-overflowing input, and well-defined on the rest (matching what the
clamped coords variant at ibDCF.rs:189-205 does).
"""

from __future__ import annotations

import numpy as np


def u32_to_bits(nbits: int, value: int) -> np.ndarray:
    """LSB-first bit expansion of ``value`` into ``nbits`` bools."""
    assert 0 <= nbits <= 32
    return np.array([(value >> i) & 1 == 1 for i in range(nbits)], dtype=bool)


def msb_u32_to_bits(nbits: int, value: int) -> np.ndarray:
    """MSB-first bit expansion of ``value`` into ``nbits`` bools."""
    assert 0 <= nbits <= 32
    return np.array([(value >> i) & 1 == 1 for i in reversed(range(nbits))], dtype=bool)


def bits_to_u32(bits) -> int:
    """Interpret ``bits[0]`` as the most-significant bit."""
    bits = np.asarray(bits, dtype=bool)
    assert bits.size <= 32
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


def bits_to_int(bits) -> int:
    """MSB-first interpretation with no width limit (for >32-bit strings)."""
    out = 0
    for b in np.asarray(bits, dtype=bool):
        out = (out << 1) | int(b)
    return out


def int_to_bits(nbits: int, value: int) -> np.ndarray:
    """MSB-first expansion with no 32-bit width limit."""
    return np.array([(value >> i) & 1 == 1 for i in reversed(range(nbits))], dtype=bool)


def string_to_bits(s: str) -> np.ndarray:
    """Per-byte LSB-first expansion of the UTF-8 bytes of ``s``."""
    out = []
    for byte in s.encode("utf-8"):
        out.extend((byte >> i) & 1 == 1 for i in range(8))
    return np.array(out, dtype=bool)


def bits_to_string(bits) -> str:
    bits = np.asarray(bits, dtype=bool)
    assert bits.size % 8 == 0
    data = bytearray()
    for i in range(bits.size // 8):
        byte = 0
        for j in range(8):
            byte |= int(bits[8 * i + j]) << j
        data.append(byte)
    return data.decode("utf-8")


def all_bit_vectors(dim: int) -> np.ndarray:
    """All 2^dim bit patterns; pattern i has bit j = (i >> j) & 1.

    Row ordering matches the reference's frontier-expansion child order
    (ref: src/lib.rs:125-129, src/collect.rs:384), which fixes the layout of
    per-level count vectors handed back to the leader.
    """
    i = np.arange(1 << dim)[:, None]
    j = np.arange(dim)[None, :]
    return ((i >> j) & 1).astype(bool)


def add_bitstrings(alpha, beta) -> np.ndarray:
    """MSB-first addition, saturating at 2^n - 1 (n = max input width)."""
    alpha = np.asarray(alpha, dtype=bool)
    beta = np.asarray(beta, dtype=bool)
    n = max(alpha.size, beta.size)
    total = bits_to_int(alpha) + bits_to_int(beta)
    total = min(total, (1 << n) - 1)
    return int_to_bits(n, total)


def subtract_bitstrings(alpha, beta) -> np.ndarray:
    """MSB-first subtraction, saturating at 0."""
    alpha = np.asarray(alpha, dtype=bool)
    beta = np.asarray(beta, dtype=bool)
    n = max(alpha.size, beta.size)
    total = max(bits_to_int(alpha) - bits_to_int(beta), 0)
    return int_to_bits(n, total)


def i16_to_bitvec(value: int) -> np.ndarray:
    """i16 -> 16 bools, MSB-first, two's complement (ref: sample_driving_data.rs:25)."""
    return int_to_bits(16, int(value) & 0xFFFF)


def bitvec_to_i16(bits) -> int:
    """16 bools MSB-first -> i16 (ref: sample_driving_data.rs:31)."""
    v = bits_to_int(bits)
    return v - 0x10000 if v >= 0x8000 else v


def i16_to_ob_bits(value: int) -> np.ndarray:
    """i16 -> 16 bools, MSB-first **offset-binary** (sign bit flipped).

    Unsigned lexicographic order on these strings equals signed order on the
    values, which is what the ibDCF comparator needs; raw two's complement
    (the reference's encoding, sample_driving_data.rs:25) sorts negatives
    above positives and silently breaks zero-crossing intervals."""
    return int_to_bits(16, (int(value) & 0xFFFF) ^ 0x8000)


def ob_bits_to_i16(bits) -> int:
    """16 bools MSB-first offset-binary -> i16 (inverse of i16_to_ob_bits)."""
    v = bits_to_int(bits) ^ 0x8000
    return v - 0x10000 if v >= 0x8000 else v


def pack_bits_lsb(bits: np.ndarray, axis: int = -1) -> np.ndarray:
    """Pack a bool array along ``axis`` (length <= 32) into uint32, bit j = bits[j]."""
    bits = np.moveaxis(np.asarray(bits, dtype=bool), axis, -1)
    assert bits.shape[-1] <= 32
    weights = (np.uint32(1) << np.arange(bits.shape[-1], dtype=np.uint32)).astype(np.uint32)
    return (bits.astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)
