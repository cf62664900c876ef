"""Zipf site strings with augmentation bits (ref: src/bin/leader.rs:38-87,
130-151), frozen here so that a change to the program's samplers does not
move the yardstick.

``num_sites`` random alphanumeric site strings of ``data_len - aug_len``
bits per dimension, each client's site drawn from a bounded zipf over the
sites, then ``aug_len`` random bits appended per dimension (one
alphanumeric character's bits, per byte LSB-first), so distinct clients at
one site still differ in the low bits.
"""

from __future__ import annotations

import string

import numpy as np

ALNUM = np.frombuffer(
    (string.ascii_uppercase + string.ascii_lowercase + string.digits).encode(), np.uint8)


def _char_bits(chars: np.ndarray, nbits: int) -> np.ndarray:
    """uint8[..., k] characters -> bool[..., nbits], per byte LSB-first."""
    bits = np.unpackbits(chars[..., None], axis=-1, bitorder="little")
    return bits.reshape(chars.shape[:-1] + (-1,))[..., :nbits].astype(bool)


def sample(cfg: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """bool[n, n_dims, data_len] client points."""
    d, L, aug = cfg["n_dims"], cfg["data_len"], cfg["aug_len"]
    site_bits = L - aug
    site_chars = rng.choice(ALNUM, size=(cfg["num_sites"], d, (site_bits + 7) // 8))
    sites = _char_bits(site_chars, site_bits)  # [sites, d, L - aug]
    weight = 1.0 / np.arange(1, cfg["num_sites"] + 1, dtype=np.float64) ** cfg["zipf_exponent"]
    idx = rng.choice(cfg["num_sites"], size=n, p=weight / weight.sum())
    aug_chars = rng.choice(ALNUM, size=(n, d, (aug + 7) // 8))
    return np.concatenate([sites[idx], _char_bits(aug_chars, aug)], axis=-1)
