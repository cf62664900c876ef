"""Zipf site-string workload (ref: src/bin/leader.rs:38-66, 130-151).

The port's own copy of ``fuzzyheavyhitters_tpu/workloads/strings.py``: the
same draws from the same ``numpy.random.Generator`` in the same order, so a
seed gives the same client points in both packages.

Host-side client simulation: ``num_sites`` random site strings per dimension,
zipf-distributed site popularity, and per-request random augmentation bits so
distinct clients at the same site still differ in the low bits.
"""

from __future__ import annotations

import string as _string

import numpy as np

from ..utils import bits as bitutils

_ALNUM = np.frombuffer(
    (_string.ascii_uppercase + _string.ascii_lowercase + _string.digits).encode(),
    dtype=np.uint8,
)


def sample_string_bits(rng: np.random.Generator, nbits: int) -> np.ndarray:
    """Random alphanumeric string of ``nbits//8`` chars as per-byte LSB-first
    bits (ref: leader.rs:38-44 ``sample_string`` + lib.rs:90
    ``string_to_bits``), truncated to ``nbits``."""
    nchars = (nbits + 7) // 8
    chars = rng.choice(_ALNUM, size=nchars)
    bits = np.unpackbits(chars[:, None], axis=1, bitorder="little").reshape(-1)
    return bits[:nbits].astype(bool)


def generate_random_bit_vectors(
    rng: np.random.Generator, nbits: int, n_dims: int
) -> np.ndarray:
    """bool[n_dims, nbits] — one random string per dimension
    (ref: leader.rs:45-57)."""
    return np.stack([sample_string_bits(rng, nbits) for _ in range(n_dims)])


def generate_sites(
    rng: np.random.Generator, num_sites: int, data_len: int, n_dims: int, aug_len: int
) -> np.ndarray:
    """bool[num_sites, n_dims, data_len - aug_len] site prefixes
    (ref: leader.rs:60-66 ``generate_strings``)."""
    return np.stack(
        [
            generate_random_bit_vectors(rng, data_len - aug_len, n_dims)
            for _ in range(num_sites)
        ]
    )


def zipf_indices(
    rng: np.random.Generator, num_sites: int, exponent: float, nreqs: int
) -> np.ndarray:
    """Bounded zipf over [0, num_sites): P(k) ∝ 1/(k+1)^exponent — the
    ``zipf::ZipfDistribution`` the reference samples per request
    (ref: leader.rs:140-146, sample-1 as 0-based index)."""
    w = 1.0 / np.arange(1, num_sites + 1, dtype=np.float64) ** exponent
    return rng.choice(num_sites, size=nreqs, p=w / w.sum())


def augment_points(
    rng: np.random.Generator, sites: np.ndarray, idx: np.ndarray, aug_len: int
) -> np.ndarray:
    """Append ``aug_len`` random bits per dimension to each request's site
    string (ref: leader.rs:78-87 ``augment_string``) ->
    bool[nreqs, n_dims, data_len].

    Fully vectorized (one rng.choice + one unpackbits for the whole batch,
    same per-byte-LSB-first alnum-char semantics as
    :func:`sample_string_bits`): the per-request Python loops this replaces
    were minutes of host time at the 1M-client scale."""
    base = sites[idx]  # [nreqs, n_dims, L - aug]
    n, d, _ = base.shape
    if aug_len == 0:
        return base
    nchars = (aug_len + 7) // 8
    chars = rng.choice(_ALNUM, size=(n, d, nchars))
    aug = np.unpackbits(chars[..., None], axis=-1, bitorder="little")
    aug = aug.reshape(n, d, nchars * 8)[..., :aug_len].astype(bool)
    return np.concatenate([base, aug], axis=-1)


def zipf_workload(
    rng: np.random.Generator,
    num_sites: int,
    data_len: int,
    n_dims: int,
    zipf_exponent: float,
    nreqs: int,
    aug_len: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """The full zipf client simulation: returns (points bool[nreqs, n_dims,
    data_len], site index per request) — feed the points to
    ``ibdcf.gen_l_inf_ball`` (ref: leader.rs:130-151 ``add_fuzzy_keys``)."""
    sites = generate_sites(rng, num_sites, data_len, n_dims, aug_len)
    idx = zipf_indices(rng, num_sites, zipf_exponent, nreqs)
    return augment_points(rng, sites, idx, aug_len), idx
