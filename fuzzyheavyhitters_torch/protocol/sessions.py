"""The trusted exchange's shared mask stream (the slice of the JAX
package's ``protocol/sessions.py`` that the socket deployment uses).

In trusted mode both servers hold the plaintext counts; server 0 answers
``count + r`` and server 1 answers ``r``, with ``r`` drawn from one stream
both derive from a public seed, so the leader's ``v0 - v1`` reconstruction
is the same as in secure mode (the reference hardcodes the seed,
server.rs:331-332).  A wire-format shim, not a secret: secrecy comes from
``secure_exchange``.  Host NumPy on purpose: the rows are tiny (F · 2^d
elements a level).  The multi-tenant collection sessions of that module are
not ported.
"""

from __future__ import annotations

import numpy as np

from ..ops import prg
from ..ops.fields import F255, FE62

DEFAULT_COLLECTION = "default"
SHARED_MASK_SEED = b"XXX This is bog\x00"  # 16 B, ref: server.rs:331-332


def _mask_words(level: int, n: int, blocks_for: int) -> np.ndarray:
    """uint32[n, blocks_for]: the level's mask words (seed word 3 ^= level)."""
    seed = prg.seeds_from_bytes(SHARED_MASK_SEED)[0].copy()
    seed[3] ^= np.uint32(level)
    return prg.np_stream_words(seed, n * blocks_for).reshape(n, blocks_for)


def mask_fe62(level: int, n: int) -> np.ndarray:
    """uint64[n] FE62 mask values of one level."""
    return FE62.np_sample(_mask_words(level, n, 4))


def mask_f255(level: int, n: int) -> np.ndarray:
    """uint32[n, 8] F255 mask values of one level."""
    return F255.np_sample(_mask_words(level, n, 8))


def mask_rows(level: int, F: int, C: int, f255: bool) -> np.ndarray:
    """One whole level's mask rows: ``[F, C]`` FE62 or ``[F, C, 8]`` F255
    (the JAX ``CollectionSession.mask_rows`` without node-span shards)."""
    if f255:
        return mask_f255(level, F * C).reshape(F, C, 8)
    return mask_fe62(level, F * C).reshape(F, C)
