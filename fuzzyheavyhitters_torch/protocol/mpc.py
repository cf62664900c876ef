"""Beaver-triple multiplication checks batched over clients, as plain
PyTorch (the port of ``fuzzyheavyhitters_tpu/protocol/mpc.py``, bit for bit).

The reference's MPC verification layer (ref: src/mpc.rs:14-223, 246-322:
``TripleShare``, ``MulState`` with its ``cor_share -> cor -> out_share ->
verify`` two-round protocol).  Over additive shares (share0 + share1 =
value) the servers compute

    out = sum_i  r_i * [ x_i * y_i + z_i ]        (i over CHECKS checks)

which is zero for honest inputs.  With a Beaver triple (a, b, c = a*b),
``d = x - a`` and ``e = y - b`` are opened (the cor round), then

    [x*y + z] = d*e + d*b + e*a + c + z

with ``d*e`` added by server 1 only (mpc.rs:188-196).  The two rounds are
the seams the caller routes over its transport (the data plane in
``protocol/rpc.py``).  Field values are the tensors of ``ops/fields.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import prg
from ..utils import words_from_numpy

CHECKS = 3  # TRIPLES_PER_LEVEL (ref: sketch.rs:6)


class TripleBatch(NamedTuple):
    """One party's additive shares of Beaver triples, any batch shape."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


def level_slab(triples: TripleBatch, level: int) -> TripleBatch:
    """One level's triple slab out of a ``[..., L-1, CHECKS]`` batch: the
    one-shot unit of the restartable sketch (``protocol/sketch.py``'s
    ratchet) — a recovered level re-opens the same slab under the same
    ratcheted challenge, a replay and never a second opening."""
    return TripleBatch(*[a[..., level, :] for a in triples])


class MulStateBatch(NamedTuple):
    """One party's inputs to a batch of multiplication checks; every leaf
    is a field tensor [..., CHECKS(, limbs)]."""

    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    rs: torch.Tensor
    triples: TripleBatch


def gen_triples(field, shape, seed) -> tuple[TripleBatch, TripleBatch]:
    """Both parties' triple shares for ``shape`` checks (ref: mpc.rs:18-45),
    from one CTR stream of ``seed`` (an int32[4] tensor on the device the
    triples go to, or uint32 words, on the CPU); the clients supply them in
    their sketch keys (sketch.rs:113-127)."""
    if not isinstance(seed, torch.Tensor):
        seed = words_from_numpy(np.asarray(seed, np.uint32), "cpu")
    w = 8 if field.limb_shape else 4
    n = int(np.prod(shape))
    words = prg.stream_words(seed, 5 * n * w).reshape(5, n, w)
    full = tuple(shape) + field.limb_shape
    a = field.sample(words[0]).reshape(full)
    b = field.sample(words[1]).reshape(full)
    c = field.mul(a, b)
    a0 = field.sample(words[2]).reshape(full)
    b0 = field.sample(words[3]).reshape(full)
    c0 = field.sample(words[4]).reshape(full)
    return (TripleBatch(a=a0, b=b0, c=c0),
            TripleBatch(a=field.sub(a, a0), b=field.sub(b, b0), c=field.sub(c, c0)))


def cor_share(field, state: MulStateBatch):
    """(ds, es) shares to open: d = x - a, e = y - b (mpc.rs:143-159)."""
    return field.sub(state.xs, state.triples.a), field.sub(state.ys, state.triples.b)


def cor(field, share0, share1):
    """Both parties' cor shares combined into the opened (d, e)
    (mpc.rs:162-181)."""
    d0, e0 = share0
    d1, e1 = share1
    return field.add(d0, d1), field.add(e0, e1)


def out_share(field, server_idx: bool, state: MulStateBatch, opened):
    """This party's share of out = sum_i r_i*[x_i*y_i + z_i]
    (mpc.rs:184-216); ``d*e`` is added by server 1 only."""
    d, e = opened
    term = field.add(field.mul(d, state.triples.b), field.mul(e, state.triples.a))
    term = field.add(term, state.triples.c)
    term = field.add(term, state.zs)
    if server_idx:
        term = field.add(term, field.mul(d, e))
    term = field.mul(term, state.rs)
    return field.sum(term, dim=term.dim() - 1 - len(field.limb_shape))


def verify(field, out0, out1) -> torch.Tensor:
    """bool[...]: True where the check batch passes (the out shares sum to
    zero, mpc.rs:218-223)."""
    total = field.canon(field.add(out0, out1))
    if field.limb_shape:
        return ~(total != 0).any(dim=-1)
    return total == 0
