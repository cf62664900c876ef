"""Aggregation engine: the prefix-tree frontier crawl on tensors (radix 1).

The port of ``fuzzyheavyhitters_tpu/protocol/collect.py`` (ref:
src/collect.rs:28-507).  The frontier is a padded tensor of eval states
with an alive-node mask; one PRG expansion per (node, client, dim, side)
yields both children, serving all 2^d child patterns; each (node,
client)'s both-direction share bits pack into one 32-bit word (bit
``j*4 + side*2 + dir``), so ball membership of child pattern c is
``(p0 ^ p1) & pattern_masks[c] == 0``.  Child c of node f sits at
``f * 2^d + c``, pattern bit j = ``(c >> j) & 1`` (ref: lib.rs:125-129),
so the leader reconstructs paths from its own keep masks.

One layout everywhere, on the CPU and on the card: PLANE-MAJOR states,
seed ``int32[4, d, 2, F, N]``, bits ``bool[d, 2, F, N]`` — the layout of
the expand kernel (``ops/expand_cuda.py``), whose plain version the CPU
runs.  The frontier's node axis ``F`` is a power-of-two bucket sized to the
survivors (:func:`bucket_for`); the expansion also returns both children's
states, so advancing past the prune is a gather, not a second PRG pass.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import expand_cuda, prg
from ..ops.ibdcf import EvalState, IbDcfKeyBatch, eval_init

MAX_DIMS = 8  # the packed 32-bit word holds d*4 bits


class Frontier(NamedTuple):
    """Per-server frontier: plane-major ``states`` over ``F`` node slots
    (seed [4, d, 2, F, N], bits [d, 2, F, N]) and ``alive`` bool[F]."""

    states: EvalState
    alive: torch.Tensor

    @property
    def f_bucket(self) -> int:
        return self.alive.shape[0]


class PlanarChildren(NamedTuple):
    """Child-state cache of one expansion.

    seed:  int32[2, 4, d, 2, F, N] — direction-major, t-corrected;
    flags: uint8[d, 2, F, N] — bl | br<<1 | yl<<2 | yr<<3 (y accumulated).
    """

    seed: torch.Tensor
    flags: torch.Tensor


def bucket_for(n_alive: int, f_max: int) -> int:
    """Smallest power of two ≥ ``n_alive``, capped by ``f_max``; more than
    ``f_max`` survivors raise."""
    if n_alive > f_max:
        raise ValueError(
            f"{n_alive} surviving nodes exceed f_max={f_max}; "
            "raise f_max or the threshold"
        )
    b = 1 << max(0, int(np.ceil(np.log2(max(1, n_alive)))))
    return min(f_max, b)


def tree_init(keys: IbDcfKeyBatch, f_bucket: int = 1) -> Frontier:
    """Root frontier: one alive node whose states are eval_init of every
    (client, dim, side) key (ref: collect.rs:67-92), copied into every
    slot of the bucket."""
    root = eval_init(keys)  # seed [N, d, 2, 4], bits [N, d, 2]
    seed = root.seed.permute(3, 1, 2, 0)  # [4, d, 2, N]
    seed = seed[:, :, :, None].expand(*seed.shape[:3], f_bucket, seed.shape[3])
    plane = lambda a: a.permute(1, 2, 0)[:, :, None].expand(
        a.shape[1], a.shape[2], f_bucket, a.shape[0]).contiguous()
    states = EvalState(seed=seed.contiguous(), bit=plane(root.bit),
                       y_bit=plane(root.y_bit))
    alive = torch.zeros(f_bucket, dtype=torch.bool, device=seed.device)
    alive[0] = True
    return Frontier(states=states, alive=alive)


def _bit_positions(d: int):
    """bit position of (dim j, side s, direction r) in the packed word."""
    j = np.arange(d)[:, None, None]
    s = np.arange(2)[None, :, None]
    r = np.arange(2)[None, None, :]
    return (j * 4 + s * 2 + r).astype(np.uint32)  # [d, 2, 2]


@lru_cache(maxsize=None)
def pattern_masks(d: int) -> np.ndarray:
    """uint32[2^d] — for child pattern c, the packed-bit positions that a
    membership test compares: both sides of every dim, at direction
    ``(c >> j) & 1`` (child order: ref lib.rs:125-129).  Read-only."""
    assert d <= MAX_DIMS
    pos = _bit_positions(d)
    masks = []
    for c in range(1 << d):
        m = np.uint32(0)
        for j in range(d):
            r = (c >> j) & 1
            m |= (np.uint32(1) << pos[j, 0, r]) | (np.uint32(1) << pos[j, 1, r])
        masks.append(m)
    out = np.array(masks, dtype=np.uint32)
    out.setflags(write=False)
    return out


def level_cw_planar(keys: IbDcfKeyBatch, level: int):
    """One level's correction words in the expand kernel's layout:
    ``cws`` int32[4, d2, N] and ``cwf`` uint8[d2, N] (bl|br<<1|yl<<2|yr<<3)."""
    N, d = keys.cw_seed.shape[:2]
    cws = keys.cw_seed[..., level, :].permute(3, 1, 2, 0).reshape(4, 2 * d, N)
    u8 = lambda a, s: a.to(torch.uint8) << s
    b, y = keys.cw_bits[..., level, :], keys.cw_y_bits[..., level, :]
    cwf = u8(b[..., 0], 0) | u8(b[..., 1], 1) | u8(y[..., 0], 2) | u8(y[..., 1], 3)
    return cws.contiguous(), cwf.permute(1, 2, 0).reshape(2 * d, N).contiguous()


def expand_share_bits(keys: IbDcfKeyBatch, frontier: Frontier, level: int,
                      want_children: bool = True):
    """One PRG expansion of the whole frontier -> ``(packed int32[F, N],
    children)``: the share bits ``y ^ t`` of both child directions of
    every (dim, side) key at ``_bit_positions``, and the
    :class:`PlanarChildren` cache (None when ``want_children`` is False,
    the last level).  The expansion is ``ops/expand_cuda.expand_packed``:
    the kernel on a card, its plain version on the CPU."""
    st = frontier.states
    d, _, F, N = st.bit.shape
    d2, B = 2 * d, F * N
    cws, cwf = level_cw_planar(keys, level)
    packed, oseeds, oflags = expand_cuda.expand_packed(
        st.seed.reshape(4, d2, B), st.bit.reshape(d2, B),
        st.y_bit.reshape(d2, B), cws, cwf, prg.DERIVED_BITS, want_children,
    )
    packed = packed.reshape(F, N)
    if not want_children:
        return packed, None
    return packed, PlanarChildren(seed=oseeds.reshape(2, 4, d, 2, F, N),
                                  flags=oflags.reshape(d, 2, F, N))


def advance_from_children(children: PlanarChildren, parent_idx: torch.Tensor,
                          pattern_bits: torch.Tensor, n_alive: int) -> Frontier:
    """Materialise the surviving children from the expand-time cache.

    parent_idx:   int64[F'] parent slot per surviving child (bucket-padded);
    pattern_bits: bool[F', d] child pattern per survivor;
    n_alive:      number of real entries (the rest is padding).

    A gather over the node axis plus a per-dim direction select; both keys
    of a dim take the same direction (ref: collect.rs:100)."""
    _, _, d, _, _, N = children.seed.shape
    F2 = parent_idx.shape[0]
    dev = parent_idx.device
    seed = torch.empty((4, d, 2, F2, N), dtype=torch.int32, device=dev)
    bit = torch.empty((d, 2, F2, N), dtype=torch.bool, device=dev)
    y_bit = torch.empty((d, 2, F2, N), dtype=torch.bool, device=dev)
    for j in range(d):
        dir_j = pattern_bits[:, j].to(torch.int64)  # [F']
        # advanced indices on axes 0 and 3 -> [F', 4, 2, N]
        g = children.seed[:, :, j][dir_j, :, :, parent_idx]
        seed[:, j] = g.permute(1, 2, 0, 3)
        fl = children.flags[j][:, parent_idx]  # [2, F', N]
        sh = dir_j.to(torch.uint8)[None, :, None]
        bit[j] = ((fl >> sh) & 1) != 0
        y_bit[j] = ((fl >> (sh + 2)) & 1) != 0
    alive = torch.arange(F2, device=dev) < n_alive
    return Frontier(states=EvalState(seed=seed, bit=bit, y_bit=y_bit), alive=alive)


def counts_by_pattern(packed_self: torch.Tensor, packed_peer: torch.Tensor,
                      masks: np.ndarray, alive_keys: torch.Tensor,
                      alive_nodes: torch.Tensor) -> torch.Tensor:
    """int64[F, 2^d] per-child counts: client i's ball contains child
    (f, c) iff the two servers' share bits agree on every compared
    position, ``(p0 ^ p1) & masks[c] == 0`` (the plaintext of the GC
    equality test, ref: equalitytest.rs:130-146).  Dead clients and dead
    nodes count zero (ref: collect.rs:495)."""
    diff = packed_self ^ packed_peer  # [F, N]
    gate = alive_nodes[:, None] & alive_keys[None, :]
    signed = np.asarray(masks, np.uint32).view(np.int32)
    cols = [(((diff & int(m)) == 0) & gate).sum(dim=1) for m in signed]
    return torch.stack(cols, dim=1)


def to_interleaved(states: EvalState) -> EvalState:
    """Plane-major (seed [4, d, 2, F, N], bits [d, 2, F, N]) -> interleaved
    ([F, N, d, 2, 4] / [F, N, d, 2]), the JAX package's XLA-engine layout."""
    return EvalState(
        seed=states.seed.permute(3, 4, 1, 2, 0),
        bit=states.bit.permute(2, 3, 0, 1),
        y_bit=states.y_bit.permute(2, 3, 0, 1),
    )


def to_planar(states: EvalState) -> EvalState:
    """Inverse of :func:`to_interleaved`."""
    return EvalState(
        seed=states.seed.permute(4, 2, 3, 0, 1),
        bit=states.bit.permute(2, 3, 0, 1),
        y_bit=states.y_bit.permute(2, 3, 0, 1),
    )


def states_from_numpy(states, device) -> EvalState:
    """Carry an interleaved frontier state given as numpy arrays (the JAX
    package's XLA-engine layout: seed uint32[F, N, d, 2, 4], bits
    bool[F, N, d, 2]) into the port's plane-major layout."""
    from ..utils import tensor_from_numpy, words_from_numpy

    dev = torch.device(device)
    as_bool = lambda a: tensor_from_numpy(a, dev, bool)
    st = to_planar(EvalState(seed=words_from_numpy(states.seed, dev),
                             bit=as_bool(states.bit), y_bit=as_bool(states.y_bit)))
    return EvalState(*(a.contiguous() for a in st))


# ---------------------------------------------------------------------------
# Host-side compaction helpers (leader-side prune bookkeeping)
# ---------------------------------------------------------------------------


def compact_survivors(keep: np.ndarray, f_max: int):
    """keep: bool[F, 2^d] -> (parent_idx int32[Fb], pattern int32[Fb],
    n_alive) zero-padded to the survivor bucket; survivors in row-major
    (node, pattern) order.  Raises if survivors exceed ``f_max``."""
    f, c = np.nonzero(keep)
    fb = bucket_for(len(f), f_max)
    parent = np.zeros(fb, np.int32)
    pattern = np.zeros(fb, np.int32)
    parent[: len(f)] = f
    pattern[: len(f)] = c
    return parent, pattern, len(f)


def pattern_to_bits(pattern: np.ndarray, d: int) -> np.ndarray:
    """int32[F'] child pattern ids -> bool[F', d] per-dim direction bits
    (bit j = (c >> j) & 1, ref: lib.rs:125-129)."""
    return ((pattern[:, None] >> np.arange(d)[None]) & 1).astype(bool)
