"""Aggregation engine: the prefix-tree frontier crawl on tensors.

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
states, so advancing past the prune is a gather, not a second PRG pass.  The
streaming crawl (``driver.Leader`` over ``ibdcf.HostKeys``) keeps no child cache: it
feeds the expansion one level's correction words from a host window
(:func:`expand_share_bits_from_cw`) and re-expands the surviving parents,
``node_chunk`` at a time (:func:`advance_from_cw`).  A level may also be
crawled in node spans (:func:`shard_spans`), as the socket server does.

Radix-2^k level fusion (``Config.crawl_radix_bits``) crawls k bit levels
per round: :func:`expand_share_bits_radix` builds each node's depth-r
subtree from r passes of the same expand kernel over a virtual frontier
of ``F * 2^t`` rows, and packs every subtree node's share bits into one
32-bit word (:func:`check_radix` bounds n_dims so they fit).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import expand_cuda, prg
from ..ops.ibdcf import EvalState, IbDcfKeyBatch, cw_level_major, eval_init

MAX_DIMS = 8  # the packed 32-bit word holds d*4 bits (radix 1; see check_radix)


def radix_subtree_nodes(radix: int) -> int:
    """Nodes in the depth-``radix`` binary subtree below one (dim, side)
    frontier state: 2 + 4 + ... + 2^radix = 2^(radix+1) - 2.  The packed
    word stores all of them per (dim, side), so a fused level compares
    every depth along a child pattern's path."""
    return (1 << (radix + 1)) - 2


def max_dims_for_radix(radix: int) -> int:
    """Dim cap keeping 2·d·radix_subtree_nodes(radix) packed bits in one
    32-bit word: 8 dims at radix 1 (== MAX_DIMS), 2 at radix 2, 1 at 3."""
    return 32 // (2 * radix_subtree_nodes(radix))


def check_radix(d: int, radix: int) -> None:
    """Refuse a crawl radix the packed 32-bit layout cannot hold, where the
    radix is used, instead of a silent bit collision mid-crawl."""
    if radix not in (1, 2, 3):
        raise ValueError(f"crawl_radix_bits={radix}: supported radices are 1, 2, 3")
    cap = max_dims_for_radix(radix)
    if d > cap:
        raise ValueError(
            f"crawl_radix_bits={radix} supports at most {cap} dim(s): the "
            f"packed share-bit word needs 2·d·(2^(radix+1)-2) bits per "
            f"(node, client) and must fit one uint32; got n_dims={d}"
        )


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


def bucket_for(n_alive: int, f_max: int, min_bucket: int = 1) -> int:
    """Smallest power of two ≥ ``n_alive`` (and ≥ ``min_bucket``), capped by
    ``f_max``; more than ``f_max`` survivors raise.  ``min_bucket`` changes
    shapes only, never hitters."""
    if n_alive > f_max:
        raise ValueError(
            f"{n_alive} surviving nodes exceed f_max={f_max}; "
            "raise f_max or the threshold"
        )
    b = 1 << max(0, int(np.ceil(np.log2(max(1, n_alive)))))
    return min(f_max, max(b, min_bucket))


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
    cws, cwf = cw_level_major(keys, level, level + 1)
    return cws[0], cwf[0]


def expand_share_bits(keys: IbDcfKeyBatch, frontier: Frontier, level: int,
                      want_children: bool = True):
    """One PRG expansion of the whole frontier -> ``(packed int32[F, N],
    children)``: the share bits ``y ^ t`` of both child directions of
    every (dim, side) key at ``_bit_positions``, and the
    :class:`PlanarChildren` cache (None when ``want_children`` is False,
    the last level).  The expansion is ``ops/expand_cuda.expand_packed``:
    the kernel on a card, its plain version on the CPU."""
    return expand_share_bits_from_cw(level_cw_planar(keys, level), frontier, want_children)


def expand_share_bits_from_cw(cw, frontier: Frontier, want_children: bool = True):
    """:func:`expand_share_bits` fed one level's correction words directly,
    ``cw = (cws int32[4, d2, N], cwf uint8[d2, N])`` as
    :func:`level_cw_planar` builds them: the streaming crawl holds its keys
    in host memory and uploads only windows of levels."""
    cws, cwf = cw
    st = frontier.states
    d, _, F, N = st.bit.shape
    d2, B = 2 * d, F * N
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
    states = _empty_states(d, F2, N, parent_idx.device)
    _select_children(children, parent_idx, pattern_bits, states)
    return Frontier(states=states, alive=torch.arange(F2, device=parent_idx.device) < n_alive)


def _empty_states(d: int, F: int, N: int, dev) -> EvalState:
    return EvalState(seed=torch.empty((4, d, 2, F, N), dtype=torch.int32, device=dev),
                     bit=torch.empty((d, 2, F, N), dtype=torch.bool, device=dev),
                     y_bit=torch.empty((d, 2, F, N), dtype=torch.bool, device=dev))


def _select_children(children: PlanarChildren, idx: torch.Tensor,
                     pattern_bits: torch.Tensor, out: EvalState) -> None:
    """Write child ``idx[i]`` of the cache (per dim ``idx[i, j]`` when
    ``idx`` is [F', d]), in direction ``pattern_bits[i]`` per dim, into
    node slot ``i`` of ``out`` (seed [4, d, 2, F', N], bits [d, 2, F', N];
    views are written in place)."""
    d = children.seed.shape[2]
    for j in range(d):
        dir_j = pattern_bits[:, j].to(torch.int64)  # [F']
        idx_j = idx[:, j] if idx.dim() == 2 else idx
        # advanced indices on axes 0 and 3 -> [F', 4, 2, N]
        g = children.seed[:, :, j][dir_j, :, :, idx_j]
        out.seed[:, j] = g.permute(1, 2, 0, 3)
        fl = children.flags[j][:, idx_j]  # [2, F', N]
        sh = dir_j.to(torch.uint8)[None, :, None]
        out.bit[j] = ((fl >> sh) & 1) != 0
        out.y_bit[j] = ((fl >> (sh + 2)) & 1) != 0


def advance_from_cw(cw, frontier: Frontier, parent_idx: torch.Tensor,
                    pattern_bits: torch.Tensor, n_alive: int,
                    node_chunk: int | None = None) -> Frontier:
    """The streaming crawl's advance, with no child cache: re-expand the
    surviving parents with this level's ``cw`` (as
    :func:`expand_share_bits_from_cw` takes it) and keep each child's
    direction.  ``node_chunk`` parent slots at a time: gather their
    plane-major states, expand them with the child cache, select as
    :func:`advance_from_children` does, and write the chunk into the new
    frontier at its offset.  A chunk that does not tile the bucket is
    replaced by the whole bucket (both are powers of two in the crawl), so
    the peak is the old frontier, the new one and one chunk's expansion.
    The caller drops its references to ``frontier`` afterwards.

    parent_idx:   int64[F'] parent slot per surviving child (bucket-padded);
    pattern_bits: bool[F', d] child pattern per survivor;
    n_alive:      number of real entries (the rest is padding)."""
    st = frontier.states
    d, _, _, N = st.bit.shape
    F2 = parent_idx.shape[0]
    dev = parent_idx.device
    c = F2 if node_chunk is None else min(F2, node_chunk)
    if F2 % c:
        c = F2
    out = _empty_states(d, F2, N, dev)
    local = torch.arange(c, device=dev)
    for lo in range(0, F2, c):
        pidx = parent_idx[lo:lo + c]
        parents = Frontier(states=EvalState(seed=st.seed.index_select(3, pidx),
                                            bit=st.bit.index_select(2, pidx),
                                            y_bit=st.y_bit.index_select(2, pidx)),
                           alive=frontier.alive.index_select(0, pidx))
        _, children = expand_share_bits_from_cw(cw, parents, want_children=True)
        del parents
        chunk = EvalState(seed=out.seed[:, :, :, lo:lo + c], bit=out.bit[:, :, lo:lo + c],
                          y_bit=out.y_bit[:, :, lo:lo + c])
        _select_children(children, local, pattern_bits[lo:lo + c], chunk)
        del children
    return Frontier(states=out, alive=torch.arange(F2, device=dev) < n_alive)


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
# Node spans of a level (the socket server's ``shard`` requests)
# ---------------------------------------------------------------------------


def shard_spans(f_bucket: int, shard_nodes: int) -> list:
    """Node-axis spans ``[(lo, hi), ...]`` covering ``[0, f_bucket)``, a
    pure function of public values so the leader and both servers agree.
    ``shard_nodes <= 0`` gives one span, the whole bucket."""
    if shard_nodes <= 0 or f_bucket <= shard_nodes:
        return [(0, f_bucket)]
    return [(lo, min(lo + shard_nodes, f_bucket)) for lo in range(0, f_bucket, shard_nodes)]


def frontier_slice(frontier: Frontier, lo: int, hi: int) -> Frontier:
    """Node slots ``[lo, hi)`` of the frontier (views: axis 3 of the
    seeds, axis 2 of the bits, the alive mask)."""
    st = frontier.states
    return Frontier(states=EvalState(seed=st.seed[:, :, :, lo:hi], bit=st.bit[:, :, lo:hi],
                                     y_bit=st.y_bit[:, :, lo:hi]),
                    alive=frontier.alive[lo:hi])


def children_cat(parts: list) -> PlanarChildren:
    """One level's child cache from per-span caches ``[(lo, children),
    ...]`` in any order: concatenated along the node axis in ``lo`` order,
    the inverse of :func:`frontier_slice`."""
    parts = [c for _, c in sorted(parts, key=lambda t: t[0])]
    return PlanarChildren(seed=torch.cat([p.seed for p in parts], dim=4),
                          flags=torch.cat([p.flags for p in parts], dim=2))


# ---------------------------------------------------------------------------
# Host-side compaction helpers (leader-side prune bookkeeping)
# ---------------------------------------------------------------------------


def compact_survivors(keep: np.ndarray, f_max: int, min_bucket: int = 1):
    """keep: bool[F, 2^d] -> (parent_idx int32[Fb], pattern int32[Fb],
    n_alive) zero-padded to the survivor bucket ``bucket_for(n_alive,
    f_max, min_bucket)``; survivors in row-major (node, pattern) order.
    Raises if survivors exceed ``f_max``."""
    f, c = np.nonzero(keep)
    fb = bucket_for(len(f), f_max, min_bucket)
    parent = np.zeros(fb, np.int32)
    pattern = np.zeros(fb, np.int32)
    parent[: len(f)] = f
    pattern[: len(f)] = c
    return parent, pattern, len(f)


def pattern_to_bits(pattern: np.ndarray, d: int) -> np.ndarray:
    """int32[F'] child pattern ids -> bool[F', d] per-dim direction bits
    (bit j = (c >> j) & 1, ref: lib.rs:125-129)."""
    return ((pattern[:, None] >> np.arange(d)[None]) & 1).astype(bool)


# ---------------------------------------------------------------------------
# Radix-2^k level fusion: crawl ``radix`` bits per round trip.
#
# A fused level expands every frontier node by all 2^(radix·d) child
# patterns at once.  Pattern ids are step-major: c = Σ_t step_t << (t·d),
# step_t the per-dim pattern of bit level (base + t), so dim j's direction
# at step t is ``(c >> (t·d + j)) & 1``; at radix 1 this is the radix-1
# child order.  Per (dim j, side s) the packed word stores the share bit
# of every node of the depth-``radix`` subtree, depth i's 2^i nodes
# little-endian in step order (the child of node m in direction r at depth
# i + 1 is ``m | r << i``), at bit
#
#     j·2T + s·T + (2^i - 2) + node,      T = radix_subtree_nodes(radix),
#
# the radix-1 layout when T = 2.  Membership of a fused child is the
# conjunction of its per-depth memberships, so the masks of
# :func:`pattern_masks_radix` count what radix 1 counts at the deepest
# level.
#
# The JAX package expands a fused level in XLA.  Here it is r passes of the
# expand kernel: pass t runs on a virtual frontier of F·2^t rows ordered
# (node f, subtree node m) — every dim has the same node range, so it is
# one ordinary expansion of B = F·2^t·N rows with level ``base + t``'s
# correction words — and its child states, reordered to subtree index
# ``dir·2^t + m``, are the next pass's input.  The last pass's child cache
# is the radix cache as it stands: the fused leaf ``idx_j = Σ_t b_t << t``
# of dim j is virtual row ``parent·2^(r-1) + (idx_j mod 2^(r-1))`` in
# direction ``idx_j >> (r-1)``.
# ---------------------------------------------------------------------------


def _radix_positions(d: int, radix: int, step: int) -> np.ndarray:
    """uint32[d, 2, 2^(step+1)] — packed-bit positions of every
    depth-(step+1) subtree node per (dim, side).  ``_bit_positions`` at
    (radix, step) = (1, 0)."""
    T = radix_subtree_nodes(radix)
    j = np.arange(d)[:, None, None]
    s = np.arange(2)[None, :, None]
    m = np.arange(2 << step)[None, None, :]
    return (j * (2 * T) + s * T + ((2 << step) - 2) + m).astype(np.uint32)


@lru_cache(maxsize=None)
def pattern_masks_radix(d: int, radix: int) -> np.ndarray:
    """uint32[2^(radix·d)] — for fused child pattern c, the packed-bit
    positions a membership test compares: both sides of every dim at every
    depth 1..radix along c's path.  ``pattern_masks`` at radix 1."""
    if radix == 1:
        return pattern_masks(d)
    check_radix(d, radix)
    T = radix_subtree_nodes(radix)
    masks = []
    for c in range(1 << (radix * d)):
        m = np.uint32(0)
        node = [0] * d  # per-dim subtree node along c's path
        for t in range(radix):
            base = (2 << t) - 2
            for j in range(d):
                node[j] |= ((c >> (t * d + j)) & 1) << t
                p = np.uint32(j * 2 * T + base + node[j])
                m |= (np.uint32(1) << p) | (np.uint32(1) << (p + np.uint32(T)))
        masks.append(m)
    out = np.array(masks, dtype=np.uint32)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def _radix_spread(d: int, radix: int, step: int) -> np.ndarray:
    """int32[2^step · 2^(4d)] — pass ``step``'s scatter table: entry
    ``m·2^(4d) + v`` is the radix word bits of subtree node m's radix-1
    expansion word v (bit ``2p + dir`` of plane p = 2j + s goes to
    ``_radix_positions[j, s, dir·2^step + m]``)."""
    pos = _radix_positions(d, radix, step).astype(np.int64)  # [d, 2, 2M]
    M, V = 1 << step, 1 << (4 * d)
    v = np.arange(V)
    out = np.zeros((M, V), np.int64)
    for m in range(M):
        for j in range(d):
            for s in range(2):
                for r in range(2):
                    bit = (v >> (2 * (2 * j + s) + r)) & 1
                    out[m] |= bit << pos[j, s, r * M + m]
    return (out.reshape(-1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@lru_cache(maxsize=None)
def _radix_spread_on(d: int, radix: int, step: int, device: torch.device) -> torch.Tensor:
    """:func:`_radix_spread` on ``device``, copied there once: a copy from
    pageable host memory per pass would wait for the device each time."""
    return torch.from_numpy(_radix_spread(d, radix, step)).to(device)


def expand_share_bits_radix(keys: IbDcfKeyBatch, frontier: Frontier, level: int,
                            radix: int, want_children: bool = True):
    """:func:`expand_share_bits` over ``radix`` bit levels ``level ..
    level + radix - 1`` -> ``(packed int32[F, N], children)``: the share
    bits of every node of each (node, client)'s depth-``radix`` subtree in
    the radix layout, and the last pass's :class:`PlanarChildren` over the
    ``F · 2^(radix-1)`` virtual rows (None when ``want_children`` is
    False).  ``radix`` is this round's width: a crawl's tail round passes
    its shorter remainder.  Radix 1 is :func:`expand_share_bits`.  Each
    pass is one ``ops/expand_cuda.expand_packed`` call; its radix-1 word is
    scattered into the radix word through :func:`_radix_spread`."""
    if radix == 1:
        return expand_share_bits(keys, frontier, level, want_children)
    st = frontier.states
    d, _, F, N = st.bit.shape
    d2, V = 2 * d, 1 << (4 * d)
    dev = st.bit.device
    seed = st.seed.reshape(4, d2, F * N)
    t_bit, y_bit = st.bit.reshape(d2, F * N), st.y_bit.reshape(d2, F * N)
    word = torch.zeros((F, N), dtype=torch.int32, device=dev)
    for t in range(radix):
        M = 1 << t
        cws, cwf = level_cw_planar(keys, level + t)
        wc = want_children or t + 1 < radix
        packed, oseeds, oflags = expand_cuda.expand_packed(
            seed, t_bit, y_bit, cws, cwf, prg.DERIVED_BITS, wc)
        table = _radix_spread_on(d, radix, t, dev)
        idx = packed.view(F, M, N)
        if M > 1:
            idx = idx + (torch.arange(M, dtype=torch.int32, device=dev) * V)[None, :, None]
        spread = table.index_select(0, idx.reshape(-1)).view(F, M, N)
        # the M nodes' bits are disjoint: their int32 sum carries nowhere
        word |= spread.sum(1, dtype=torch.int32)
        del packed, idx, spread
        if t + 1 == radix:
            break
        # next pass: subtree node dir·M + m of every (node f, client n)
        seed = oseeds.view(2, 4, d2, F, M, N).permute(1, 2, 3, 0, 4, 5).reshape(4, d2, -1)
        fl = oflags.view(d2, F, 1, M, N)
        t_bit = torch.cat([(fl & 1) != 0, (fl & 2) != 0], dim=2).reshape(d2, -1)
        y_bit = torch.cat([(fl & 4) != 0, (fl & 8) != 0], dim=2).reshape(d2, -1)
        del oseeds, oflags, fl
    if not want_children:
        return word, None
    R = F << (radix - 1)
    return word, PlanarChildren(seed=oseeds.view(2, 4, d, 2, R, N),
                                flags=oflags.view(d, 2, R, N))


def advance_from_children_radix(children: PlanarChildren, parent_idx: torch.Tensor,
                                pattern_bits: torch.Tensor, n_alive: int,
                                radix: int) -> Frontier:
    """:func:`advance_from_children` for a fused level: each survivor's
    depth-``radix`` states, per dim from the cache row of its depth-(r-1)
    ancestor in its last step's direction.

    pattern_bits: bool[F', radix, d] step-major fused patterns
    (:func:`pattern_to_bits_radix`).  Radix 1 is the radix-1 advance."""
    if radix == 1:
        return advance_from_children(children, parent_idx, pattern_bits[:, 0, :], n_alive)
    _, _, d, _, _, N = children.seed.shape
    F2 = parent_idx.shape[0]
    dev = parent_idx.device
    w = (1 << torch.arange(radix - 1, device=dev))[None, :, None]
    low = (pattern_bits[:, :radix - 1].to(torch.int64) * w).sum(1)  # [F', d]
    rows = parent_idx.to(torch.int64)[:, None] * (1 << (radix - 1)) + low
    states = _empty_states(d, F2, N, dev)
    _select_children(children, rows, pattern_bits[:, radix - 1], states)
    return Frontier(states=states, alive=torch.arange(F2, device=dev) < n_alive)


def pattern_to_bits_radix(pattern: np.ndarray, d: int, radix: int) -> np.ndarray:
    """int[F'] fused child ids -> bool[F', radix, d] per-step direction
    bits (dim j at step t = ``(c >> (t·d + j)) & 1``, step-major);
    ``pattern_to_bits`` with a leading step axis at radix 1."""
    shift = np.arange(radix)[None, :, None] * d + np.arange(d)[None, None, :]
    return ((np.asarray(pattern)[:, None, None] >> shift) & 1).astype(bool)


@lru_cache(maxsize=None)
def radix_pattern_order(d: int, radix: int) -> np.ndarray:
    """int32[2^(radix·d)] — step-major fused pattern ids in the radix-1
    crawl's survivor order.  Radix 1 lists a level's survivors by per-level
    pattern with earlier levels most significant; the step-major id puts
    the last step most significant, so walking fused children in
    ascending id would list (and, under ``f_max`` truncation, keep) a
    different set.  ``order[rank]`` with rank = Σ_t p_t·2^((radix-1-t)·d)
    restores the radix-1 order.  The identity at radix 1."""
    C = 1 << (radix * d)
    mask = (1 << d) - 1
    out = np.empty(C, np.int32)
    for c in range(C):
        rank = 0
        for t in range(radix):
            rank |= ((c >> (t * d)) & mask) << ((radix - 1 - t) * d)
        out[rank] = c
    out.setflags(write=False)
    return out
