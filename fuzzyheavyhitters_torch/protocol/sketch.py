"""Malicious-secure sketch: MAC'd payload DPFs and the sketch inner
products, as plain PyTorch (the port of ``fuzzyheavyhitters_tpu/protocol/
sketch.py`` and of the single-card programs of its
``parallel/sketch_shard.py``, bit for bit).

A client encodes its contribution as a payload DPF whose per-level value is
the pair ``(x, k·x)`` for a per-client MAC key ``k`` (ref:
src/sketch.rs:8-24, 79-130); each server holds additive shares of the
one-hot value vector over a tree level.  Against a shared random vector r
the servers compute

    r_x  = <r, x>,   r2_x = <r², x>,   r_kx = <r, k·x>

and verify with Beaver triples (``protocol/mpc.py``) that

    1.  <r,x>² − <r²,x>        = 0     (one-hot / 0-1 vector check)
    2.  k·k − k²               = 0     (MAC-key share consistency)
    3.  k·<r,x> − <r,kx>       = 0     (MAC check: no additive attack)

(mpc.rs:103-141).  A failing client's liveness flag flips, which gates every
count after it (collect.rs:32, 495).  A client with d dimensions submits d
payload DPFs sharing one MAC key; it fails if any dimension fails.  From
depth 2 on the servers verify the shares of frontier survivors only; depth
1 is verified in full at level 0, before the first threshold (see the JAX
module's scope note).

**The challenge ratchet.**  A level's challenge seed is
SHA-256(tag ‖ root ‖ level ‖ transcript)[:16]: the root is the data plane's
coin flip committed at ``tree_init``, the transcript a digest of every
survivor table the leader applied.  Both are checkpointed with the
frontier, so a level re-run after a recovery replays the identical
challenge: re-opening its Beaver slab is a replay, never a second opening
under fresh randomness (which would leak ``<r - r', x>``).

Field values are the tensors of ``ops/fields.py`` (FE62 ``int64``, F255
``int32[..., 8]``); seeds ``int32[4]`` tensors or uint32 numpy words.  On
the wire every leaf is the JAX package's dtype: bool, uint32, FE62 as
uint64, F255 as uint32[..., 8] (:func:`wire`, :func:`sketch_to_numpy`).
"""

from __future__ import annotations

import hashlib
import struct
from typing import NamedTuple

import numpy as np
import torch

from ..ops import dpf, prg
from ..ops.dpf import DpfKeyBatch
from ..utils import tensor_from_numpy, words_from_numpy
from . import mpc

LANES = 2  # payload lanes: (x, k·x)

# ---------------------------------------------------------------------------
# The challenge ratchet (pure hashing: the JAX package's bytes exactly)
# ---------------------------------------------------------------------------

_RATCHET_TAG = b"fhh-sketch-ratchet/1"


def transcript_init() -> bytes:
    """Root of the crawl transcript digest."""
    return hashlib.sha256(_RATCHET_TAG).digest()


def transcript_absorb(digest: bytes, level: int, parent: np.ndarray, pat_bits: np.ndarray,
                      n_alive: int) -> bytes:
    """Fold one prune's survivor table into the digest: ``<qq`` (level,
    n_alive), the live parents as little-endian int64, the live pattern
    bits as numpy bool bytes (``[F', d]`` or ``[F', r, d]``: the bytes do
    not depend on the shape).  The bucket padding is left out: it varies
    with ``min_bucket`` and must not move the challenge."""
    h = hashlib.sha256(digest)
    h.update(struct.pack("<qq", int(level), int(n_alive)))
    h.update(np.ascontiguousarray(np.asarray(parent[:n_alive], np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(pat_bits[:n_alive], bool)).tobytes())
    return h.digest()


def ratchet_seed(root_seed, level: int, digest: bytes) -> np.ndarray:
    """One level's challenge seed: uint32[4] = SHA-256(tag ‖ root ‖ level ‖
    transcript)[:16]."""
    h = hashlib.sha256(_RATCHET_TAG)
    h.update(np.ascontiguousarray(np.asarray(root_seed, np.uint32)).tobytes())
    h.update(struct.pack("<q", int(level)))
    h.update(digest)
    return np.frombuffer(h.digest()[:16], dtype="<u4").copy()


_WINDOW_TAG = b"fhh-sketch-window-root/1"


def window_root(session_seed, window: int) -> np.ndarray:
    """A streaming window's ratchet root: uint32[4] = SHA-256(tag ‖ session
    coin flip ‖ window)[:16] (the windows that commit it are not ported)."""
    h = hashlib.sha256(_WINDOW_TAG)
    h.update(np.ascontiguousarray(np.asarray(session_seed, np.uint32)).tobytes())
    h.update(struct.pack("<q", int(window)))
    return np.frombuffer(h.digest()[:16], dtype="<u4").copy()


# ---------------------------------------------------------------------------
# Keys and their wire form
# ---------------------------------------------------------------------------


class SketchKeyBatch(NamedTuple):
    """One party's sketch keys for N clients (ref: sketch.rs:14-24): one DPF
    key per (client, dim) — batch dims ``[N, d]`` —, MAC keys per client,
    triples per (client, dim, level, check)."""

    key: DpfKeyBatch  # batch dims [N, d]
    mac_key: torch.Tensor  # field_t share [N]
    mac_key2: torch.Tensor  # field_t share of k² [N]
    mac_key_last: torch.Tensor  # field_u share [N(, limbs)]
    mac_key2_last: torch.Tensor
    triples: mpc.TripleBatch  # field_t [N, d, L-1, CHECKS]
    triples_last: mpc.TripleBatch  # field_u [N, d, CHECKS(, limbs)]


class SketchOutput(NamedTuple):
    """Per-row sketch inner products and the shared coefficients
    (ref: sketch.rs:26-43)."""

    r_x: torch.Tensor
    r2_x: torch.Tensor
    r_kx: torch.Tensor
    rand1: torch.Tensor
    rand2: torch.Tensor
    rand3: torch.Tensor


def sketch_leaves(sk: SketchKeyBatch) -> list:
    """The 16 leaves in the order of the JAX package's ``jax.tree.leaves``:
    the DPF key's six, the four MAC shares, triples a, b, c, triples_last
    a, b, c."""
    return [*sk.key, sk.mac_key, sk.mac_key2, sk.mac_key_last, sk.mac_key2_last,
            *sk.triples, *sk.triples_last]


def sketch_from_leaves(leaves) -> SketchKeyBatch:
    lv = list(leaves)
    if len(lv) != 16:
        raise ValueError(f"a sketch key batch has 16 leaves, got {len(lv)}")
    return SketchKeyBatch(DpfKeyBatch(*lv[:6]), *lv[6:10], mpc.TripleBatch(*lv[10:13]),
                          mpc.TripleBatch(*lv[13:16]))


def wire(t: torch.Tensor) -> np.ndarray:
    """A tensor in its wire dtype: int64 (FE62) as uint64, int32 (seeds,
    F255 limbs) as uint32, bool as bool."""
    a = t.detach().cpu().contiguous().numpy()
    if a.dtype == np.int64:
        return a.view(np.uint64)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def from_wire(a, device) -> torch.Tensor:
    """:func:`wire`'s inverse."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        return tensor_from_numpy(a.view(np.int64), device)
    if a.dtype == np.uint32:
        return words_from_numpy(a, device)
    return tensor_from_numpy(a, device)


def sketch_to_numpy(sk: SketchKeyBatch) -> list:
    """The 16 leaves as the wire's numpy arrays (an ``add_keys`` entry)."""
    return [wire(t) for t in sketch_leaves(sk)]


def sketch_from_numpy(leaves, device) -> SketchKeyBatch:
    return sketch_from_leaves([from_wire(a, device) for a in leaves])


def map_sketch(fn, sk: SketchKeyBatch) -> SketchKeyBatch:
    """``fn`` on every leaf that is not None."""
    f = lambda x: None if x is None else fn(x)
    tr = lambda t: None if t is None else mpc.TripleBatch(*map(f, t))
    return SketchKeyBatch(DpfKeyBatch(*map(f, sk.key)), f(sk.mac_key), f(sk.mac_key2),
                          f(sk.mac_key_last), f(sk.mac_key2_last), tr(sk.triples),
                          tr(sk.triples_last))


def _seed(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(device)
    return words_from_numpy(np.asarray(seed, np.uint32), device)


def gen(init_seeds, alpha_bits, field_t, field_u, seed, device
        ) -> tuple[SketchKeyBatch, SketchKeyBatch]:
    """Client-side keygen (ref: sketch.rs:79-149) on ``device``: unit
    payloads (x = 1 at the client's prefix) MAC'd with fresh per-client
    keys, and the triples of every (dim, level)'s checks.

    init_seeds: uint32[N(, d), 2, 4]; alpha_bits: bool[N(, d), L] (numpy) —
    one payload DPF per dimension sharing the client's MAC key; seed:
    uint32[4] client-side randomness.  1-D callers may omit the dim axis."""
    alpha = tensor_from_numpy(np.asarray(alpha_bits, bool), device)
    seeds = _seed(init_seeds, device)
    if alpha.dim() == 2:  # [N, L] -> [N, 1, L]
        alpha, seeds = alpha[:, None, :], seeds[:, None]
    N, d, L = alpha.shape
    wt, wu = 4, (8 if field_u.limb_shape else 4)
    base = _seed(seed, device)

    def sub_seed(tag):
        s = base.clone()
        s[3] ^= tag
        return s

    def stream(tag, n, w):
        return prg.stream_words(sub_seed(tag), n * w)

    # MAC keys and their shares (per client, shared across its dims)
    k = field_t.sample(stream(1, N, wt).reshape(N, wt))
    k2 = field_t.mul(k, k)
    k_last = field_u.sample(stream(2, N, wu).reshape(N, wu))
    k2_last = field_u.mul(k_last, k_last)

    def share(field, v, tag):
        w = 8 if field.limb_shape else 4
        bshape = tuple(v.shape[:v.dim() - len(field.limb_shape)])
        s0 = field.sample(stream(tag, int(np.prod(bshape)), w).reshape(bshape + (w,)))
        return s0, field.sub(v, s0)

    k_s, k2_s = share(field_t, k, 3), share(field_t, k2, 4)
    kl_s, k2l_s = share(field_u, k_last, 5), share(field_u, k2_last, 6)

    # payload values: inner levels (1, k) in T; the last level (1, k_last) in U
    one_t = field_t.from_int(1, device).expand(N)
    vals = torch.stack([one_t, k], dim=-1)[:, None, None, :].expand(N, d, L - 1, LANES)
    limb = field_u.limb_shape
    one_u = field_u.from_int(1, device).expand((N, d) + limb)
    k_lb = k_last[:, None].expand((N, d) + limb)
    vals_last = torch.stack([one_u, k_lb], dim=2)  # [N, d, LANES(, limbs)]
    dk0, dk1 = dpf.gen_pair(seeds, alpha, vals, vals_last, field_t, field_u, LANES)
    t0, t1 = mpc.gen_triples(field_t, (N, d, L - 1, mpc.CHECKS), sub_seed(7))
    tl0, tl1 = mpc.gen_triples(field_u, (N, d, mpc.CHECKS), sub_seed(8))

    def mk(p, dk, trip, trip_last):
        return SketchKeyBatch(key=dk, mac_key=k_s[p], mac_key2=k2_s[p], mac_key_last=kl_s[p],
                              mac_key2_last=k2l_s[p], triples=trip, triples_last=trip_last)

    return mk(0, dk0, t0, tl0), mk(1, dk1, t1, tl1)


# ---------------------------------------------------------------------------
# The shared challenge stream
# ---------------------------------------------------------------------------

_STREAM_TAG = 0x5E71C  # the level-domain word of the challenge stream


def _stream_seed(seed, level: int, device) -> torch.Tensor:
    s = _seed(seed, device).clone()
    s[2] ^= _STREAM_TAG
    s[3] ^= int(level)
    return s


def shared_r_stream(field, shared_seed, level: int, m: int, n_rand: int, device=None):
    """The servers' common randomness for one level: per-node r_j, then
    ``n_rand`` rows of rand1..3 (one a client x dim), from one CTR stream
    (the reference's shared rand_stream, sketch.rs:164-168)."""
    w = 8 if field.limb_shape else 4
    words = prg.stream_words(_stream_seed(shared_seed, level, device), (m + 3 * n_rand) * w)
    r = field.sample(words[:m * w].reshape(m, w))
    rands = field.sample(words[m * w:].reshape(n_rand, 3, w))
    return r, rands


def challenge_r(field, seed, level: int, m: int, device=None):
    """The level's per-node challenge r: words [0, m·w) of the stream.  m
    is the width of the checked node axis — the padded frontier bucket, or
    2 at the level-0 check — so both servers draw the same words."""
    w = 8 if field.limb_shape else 4
    words = prg.stream_words(_stream_seed(seed, level, device), m * w)
    return field.sample(words.reshape(m, w))


def challenge_rands(field, seed, level: int, m: int, row0: int, n_rows: int, device=None):
    """Rows [row0, row0 + n_rows) of the level's rand1..3 table: words
    ``m·w + row0·3·w`` on, reached by seeking the CTR stream to their block
    (bit-identical to the same rows of :func:`shared_r_stream`)."""
    w = 8 if field.limb_shape else 4
    span = n_rows * 3 * w
    word_lo = m * w + row0 * 3 * w
    blk0 = word_lo // 16
    off = word_lo - blk0 * 16
    nblk = (span + 15) // 16 + 1  # any intra-block offset fits
    blocks = prg.stream_blocks(_stream_seed(seed, level, device), nblk, blk0)
    words = blocks.reshape(nblk * 16)[off:off + span]
    return field.sample(words.reshape(n_rows, 3, w))


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------


def sketch_output(field, pair_shares, r, rands) -> SketchOutput:
    """Batched sketch inner products (ref: sketch.rs:157-199 sketch_at).

    pair_shares: field[..., M, LANES(, limbs)] — this server's value-pair
    shares over the level's M nodes; r: field[M(, limbs)]; rands:
    field[..., 3(, limbs)] matching the batch dims."""
    limb = len(field.limb_shape)
    if limb:
        x, kx = pair_shares[..., 0, :], pair_shares[..., 1, :]
    else:
        x, kx = pair_shares[..., 0], pair_shares[..., 1]
    m_axis = x.dim() - 1 - limb
    r2 = field.mul(r, r)
    r_x = field.sum(field.mul(x, r), dim=m_axis)
    r2_x = field.sum(field.mul(x, r2), dim=m_axis)
    r_kx = field.sum(field.mul(kx, r), dim=m_axis)
    g = lambda i: (rands[..., i, :] if limb else rands[..., i])
    return SketchOutput(r_x=r_x, r2_x=r2_x, r_kx=r_kx, rand1=g(0), rand2=g(1), rand3=g(2))


def mul_state(field, out: SketchOutput, mac_key, mac_key2, triples) -> mpc.MulStateBatch:
    """The three checks per batch row (ref: mpc.rs:83-141): (1) r_x*r_x -
    r2_x; (2) k*k - k²; (3) r_x*k - r_kx.  ``mac_key``/``mac_key2`` must
    broadcast to ``out.r_x``'s shape."""
    axis = out.r_x.dim() - len(field.limb_shape)
    stack = lambda *vs: torch.stack([v.expand(out.r_x.shape) for v in vs], dim=axis)
    return mpc.MulStateBatch(
        xs=stack(out.r_x, mac_key, out.r_x), ys=stack(out.r_x, mac_key, mac_key),
        zs=stack(field.neg(out.r2_x), field.neg(mac_key2), field.neg(out.r_kx)),
        rs=stack(out.rand1, out.rand2, out.rand3), triples=triples)


def level_check_state(field, pairs, triples: mpc.TripleBatch, mac_key, mac_key2, seed,
                      level: int, row0: int = 0) -> mpc.MulStateBatch:
    """One level's check state for a client slice: ``pairs``
    field[m, n, d, LANES(, limbs)] over the level's m nodes, per-client MAC
    shares [n(, limbs)], the per-(client, dim, check) triple slab; ``row0``
    is the slice's (client·dim)-row offset into the challenge stream."""
    m, n, d = pairs.shape[0], pairs.shape[1], pairs.shape[2]
    dev = pairs.device
    r = challenge_r(field, seed, level, m, dev)
    rands = challenge_rands(field, seed, level, m, row0, n * d, dev)
    rands = rands.reshape((n, d, 3) + field.limb_shape)
    out = sketch_output(field, torch.movedim(pairs, 0, 2), r, rands)  # [n, d, m, ...]
    return mul_state(field, out, mac_key.unsqueeze(1), mac_key2.unsqueeze(1), triples)


def verify_batch(field, state0: mpc.MulStateBatch, state1: mpc.MulStateBatch) -> np.ndarray:
    """In-process two-server verification: the cor and out exchanges.
    -> bool numpy, True where the row passes."""
    opened = mpc.cor(field, mpc.cor_share(field, state0), mpc.cor_share(field, state1))
    o0 = mpc.out_share(field, False, state0, opened)
    o1 = mpc.out_share(field, True, state1, opened)
    return mpc.verify(field, o0, o1).cpu().numpy()


# ---------------------------------------------------------------------------
# The server's three stages on one card (the single-device programs of the
# JAX package's parallel/sketch_shard.py; its row-sharded form over a
# server's data shards is this port's parallel/sketch_shard.py)
# ---------------------------------------------------------------------------


def cor_state(field, pairs, trip, mk, mk2, seed, level: int):
    """Stage 1: -> (the cor wire stack field[2, N, d, CHECKS(, limbs)], the
    check state, kept for stage 2)."""
    st = level_check_state(field, pairs, trip, mk, mk2, seed, level, 0)
    return torch.stack(mpc.cor_share(field, st)), st


def out_shares(field, state, cor_mine, cor_peer_np, server_idx: bool):
    """Stage 2: open (d, e) from both cor stacks (this server's first) and
    take this party's out shares field[N, d(, limbs)]."""
    peer = from_wire(cor_peer_np, cor_mine.device)
    opened = (field.add(cor_mine[0], peer[0]), field.add(cor_mine[1], peer[1]))
    return mpc.out_share(field, bool(server_idx), state, opened)


def verdicts(field, o_mine, o_peer_np):
    """Stage 3: bool[N], a client passes iff every dim's checks sum to zero."""
    return mpc.verify(field, o_mine, from_wire(o_peer_np, o_mine.device)).all(dim=1)


# ---------------------------------------------------------------------------
# Spec helpers over all prefixes of a level (small domains only)
# ---------------------------------------------------------------------------


def eval_level_full(key: SketchKeyBatch, level: int, field_t, field_u, data_len: int):
    """Value-pair shares for all 2^(level+1) prefixes at ``level``, by
    walking a ``2^data_len``-slot tree (slot i's direction at step j is bit
    ``data_len-1-j`` of i) -> field[..., 2^(level+1), LANES(, limbs)].
    Exponential in ``data_len``, so refused past 16: the server path is the
    frontier-following sketch state (``rpc.CollectorServer.sketch_verify``)."""
    if data_len > 16:
        raise ValueError(f"eval_level_full enumerates 2^data_len slots; data_len={data_len} "
                         "> 16 — use the frontier-following server path (rpc.sketch_verify)")
    k = key.key
    batch = tuple(k.root_seed.shape[:-1])
    nb, L, M = len(batch), data_len, 1 << data_len
    dev = k.root_seed.device
    st0 = dpf.eval_init(k)
    st = dpf.DpfEvalState(seed=st0.seed.unsqueeze(nb).expand(batch + (M, 4)),
                          t=st0.t.unsqueeze(nb).expand(batch + (M,)))
    slots = torch.arange(M, device=dev)
    shares = None
    for j in range(level + 1):
        cw = tuple(c.unsqueeze(-2) for c in dpf.level_cw(k, j))
        inner = j < data_len - 1
        field = field_t if inner else field_u
        cwv = (k.cw_val[..., j, :] if inner else k.cw_val_last).unsqueeze(nb)
        dirs = (((slots >> (L - 1 - j)) & 1) == 1).expand(batch + (M,))
        st, shares = dpf.eval_bit(cw, st, dirs, cwv, k.key_idx.unsqueeze(-1), field, LANES)
    idx = torch.arange(1 << (level + 1), device=dev) << (L - 1 - level)
    return torch.index_select(shares, nb, idx)


def verify_level(sk0: SketchKeyBatch, sk1: SketchKeyBatch, level: int, field_t, field_u,
                 data_len: int, shared_seed, sketch_batch_size: int = 100_000) -> np.ndarray:
    """Full two-server verification at one level -> bool[N]: per (client,
    dim) on ``[N, d]`` batches, a client passing iff every dim passes;
    chunked over clients by ``sketch_batch_size``.  A spec helper, under
    :func:`eval_level_full`'s domain limit."""
    last = level == data_len - 1
    field = field_u if last else field_t
    limb = field.limb_shape
    batch = tuple(sk0.key.root_seed.shape[:-1])
    N, extra = batch[0], batch[1:]
    m = 1 << (level + 1)
    dev = sk0.key.root_seed.device
    out = np.empty(N, bool)
    for lo in range(0, N, sketch_batch_size):
        sl = slice(lo, min(lo + sketch_batch_size, N))
        ks0, ks1 = (map_sketch(lambda a: a[sl], s) for s in (sk0, sk1))
        n_sl = ks0.key.root_seed.shape[0]
        # r drawn at the full-tree width and sliced (the JAX helper's draw)
        r_full, rands = shared_r_stream(field, shared_seed, level, 1 << data_len,
                                        n_sl * int(np.prod(extra, initial=1)), dev)
        r = r_full[:m]
        rands = rands.reshape((n_sl,) + extra + (3,) + limb)
        states = []
        for ks in (ks0, ks1):
            pairs = eval_level_full(ks, level, field_t, field_u, data_len)
            o = sketch_output(field, pairs, r, rands)
            if last:
                trip, mk, mk2 = ks.triples_last, ks.mac_key_last, ks.mac_key2_last
            else:
                trip, mk, mk2 = mpc.level_slab(ks.triples, level), ks.mac_key, ks.mac_key2
            if extra:  # per-client MACs over the dim axis
                mk, mk2 = mk.unsqueeze(1), mk2.unsqueeze(1)
            states.append(mul_state(field, o, mk, mk2, trip))
        ok = verify_batch(field, states[0], states[1])
        out[sl] = ok if not extra else ok.all(axis=tuple(range(1, ok.ndim)))
    return out
