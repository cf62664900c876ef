"""ibDCF — interval-bound Distributed Comparison Functions as tensor batches.

The port of ``fuzzyheavyhitters_tpu/ops/ibdcf.py`` (ref: src/ibDCF.rs).  A
batch of keys for one party is a tuple of tensors with arbitrary leading
batch dims (clients × dims × sides):

- ``key_idx``    bool[...]          which party (False = 0, True = 1)
- ``root_seed``  int32[..., 4]      128-bit root seed per key
- ``cw_seed``    int32[..., L, 4]   per-level correction seeds
- ``cw_bits``    bool[..., L, 2]    t-bit corrections (left, right)
- ``cw_y_bits``  bool[..., L, 2]    y-bit corrections (left, right)

Both parties' batches share the same correction-word tensors.  Keygen runs
the CUDA kernel on a card and its plain version on the CPU
(``ops/keygen_cuda.py``).  The client-side randomness is a
``numpy.random.Generator`` drawn in the JAX package's order, so one seed
gives the same keys in both packages.

The streaming crawl holds its keys in host memory as :class:`HostKeys`: the
correction words level-major in the expand kernel's planar layout, so one
window of levels is one contiguous slice (:func:`gen_l_inf_ball_host`
generates them on the card in client chunks).

Semantics: with keys on bound ``b``, the XOR of the two parties' share bits
after evaluating MSB-first input ``x`` is ``[x < b]`` for a side=True
("left") key and ``[x > b]`` for side=False ("right").
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import keygen_cuda, prg
from ..utils import bits as bitutils
from ..utils import resolve_device, tensor_from_numpy, words_from_numpy, words_to_numpy


class IbDcfKeyBatch(NamedTuple):
    """A batch of ibDCF keys for ONE party (ref: ibDCF.rs:17-21)."""

    key_idx: torch.Tensor
    root_seed: torch.Tensor
    cw_seed: torch.Tensor
    cw_bits: torch.Tensor
    cw_y_bits: torch.Tensor

    @property
    def data_len(self) -> int:
        return self.cw_seed.shape[-2]

    @property
    def batch_shape(self):
        return tuple(self.cw_seed.shape[:-2])


class HostKeys(NamedTuple):
    """ONE party's keys in host memory for the streaming crawl, the
    correction words level-major in the expand kernel's layout (see
    :func:`cw_level_major`):

    - ``key_idx``   bool[N, d, 2]
    - ``root_seed`` int32[N, d, 2, 4]
    - ``cws``       int32[L, 4, d2, N]  correction seeds, d2 = 2 * d planes
    - ``cwf``       uint8[L, d2, N]     bl | br<<1 | yl<<2 | yr<<3
    """

    key_idx: torch.Tensor
    root_seed: torch.Tensor
    cws: torch.Tensor
    cwf: torch.Tensor

    @property
    def data_len(self) -> int:
        return self.cws.shape[0]


class EvalState(NamedTuple):
    """Per-key incremental evaluation state (ref: ibDCF.rs:25-30)."""

    seed: torch.Tensor  # int32[..., 4]
    bit: torch.Tensor  # bool[...]
    y_bit: torch.Tensor  # bool[...]


def gen_pair(init_seeds: torch.Tensor, alpha_bits: torch.Tensor, side,
             derived_bits: bool | None = None):
    """Both parties' key batches (ref: ibDCF.rs:84-164).

    init_seeds: int32[..., 2, 4] fresh root seeds (party axis of 2);
    alpha_bits: bool[..., L] MSB-first bound per key;
    side:       bool[...] (or broadcastable) — True = "left"/less-than key.

    The batch is flattened to K keys for ``keygen_cuda.gen_cw``: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    batch = tuple(alpha_bits.shape[:-1])
    L = alpha_bits.shape[-1]
    dev = alpha_bits.device
    side = torch.as_tensor(side, dtype=torch.bool, device=dev).expand(batch)
    K = int(np.prod(batch)) if batch else 1
    cw_seed, cw_bits, cw_y = keygen_cuda.gen_cw(
        init_seeds.reshape(K, 2, 4), alpha_bits.reshape(K, L),
        side.reshape(K), derived_bits,
    )

    def mk(p: int) -> IbDcfKeyBatch:
        return IbDcfKeyBatch(
            key_idx=torch.full(batch, bool(p), dtype=torch.bool, device=dev),
            root_seed=init_seeds[..., p, :],
            cw_seed=cw_seed.reshape(batch + (L, 4)),
            cw_bits=cw_bits.reshape(batch + (L, 2)),
            cw_y_bits=cw_y.reshape(batch + (L, 2)),
        )

    return mk(0), mk(1)


def eval_init(key: IbDcfKeyBatch) -> EvalState:
    """Root state: seed = root seed, t = y = key_idx (ref: ibDCF.rs:229-236)."""
    return EvalState(seed=key.root_seed, bit=key.key_idx, y_bit=key.key_idx)


def level_cw(key: IbDcfKeyBatch, level: int):
    """Correction words at one level: (seed[..., 4], bits[..., 2], y[..., 2])."""
    if not 0 <= level < key.data_len:
        raise IndexError(f"level {level} out of range for data_len {key.data_len}")
    return (key.cw_seed[..., level, :], key.cw_bits[..., level, :],
            key.cw_y_bits[..., level, :])


def cw_level_major(key: IbDcfKeyBatch, lo: int = 0, hi: int | None = None):
    """Correction words of levels ``[lo, hi)`` in the expand kernel's
    layout, level-major: ``cws`` int32[W, 4, d2, N] and ``cwf`` uint8[W, d2,
    N] with plane p = dim * 2 + side and flags bl|br<<1|yl<<2|yr<<3, for a
    batch [N, d, 2]."""
    N, d = key.cw_seed.shape[:2]
    sl = slice(lo, hi)
    cws = key.cw_seed[..., sl, :]
    W = cws.shape[-2]
    cws = cws.permute(3, 4, 1, 2, 0).reshape(W, 4, 2 * d, N)
    u8 = lambda a, s: a.to(torch.uint8) << s
    b, y = key.cw_bits[..., sl, :], key.cw_y_bits[..., sl, :]
    cwf = u8(b[..., 0], 0) | u8(b[..., 1], 1) | u8(y[..., 0], 2) | u8(y[..., 1], 3)
    return cws.contiguous(), cwf.permute(3, 1, 2, 0).reshape(W, 2 * d, N).contiguous()


def host_keys(key: IbDcfKeyBatch) -> HostKeys:
    """A key batch [N, d, 2] as :class:`HostKeys` in host memory."""
    cws, cwf = cw_level_major(key)
    return HostKeys(key_idx=key.key_idx.cpu(), root_seed=key.root_seed.cpu(),
                    cws=cws.cpu(), cwf=cwf.cpu())


def eval_bit(cw, state: EvalState, direction: torch.Tensor,
             derived_bits: bool | None = None) -> EvalState:
    """Advance every key one level (ref: ibDCF.rs:208-227); ``direction``
    bool[...] is the input bit taken at this level (True = right)."""
    cw_seed, cw_bits, cw_y = cw
    s_l, s_r, tau_b, tau_y = prg.expand(state.seed, derived_bits)
    d = direction
    seed = torch.where(d[..., None], s_r, s_l)
    new_bit = torch.where(d, tau_b[..., 1], tau_b[..., 0])
    new_y = torch.where(d, tau_y[..., 1], tau_y[..., 0])
    cw_bit_d = torch.where(d, cw_bits[..., 1], cw_bits[..., 0])
    cw_y_d = torch.where(d, cw_y[..., 1], cw_y[..., 0])
    t = state.bit
    seed = torch.where(t[..., None], seed ^ cw_seed, seed)
    new_bit = new_bit ^ (t & cw_bit_d)
    new_y = new_y ^ (t & cw_y_d) ^ state.y_bit  # y accumulates along the path
    return EvalState(seed=seed, bit=new_bit, y_bit=new_y)


def eval_full(key: IbDcfKeyBatch, idx_bits: torch.Tensor,
              derived_bits: bool | None = None) -> EvalState:
    """Evaluate the whole MSB-first input, level by level."""
    if idx_bits.shape[-1] != key.data_len:
        raise ValueError(f"input has {idx_bits.shape[-1]} bits, keys {key.data_len} levels")
    state = eval_init(key)
    for lvl in range(key.data_len):
        state = eval_bit(level_cw(key, lvl), state, idx_bits[..., lvl], derived_bits)
    return state


def share_bit(state: EvalState) -> torch.Tensor:
    """Per-party FSS output share bit (ref: ibDCF.rs:249, collect.rs:399-404)."""
    return state.y_bit ^ state.bit


def best_engine(device=None) -> str:
    """The keygen engine a device gets: the CUDA kernel on a card, the plain
    version on the CPU."""
    return "cuda" if resolve_device(device).type == "cuda" else "plain"


# ---------------------------------------------------------------------------
# Interval / L∞-ball key generation (client-side, host-facing API)
# ---------------------------------------------------------------------------


def _rng_seeds(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=tuple(shape) + (2, 4), dtype=np.uint32)


def _gen_on(alpha: np.ndarray, side: np.ndarray, seeds: np.ndarray, device):
    dev = resolve_device(device)
    return gen_pair(
        words_from_numpy(seeds, dev),
        tensor_from_numpy(alpha, dev, bool),
        tensor_from_numpy(side, dev, bool),
    )


def _to_limbs(bits: np.ndarray, pad: int) -> np.ndarray:
    """bool[..., L] MSB-first -> uint64[..., W] big-endian limbs (``pad``
    zero bits in front so that L + pad = 64 W)."""
    bits = np.concatenate([np.zeros(bits.shape[:-1] + (pad,), bool), bits], axis=-1)
    by = np.packbits(bits, axis=-1)  # MSB-first bytes
    return by.reshape(by.shape[:-1] + (-1, 8)).view(">u8")[..., 0].astype(np.uint64)


def _from_limbs(limbs: np.ndarray, pad: int) -> np.ndarray:
    by = np.ascontiguousarray(limbs.astype(">u8")).view(np.uint8)
    return np.unpackbits(by, axis=-1)[..., pad:].astype(bool)


def ball_bounds(points_bits, ball_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Saturating ``point ∓ ball_size`` per dimension on MSB-first
    bitstrings (bool[..., L]); saturation at the domain edges (see
    utils/bits.py).  The same results as the JAX package's bitwise ripple,
    computed as multi-limb uint64 arithmetic: one pass per 64-bit limb
    instead of one per bit, which at L = 512 and 2e5 clients is the
    difference between seconds and a fraction of one."""
    points = np.asarray(points_bits, bool)
    L = points.shape[-1]
    pad = (-L) % 64
    a = _to_limbs(points, pad)
    d = _to_limbs(bitutils.int_to_bits(L, min(ball_size, (1 << L) - 1)), pad)
    lo, hi = np.empty_like(a), np.empty_like(a)
    borrow = np.zeros(a.shape[:-1], bool)
    carry = np.zeros(a.shape[:-1], bool)
    for w in reversed(range(a.shape[-1])):  # least significant limb first
        x, dw = a[..., w], d[w]
        lo[..., w] = x - dw - borrow.astype(np.uint64)
        borrow = (x < dw) | ((x == dw) & borrow)
        t = x + dw
        hi[..., w] = t + carry.astype(np.uint64)
        carry = (t < x) | (carry & (hi[..., w] < t))
    if pad:  # a carry into the pad bits is an overflow of the L-bit domain
        carry |= (hi[..., 0] >> np.uint64(64 - pad)) != 0
    lo, hi = _from_limbs(lo, pad), _from_limbs(hi, pad)
    lo[borrow] = False  # saturate: point - size < 0  -> 0
    hi[carry] = True  # saturate: point + size >= 2^L -> 2^L - 1
    return lo, hi


def gen_l_inf_ball(points_bits, ball_size: int, rng: np.random.Generator,
                   device=None):
    """L∞-ball keys around MSB-first points (ref: ibDCF.rs:175-188).

    points_bits: bool[N, n_dims, L].  Returns both parties' key batches of
    shape [N, n_dims, 2] (trailing axis = (left-DCF, right-DCF)) on
    ``device`` (default cuda)."""
    lo, hi = ball_bounds(points_bits, ball_size)
    alpha = np.stack([lo, hi], axis=-2)  # [N, n_dims, 2, L]
    side = np.broadcast_to(np.array([True, False]), alpha.shape[:-1])
    return _gen_on(alpha, side, _rng_seeds(rng, alpha.shape[:-1]), device)


def gen_l_inf_ball_host(points_bits, ball_size: int, rng: np.random.Generator,
                        device=None, chunk: int = 32768):
    """:func:`gen_l_inf_ball` for a batch whose keys would crowd the card:
    keygen runs on ``device`` ``chunk`` clients at a time (drawing from
    ``rng`` in the same order), and each chunk's correction words are put
    level-major on the device and copied into host memory.  Returns both
    parties' :class:`HostKeys`; the two share their correction-word
    tensors, as the parties of :func:`gen_pair` do."""
    points = np.asarray(points_bits, bool)
    N, d, L = points.shape
    d2 = 2 * d
    cws = torch.empty((L, 4, d2, N), dtype=torch.int32)
    cwf = torch.empty((L, d2, N), dtype=torch.uint8)
    key_idx = [torch.empty((N, d, 2), dtype=torch.bool) for _ in range(2)]
    roots = [torch.empty((N, d, 2, 4), dtype=torch.int32) for _ in range(2)]
    for lo in range(0, N, chunk):
        hi = min(N, lo + chunk)
        parts = gen_l_inf_ball(points[lo:hi], ball_size, rng, device=device)
        c_s, c_f = cw_level_major(parts[0])
        cws[..., lo:hi].copy_(c_s)
        cwf[..., lo:hi].copy_(c_f)
        for p, k in enumerate(parts):
            key_idx[p][lo:hi].copy_(k.key_idx)
            roots[p][lo:hi].copy_(k.root_seed)
        del parts, c_s, c_f
    return tuple(HostKeys(key_idx=key_idx[p], root_seed=roots[p], cws=cws, cwf=cwf)
                 for p in range(2))


def gen_l_inf_ball_from_coords(coords: np.ndarray, ball_size: int,
                               rng: np.random.Generator, device=None):
    """i16 coordinate variant with clamping (ref: ibDCF.rs:189-205): bounds
    ``coord ∓ ball_size`` clamped to the i16 range, encoded as 16-bit
    MSB-first offset-binary bitstrings."""
    coords = np.asarray(coords, np.int64)
    lo = np.clip(coords - ball_size, -(1 << 15), (1 << 15) - 1)
    hi = np.clip(coords + ball_size, -(1 << 15), (1 << 15) - 1)
    to_bits = lambda v: (
        (((v[..., None] & 0xFFFF) ^ 0x8000).astype(np.uint32)
         >> np.arange(15, -1, -1)) & 1
    ).astype(bool)
    alpha = np.stack([to_bits(lo), to_bits(hi)], axis=-2)  # [N, d, 2, 16]
    side = np.broadcast_to(np.array([True, False]), alpha.shape[:-1])
    return _gen_on(alpha, side, _rng_seeds(rng, alpha.shape[:-1]), device)


def keys_from_numpy(batch, device) -> IbDcfKeyBatch:
    """Carry a key batch given as numpy arrays (e.g. the JAX package's
    ``IbDcfKeyBatch`` after ``np.asarray``) into the port: uint32 words
    become int32 bit patterns, flags stay bool."""
    dev = torch.device(device)
    as_bool = lambda a: tensor_from_numpy(a, dev, bool)
    return IbDcfKeyBatch(
        key_idx=as_bool(batch.key_idx),
        root_seed=words_from_numpy(batch.root_seed, dev),
        cw_seed=words_from_numpy(batch.cw_seed, dev),
        cw_bits=as_bool(batch.cw_bits),
        cw_y_bits=as_bool(batch.cw_y_bits),
    )


def keys_to_numpy(batch: IbDcfKeyBatch) -> IbDcfKeyBatch:
    """The wire form of a key batch (inverse of :func:`keys_from_numpy`):
    the five leaves of the JAX package's ``IbDcfKeyBatch`` as host numpy —
    ``key_idx`` bool, ``root_seed`` uint32[..., 4], ``cw_seed`` uint32[..., L,
    4], ``cw_bits``/``cw_y_bits`` bool[..., L, 2] — so that either package's
    server takes either package's upload."""
    as_bool = lambda t: t.detach().cpu().numpy().astype(bool, copy=False)
    return IbDcfKeyBatch(
        key_idx=as_bool(batch.key_idx),
        root_seed=words_to_numpy(batch.root_seed),
        cw_seed=words_to_numpy(batch.cw_seed),
        cw_bits=as_bool(batch.cw_bits),
        cw_y_bits=as_bool(batch.cw_y_bits),
    )
