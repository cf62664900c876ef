"""IKNP OT extension as plain PyTorch tensor ops (the port's copy).

The port of ``fuzzyheavyhitters_tpu/ops/otext.py``, bit for bit: column
PRG streams (``prg.stream_blocks``), the u-matrix XOR, the packed 32x32
butterfly transpose to 128-bit rows, and the OT-domain hash ``ot_hash``.

- 128 base OTs (``ops/baseot.py``) seed a session; the extension sender
  played base-OT receiver with its secret choice vector ``s``.
- Receiver, choice bits r: column streams ``t_i = G(k0_i)``, message
  ``u_i = t_i ^ G(k1_i) ^ r``; sender ``q_i = G(k_{s_i}) ^ s_i·u_i``, so
  row-wise ``Q_j = T_j ^ r_j·s`` (the Δ-OT the GC layer labels with).
- Chosen-payload pads ``H(j, Q_j)`` / ``H(j, Q_j ^ s)``.

Words are int32 bit patterns.  Every ``>>`` of the JAX package's uint32 is
logical; here each one is masked or feeds only bits a mask keeps.

A session's OT index (``consumed``) is a Python int; the pad tweak takes
it mod 2^32, which below 2^32 is the JAX package's ``uint32`` index
exactly (that package raises ``OverflowError`` past it).  Extensions run
in row slices of :data:`EXT_ROWS` (:func:`sender_extend_rows` /
:func:`receiver_extend_rows`) so the plain ChaCha's temporaries stay
bounded at any batch size; the slices concatenate to the whole extension.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from . import baseot, prg
from ..utils import words_from_numpy

KAPPA = 128  # security parameter: base-OT count == row width in bits
M32 = prg.M32

# OT-hash tweak constants (words 1..3); word 0 carries the OT index.
_OT_TWEAK1 = 0x4F545F31
_OT_TWEAK2 = 0xB7E15162
_OT_TWEAK3 = 0x8AED2A6B

# rows per extension slice: a multiple of 512 (one ChaCha block of every
# column stream), so each slice's streams start on a block boundary
EXT_ROWS = 1 << 24


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., m] -> int32[..., ceil(m/32)] little-endian bit packing."""
    m = bits.shape[-1]
    w = -(-m // 32)
    pad = torch.zeros(bits.shape[:-1] + (w * 32 - m,), dtype=torch.bool, device=bits.device)
    b = torch.cat([bits.to(torch.bool), pad], dim=-1).reshape(bits.shape[:-1] + (w, 32))
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    return prg.to_i32((b.to(torch.int64) << sh).sum(dim=-1))


def unpack_bits(words: torch.Tensor, m: int) -> torch.Tensor:
    """int32[..., w] -> bool[..., m] (inverse of :func:`pack_bits`)."""
    idx = torch.arange(m, device=words.device)
    return ((words[..., idx // 32] >> (idx % 32).to(torch.int32)) & 1).to(torch.bool)


def _transpose_pack(cols: torch.Tensor, m: int) -> torch.Tensor:
    """Column-major bit matrix int32[128, w] (bit j of cols[i] = entry
    (row j, column i)) -> packed rows int32[m, 4], by the packed 32x32
    butterfly (Hacker's Delight 7-3, little-endian).  The arithmetic
    ``a0 >> j`` is safe: each stage's mask clears the top j bits it fills."""
    w = cols.shape[1]
    x = cols.reshape(4, 32, w)
    for j, msk in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                   (2, 0x33333333), (1, 0x55555555)):
        x = x.reshape(4, 32 // (2 * j), 2, j, w)
        a0, a1 = x[:, :, 0], x[:, :, 1]
        t = ((a0 >> j) ^ a1) & msk
        x = torch.stack([a0 ^ (t << j), a1 ^ t], dim=2).reshape(4, 32, w)
    return x.permute(2, 1, 0).reshape(w * 32, 4)[:m]


def _col_words(seeds: torch.Tensor, w: int, offset: int) -> torch.Tensor:
    """Per-column PRG streams: int32[128, 4] seeds -> int32[128, w]."""
    return prg.stream_words(seeds, w, offset)


def _receiver_extend_core(seeds0, seeds1, choices, offset, m):
    w = -(-m // 32)
    t = _col_words(seeds0, w, offset)
    u = t ^ _col_words(seeds1, w, offset) ^ pack_bits(choices)[None, :]
    return u, _transpose_pack(t, m)


def _sender_extend_core(seeds, s_bits, u, offset, m):
    w = -(-m // 32)
    q = _col_words(seeds, w, offset) ^ torch.where(s_bits[:, None], u, 0)
    return _transpose_pack(q, m)


def sender_extend_rows(seeds, s_bits, u_cols, base_off: int, row0: int, m: int):
    """Q rows [row0, row0 + m) of a whole extension: ``u_cols`` is the
    column-word slice ``u[:, row0//32 : row0//32 + ceil(m/32)]`` and
    ``base_off`` the session's pre-batch stream offset in blocks.
    ``row0`` is a multiple of 512."""
    return _sender_extend_core(seeds, s_bits, u_cols, base_off + row0 // 512, m)


def receiver_extend_rows(seeds0, seeds1, choices, base_off: int, row0: int, m: int):
    """(u column-word slice, T rows) for rows [row0, row0 + m); ``choices``
    are those rows' m choice bits."""
    return _receiver_extend_core(seeds0, seeds1, choices, base_off + row0 // 512, m)


def ot_hash(rows: torch.Tensor, n_words: int, idx_offset: int = 0,
            domain: int = 0) -> torch.Tensor:
    """Correlation-robust hash of 128-bit rows int32[..., m, 4] ->
    int32[..., m, n_words] pads.  Row j's tweak is (idx_offset + j mod 2^32,
    TWEAK1 ^ domain, TWEAK2, TWEAK3), XORed in before the fixed-key ChaCha."""
    m = rows.shape[-2]
    r = prg.to_u64(rows)
    idx = (torch.arange(m, dtype=torch.int64, device=rows.device) + idx_offset) & M32
    blk = [r[..., 0] ^ idx, r[..., 1] ^ (_OT_TWEAK1 ^ domain),
           r[..., 2] ^ _OT_TWEAK2, r[..., 3] ^ _OT_TWEAK3]
    out = prg.chacha_words(blk)[:n_words]
    return prg.to_i32(torch.stack(out, dim=-1))


def gf128_double(x: torch.Tensor) -> torch.Tensor:
    """Multiply int32[..., 4] blocks by x in GF(2^128) (x^128 + x^7 + x^2 +
    x + 1): one shift with carry across the words and a conditional XOR of
    0x87 (``otext.gf128_double`` of the JAX package)."""
    top = (x >> 31) & 1  # each word's outgoing bit
    shifted = (x << 1) | torch.cat([torch.zeros_like(x[..., :1]), top[..., :3]], dim=-1)
    return torch.cat([shifted[..., :1] ^ (top[..., 3:] * 0x87), shifted[..., 1:]], dim=-1)


def gf128_comb(rows: torch.Tensor) -> torch.Tensor:
    """int32[..., S, 4] -> ``⊕_j x^j · rows[..., j, :]`` (Horner)."""
    S = rows.shape[-2]
    acc = rows[..., S - 1, :]
    for j in range(S - 2, -1, -1):
        acc = gf128_double(acc) ^ rows[..., j, :]
    return acc


def gf128_offsets(s_block: torch.Tensor, S: int) -> torch.Tensor:
    """int32[2^S, 4] — ``o_c = ⊕_j c_j · x^j · s`` for every c < 2^S."""
    pows = [s_block]
    for _ in range(S - 1):
        pows.append(gf128_double(pows[-1]))
    c = torch.arange(1 << S, device=s_block.device)
    offs = torch.zeros((1 << S, 4), dtype=torch.int32, device=s_block.device)
    for j in range(S):
        pick = ((c >> j) & 1).to(torch.bool)[:, None]
        offs = offs ^ torch.where(pick, pows[j][None, :], 0)
    return offs


def _stream_blocks(m: int) -> int:
    """ChaCha blocks an m-row extension takes from each column stream."""
    w = -(-m // 32)
    return -(-w // 16)


def s_to_block(s_bits: np.ndarray) -> np.ndarray:
    """bool[128] -> uint32[4] — the sender's ``s`` as a label-sized block."""
    return np.packbits(np.asarray(s_bits, bool), bitorder="little").view("<u4").copy()


class OtExtSender:
    """Extension sender: holds ``s`` (lsb forced to 1, so ``s`` doubles as
    the free-XOR offset R) and the base seeds chosen by ``s``."""

    def __init__(self, s_bits: np.ndarray, seeds: np.ndarray, device="cpu"):
        s_bits = np.asarray(s_bits, bool)
        if s_bits.shape != (KAPPA,) or not s_bits[0]:
            raise ValueError("need 128 choice bits with lsb(s) = 1")
        if np.shape(seeds) != (KAPPA, 4):
            raise ValueError(f"need uint32[128, 4] base seeds, got {np.shape(seeds)}")
        dev = torch.device(device)
        self.s_bits = s_bits
        self.s_block = s_to_block(s_bits)  # uint32[4]
        self._seeds = words_from_numpy(seeds, dev)
        self._s_dev = torch.from_numpy(s_bits.copy()).to(dev)
        self._off = 0
        self._sent = 0

    @property
    def consumed(self) -> int:
        """Total OTs extended so far: the pad-index base of the next batch."""
        return self._sent

    @property
    def stream_offset(self) -> int:
        """Per-column stream position in ChaCha blocks."""
        return self._off

    def advance(self, m: int) -> None:
        self._off += _stream_blocks(m)
        self._sent += m

    def extend(self, m: int, u_msg: torch.Tensor) -> torch.Tensor:
        """Peer's u-matrix int32[128, ceil(m/32)] -> Q rows int32[m, 4]."""
        if tuple(u_msg.shape) != (KAPPA, -(-m // 32)):
            raise ValueError(f"u message shaped {tuple(u_msg.shape)} for {m} OTs")
        q = torch.empty((m, 4), dtype=torch.int32, device=u_msg.device)
        for r0 in range(0, m, EXT_ROWS):
            mc = min(EXT_ROWS, m - r0)
            cols = u_msg[:, r0 // 32: r0 // 32 + -(-mc // 32)]
            q[r0:r0 + mc] = sender_extend_rows(self._seeds, self._s_dev, cols,
                                               self._off, r0, mc)
        self.advance(m)
        return q


class OtExtReceiver:
    """Extension receiver: holds both base-seed columns, produces the u
    message and its T rows per batch."""

    def __init__(self, seeds0: np.ndarray, seeds1: np.ndarray, device="cpu"):
        if np.shape(seeds0) != (KAPPA, 4) or np.shape(seeds1) != (KAPPA, 4):
            raise ValueError("need two uint32[128, 4] base-seed columns")
        dev = torch.device(device)
        self._seeds0 = words_from_numpy(seeds0, dev)
        self._seeds1 = words_from_numpy(seeds1, dev)
        self._off = 0
        self._recv = 0

    @property
    def consumed(self) -> int:
        return self._recv

    @property
    def stream_offset(self) -> int:
        return self._off

    def advance(self, m: int) -> None:
        self._off += _stream_blocks(m)
        self._recv += m

    def extend(self, choices: torch.Tensor):
        """choices bool[m] -> (u message int32[128, ceil(m/32)], T rows
        int32[m, 4]); T_j is the Δ-OT label for choice r_j."""
        m = choices.shape[0]
        dev = choices.device
        u = torch.empty((KAPPA, -(-m // 32)), dtype=torch.int32, device=dev)
        t = torch.empty((m, 4), dtype=torch.int32, device=dev)
        for r0 in range(0, m, EXT_ROWS):
            mc = min(EXT_ROWS, m - r0)
            uc, t[r0:r0 + mc] = receiver_extend_rows(
                self._seeds0, self._seeds1, choices[r0:r0 + mc], self._off, r0, mc)
            u[:, r0 // 32: r0 // 32 + uc.shape[1]] = uc
        self.advance(m)
        return u, t


def fresh_s_bits(rng=None) -> np.ndarray:
    """Random sender choice vector with lsb forced to 1 (free-XOR ready)."""
    rand = rng or secrets.SystemRandom()
    bits = np.array([bool(rand.getrandbits(1)) for _ in range(KAPPA)])
    bits[0] = True
    return bits


def inprocess_pair(device="cpu", rng=None):
    """Base-OT setup in process (colocated servers): a fresh ``s`` and one
    Chou-Orlandi exchange -> (OtExtSender, OtExtReceiver)."""
    s_bits = fresh_s_bits(rng)
    seeds0, seeds1, chosen = baseot.exchange(s_bits, rng)
    return OtExtSender(s_bits, chosen, device), OtExtReceiver(seeds0, seeds1, device)
