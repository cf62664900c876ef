"""Prime fields of the secure exchange, as plain PyTorch (the port's copy).

The surface of ``fuzzyheavyhitters_tpu/ops/fields.py`` that the secure
crawl uses, bit for bit:

- ``FE62``: p = 2^62 - 2^30 - 1 on ``int64`` tensors holding the JAX
  package's ``uint64`` bit patterns, with its lazy bit-reduction
  representation (ref: src/fastfield.rs:24-107);
- ``F255``: p = 2^255 - 19 on ``int32[..., 8]`` little-endian limb tensors
  (uint32 bit patterns), kept canonical (ref: src/field.rs:19).

Every right shift the JAX package applies to ``uint32``/``uint64`` is a
logical shift; on int32/int64 PyTorch shifts arithmetically, so each one
here is masked (``_shr``).  Adds and products wrap mod 2^64 exactly as the
unsigned ones do.  Both classes take the device of their tensor inputs;
``from_int`` and ``zeros`` take a ``device``.  The ``np_*`` methods are
their NumPy twins on the wire forms (FE62 ``uint64``, F255 ``uint32[..., 8]``)
for the little host-side arithmetic of the socket deployment: the trusted
exchange's masks and the leader's reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M62 = (1 << 62) - 1
_P62 = (1 << 62) - (1 << 30) - 1


def _shr(v: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (the uint64 ``>>``)."""
    return (v >> k) & ((1 << (64 - k)) - 1)


def _u64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _M32


def _i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with the bit pattern of their low 32 bits."""
    return (((values & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


class FE62:
    """p = 2^62 - 2^30 - 1 over int64 bit patterns, lazily reduced."""

    P = _P62
    limb_shape = ()

    @staticmethod
    def _bit_reduce(v):
        # 2^62 === 2^30 + 1 (mod p)   (fastfield.rs:86-95)
        excess = _shr(v, 62)
        return (v & _M62) + excess + (excess << 30)

    @classmethod
    def new(cls, v):
        return cls._bit_reduce(v)

    @classmethod
    def zeros(cls, shape, device=None):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    @classmethod
    def from_int(cls, x: int, device=None):
        return torch.tensor(x % cls.P, dtype=torch.int64, device=device)

    @classmethod
    def canon(cls, v):
        """Fully reduced value in [0, p) (fastfield.rs:100-107, 147-152)."""
        v = cls._bit_reduce(cls._bit_reduce(v))
        return torch.where(v >= cls.P, v - cls.P, v)

    @classmethod
    def add(cls, a, b):
        return cls._bit_reduce(a + b)

    @classmethod
    def neg(cls, a):
        return cls._bit_reduce(2 * cls.P - a)

    @classmethod
    def sub(cls, a, b):
        return cls.add(a, cls.neg(b))

    @classmethod
    def mul(cls, a, b):
        """Full 124-bit product reduced mod p, 64-bit ops only."""
        a = cls._bit_reduce(cls._bit_reduce(a))  # < 2^62
        b = cls._bit_reduce(cls._bit_reduce(b))
        a0, a1 = a & _M32, a >> 32  # a1 < 2^30
        b0, b1 = b & _M32, b >> 32
        t0 = a0 * b0  # may pass 2^63: wraps like the uint64 product
        t1 = a0 * b1 + a1 * b0
        t2 = a1 * b1
        t1 = t1 + _shr(t0, 32)
        c0 = t0 & _M32
        t2 = t2 + _shr(t1, 32)
        c1 = t1 & _M32
        # product = c0 + c1*2^32 + t2*2^64 ; split at bit 62
        low = ((c1 & 0x3FFFFFFF) << 32) | c0
        high = (t2 << 2) | (c1 >> 30)
        # product === low + high*(2^30 + 1) (mod p)
        h0, h1 = high & _M32, _shr(high, 32)
        r = cls._bit_reduce(low + high)
        r = cls._bit_reduce(r + (h0 << 30))
        r = cls._bit_reduce(r + (h1 << 30))
        return cls._bit_reduce(r + h1)

    @classmethod
    def to_blocks(cls, v):
        """[...] values -> int32[..., 4] little-endian blocks (canonical)."""
        v = cls.canon(v)
        lo, hi = _i32(v), _i32(v >> 32)
        z = torch.zeros_like(lo)
        return torch.stack([lo, hi, z, z], dim=-1)

    @classmethod
    def from_blocks(cls, blocks):
        """int32[..., 4] blocks -> field values (upper words folded mod p)."""
        w = _u64(blocks)
        lo = w[..., 0] | (w[..., 1] << 32)
        hi = w[..., 2] | (w[..., 3] << 32)
        two64 = cls.from_int((1 << 64) % cls.P, blocks.device)
        return cls.add(cls._bit_reduce(lo), cls.mul(cls.new(hi), two64))

    @classmethod
    def sample(cls, words):
        """uniform int32[..., 4] -> near-uniform field elements [...]."""
        w = _u64(words)
        lo = (w[..., 0] | (w[..., 1] << 32)) & _M62
        hi = w[..., 2] | (w[..., 3] << 32)
        h0, h1 = hi & _M32, _shr(hi, 32)
        r = cls._bit_reduce(lo + hi)
        r = cls._bit_reduce(r + (h0 << 30))
        r = cls._bit_reduce(r + (h1 << 30))
        return cls._bit_reduce(r + h1)

    @classmethod
    def sum(cls, v, *, dim):
        """Modular sum along ``dim`` for up to 2^31 terms: 32-bit halves
        summed exactly in int64, then recombined mod p."""
        v = cls._bit_reduce(cls._bit_reduce(v))  # < 2^62
        lo = (v & _M32).sum(dim=dim)
        hi = (v >> 32).sum(dim=dim)
        two32 = cls.from_int(1 << 32, v.device)
        return cls.add(cls._bit_reduce(lo), cls.mul(cls.new(hi), two32))

    @classmethod
    def to_numpy_ints(cls, v) -> np.ndarray:
        return cls.canon(v).cpu().numpy().astype(np.uint64)

    # -- NumPy twins (uint64 bit patterns, wrapping like the tensor ops): the
    # wire form of FE62 shares, for the trusted exchange's masks and the
    # leader's reconstruction on the host --------------------------------

    @staticmethod
    def _np_bit_reduce(v: np.ndarray) -> np.ndarray:
        excess = v >> np.uint64(62)
        return (v & np.uint64(_M62)) + excess + (excess << np.uint64(30))

    @classmethod
    def np_add(cls, a, b) -> np.ndarray:
        return cls._np_bit_reduce(np.asarray(a, np.uint64) + np.asarray(b, np.uint64))

    @classmethod
    def np_sub(cls, a, b) -> np.ndarray:
        with np.errstate(over="ignore"):
            neg = cls._np_bit_reduce(np.uint64(2 * cls.P) - np.asarray(b, np.uint64))
        return cls.np_add(a, neg)

    @classmethod
    def np_canon(cls, v) -> np.ndarray:
        v = cls._np_bit_reduce(cls._np_bit_reduce(np.asarray(v, np.uint64)))
        return np.where(v >= np.uint64(cls.P), v - np.uint64(cls.P), v)

    @classmethod
    def np_sample(cls, words) -> np.ndarray:
        """:meth:`sample` on uint32[..., 4] host words."""
        w = np.asarray(words, np.uint64)
        lo = (w[..., 0] | (w[..., 1] << np.uint64(32))) & np.uint64(_M62)
        hi = w[..., 2] | (w[..., 3] << np.uint64(32))
        h0, h1 = hi & np.uint64(_M32), hi >> np.uint64(32)
        r = cls._np_bit_reduce(lo + hi)
        r = cls._np_bit_reduce(r + (h0 << np.uint64(30)))
        r = cls._np_bit_reduce(r + (h1 << np.uint64(30)))
        return cls._np_bit_reduce(r + h1)


_P255 = (1 << 255) - 19
_P255_LIMBS = tuple((_P255 >> (32 * i)) & _M32 for i in range(8))


class F255:
    """p = 2^255 - 19 over int32[..., 8] little-endian limbs, canonical."""

    P = _P255
    limb_shape = (8,)

    @classmethod
    def zeros(cls, shape, device=None):
        return torch.zeros(tuple(shape) + (8,), dtype=torch.int32, device=device)

    @classmethod
    def from_int(cls, x: int, device=None):
        x %= cls.P
        limbs = [(x >> (32 * i)) & _M32 for i in range(8)]
        return _i32(torch.tensor(limbs, dtype=torch.int64, device=device))

    @staticmethod
    def _limbs(a) -> list:
        """int32[..., 8] -> 8 int64 tensors in [0, 2^32)."""
        a64 = _u64(a)
        return [a64[..., i] for i in range(8)]

    @staticmethod
    def _pack(limbs: list):
        return _i32(torch.stack(limbs, dim=-1))

    @staticmethod
    def _carry_chain(limbs: list):
        """8 int64 partial sums -> (8 limbs < 2^32, carry out)."""
        out, carry = [], torch.zeros_like(limbs[0])
        for s in limbs:
            s = s + carry
            out.append(s & _M32)
            carry = s >> 32
        return out, carry

    @staticmethod
    def _geq_p(limbs: list):
        ge = torch.ones_like(limbs[0], dtype=torch.bool)
        decided = torch.zeros_like(ge)
        for i in reversed(range(8)):
            gt = ~decided & (limbs[i] > _P255_LIMBS[i])
            lt = ~decided & (limbs[i] < _P255_LIMBS[i])
            ge = torch.where(lt, False, torch.where(gt, True, ge))
            decided = decided | gt | lt
        return ge

    @staticmethod
    def _sub_p_if(limbs: list, cond) -> list:
        """Conditionally subtract p (borrow chain)."""
        out, borrow = [], torch.zeros_like(limbs[0])
        for i in range(8):
            d = limbs[i] - _P255_LIMBS[i] - borrow
            out.append(torch.where(cond, d & _M32, limbs[i]))
            borrow = (d >> 63) & 1  # underflow sets the sign bit
        return out

    @classmethod
    def _settle(cls, limbs: list) -> list:
        return cls._sub_p_if(limbs, cls._geq_p(limbs))

    @classmethod
    def add(cls, a, b):
        la, lb = cls._limbs(a), cls._limbs(b)
        limbs, carry = cls._carry_chain([x + y for x, y in zip(la, lb)])
        # carry*2^256 === carry*38 (mod p); carry <= 1 so one more chain settles
        limbs = cls._carry_chain([limbs[0] + carry * 38] + limbs[1:])[0]
        return cls._pack(cls._settle(limbs))

    @classmethod
    def neg(cls, a):
        out, borrow = [], None
        for i, x in enumerate(cls._limbs(a)):
            d = _P255_LIMBS[i] - x - (0 if borrow is None else borrow)
            out.append(d & _M32)
            borrow = (d >> 63) & 1
        return cls._pack(cls._settle(out))  # p - 0 = p === 0

    @classmethod
    def sub(cls, a, b):
        return cls.add(a, cls.neg(b))

    @classmethod
    def canon(cls, a):
        return a

    @classmethod
    def sample(cls, words):
        """uniform int32[..., 8] -> field elements [..., 8]."""
        return cls._pack(cls._settle(cls._settle(cls._limbs(words))))

    @classmethod
    def to_blocks(cls, v):
        """[..., 8] limbs -> int32[..., 2, 4] block pairs (low block first)."""
        return v.reshape(v.shape[:-1] + (2, 4))

    @classmethod
    def from_blocks(cls, blocks):
        """int32[..., 2, 4] block pairs -> [..., 8] limbs (mod-p folded)."""
        return cls.sample(blocks.reshape(blocks.shape[:-2] + (8,)))

    @classmethod
    def sum(cls, v, *, dim):
        """Modular sum along ``dim`` (a batch dim, not the limb dim) for up
        to 2^31 canonical terms.  Each limb's column sums exactly in int64
        (< 2^63); one carry chain and the 2^256 === 38 fold then give the
        canonical value the JAX package's pairwise tree of additions gives."""
        dim = dim % (v.dim() - 1)
        cols = [c.sum(dim=dim) for c in cls._limbs(v)]
        limbs, carry = cls._carry_chain(cols)  # carry < 2^31
        for _ in range(2):  # the second fold cannot carry again
            limbs, carry = cls._carry_chain([limbs[0] + carry * 38] + limbs[1:])
        return cls._pack(cls._settle(cls._settle(limbs)))

    # -- NumPy twins on uint32[..., 8] limbs (the wire form of F255 shares)

    @staticmethod
    def _np_geq_p(limbs: np.ndarray) -> np.ndarray:
        ge = np.ones(limbs.shape[:-1], bool)
        decided = np.zeros(limbs.shape[:-1], bool)
        for i in reversed(range(8)):
            gt = ~decided & (limbs[..., i] > _P255_LIMBS[i])
            lt = ~decided & (limbs[..., i] < _P255_LIMBS[i])
            ge = np.where(lt, False, np.where(gt, True, ge))
            decided = decided | gt | lt
        return ge

    @staticmethod
    def _np_sub_p_if(limbs: np.ndarray, cond: np.ndarray) -> np.ndarray:
        out = np.empty(limbs.shape, np.uint32)
        borrow = np.zeros(limbs.shape[:-1], np.int64)
        for i in range(8):
            d = limbs[..., i].astype(np.int64) - _P255_LIMBS[i] - borrow
            out[..., i] = d & _M32
            borrow = (d < 0).astype(np.int64)
        return np.where(cond[..., None], out, limbs)

    @classmethod
    def _np_settle(cls, limbs: np.ndarray) -> np.ndarray:
        return cls._np_sub_p_if(limbs, cls._np_geq_p(limbs))

    @staticmethod
    def _np_carry_chain(cols: list):
        out, carry = [], np.zeros_like(cols[0])
        for c in cols:
            c = c + carry
            out.append(c & _M32)
            carry = c >> 32
        return out, carry

    @classmethod
    def np_add(cls, a, b) -> np.ndarray:
        a, b = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
        cols = [a[..., i].astype(np.int64) + b[..., i] for i in range(8)]
        limbs, carry = cls._np_carry_chain(cols)
        limbs = cls._np_carry_chain([limbs[0] + carry * 38] + limbs[1:])[0]
        return cls._np_settle(np.stack(limbs, axis=-1).astype(np.uint32))

    @classmethod
    def np_neg(cls, a) -> np.ndarray:
        a = np.asarray(a, np.uint32)
        out, borrow = [], 0
        for i in range(8):
            d = _P255_LIMBS[i] - a[..., i].astype(np.int64) - borrow
            out.append(d & _M32)
            borrow = (d < 0).astype(np.int64)
        return cls._np_settle(np.stack(out, axis=-1).astype(np.uint32))  # p - 0 = p === 0

    @classmethod
    def np_sub(cls, a, b) -> np.ndarray:
        return cls.np_add(a, cls.np_neg(b))

    @classmethod
    def np_sample(cls, words) -> np.ndarray:
        """:meth:`sample` on uint32[..., 8] host words."""
        return cls._np_settle(cls._np_settle(np.asarray(words, np.uint32)))

    @classmethod
    def to_numpy_ints(cls, v) -> np.ndarray:
        limbs = v.cpu().numpy().view(np.uint32).astype(object)
        flat = limbs.reshape(-1, 8)
        out = np.array([sum(int(r[i]) << (32 * i) for i in range(8)) for r in flat],
                       dtype=object)
        return out.reshape(limbs.shape[:-1])
