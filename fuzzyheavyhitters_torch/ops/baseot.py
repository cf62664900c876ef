"""Base oblivious transfers: Chou-Orlandi "simplest OT" over Ed25519.

The port's own copy of ``fuzzyheavyhitters_tpu/ops/baseot.py`` (pure
Python, no tensors): the ~128 base OTs per session are a one-time,
host-side setup whose seeds start the OT extension (``ops/otext.py``).
Same messages and seeds for the same randomness: ``rng`` is any object with
``randrange`` (``secrets.SystemRandom`` by default; a seeded
``random.Random`` in tests).

Protocol (Chou-Orlandi 2015, semi-honest use):

- sender:   a <- Z_L,  A = aB                         (publishes A)
- receiver: b_i <- Z_L, R_i = c_i*A + b_i*B           (publishes R_i)
- sender:   k0_i = H(a*R_i), k1_i = H(a*R_i - a*A)
- receiver: k(c_i) = H(b_i*A)

H = SHA-256 over the OT index and the compressed point, truncated to a
128-bit seed.  Curve arithmetic is textbook Ed25519 (twisted Edwards,
a = -1) in extended coordinates with Python ints, self-checked at import.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

import numpy as np

P = 2**255 - 19
L_ORDER = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P

# standard Ed25519 base point
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960


@dataclass(frozen=True)
class Point:
    """Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z."""

    x: int
    y: int
    z: int
    t: int


IDENTITY = Point(0, 1, 1, 0)
BASE = Point(_BX, _BY, 1, (_BX * _BY) % P)


def _add(p: Point, q: Point) -> Point:
    # add-2008-hwcd-3 for a = -1
    a = (p.y - p.x) * (q.y - q.x) % P
    b = (p.y + p.x) * (q.y + q.x) % P
    c = p.t * 2 * D * q.t % P
    d = p.z * 2 * q.z % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return Point(e * f % P, g * h % P, f * g % P, e * h % P)


def _neg(p: Point) -> Point:
    return Point((-p.x) % P, p.y, p.z, (-p.t) % P)


def _mul(k: int, p: Point) -> Point:
    q = IDENTITY
    while k:
        if k & 1:
            q = _add(q, p)
        p = _add(p, p)
        k >>= 1
    return q


def _affine(p: Point) -> tuple[int, int]:
    zi = pow(p.z, P - 2, P)
    return (p.x * zi) % P, (p.y * zi) % P


def _compress(p: Point) -> bytes:
    x, y = _affine(p)
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _self_check() -> None:
    x, y = _affine(BASE)
    assert (-x * x + y * y - 1 - D * x * x * y * y) % P == 0, "base point off-curve"
    assert _affine(_mul(L_ORDER, BASE)) == (0, 1), "base point order mismatch"


_self_check()


def _seed_from_point(p: Point, idx: int) -> np.ndarray:
    """H(index, point) -> 128-bit seed.  The OT index is part of the hash
    input (standard Chou-Orlandi domain separation) so identical points at
    different indices / instances cannot yield identical seeds."""
    data = b"fhh-baseot-v1" + idx.to_bytes(4, "little") + _compress(p)
    digest = hashlib.sha256(data).digest()[:16]
    return np.frombuffer(digest, dtype="<u4").copy()


# ---------------------------------------------------------------------------
# Message-passing API: each side advances with the peer's last message.
# (sender round 1) -> A -> (receiver round) -> [R_i] -> (sender round 2)
# ---------------------------------------------------------------------------


class BaseOtSender:
    """Holds the sender state across the two host round-trips."""

    def __init__(self, rng: secrets.SystemRandom | None = None):
        self._rand = rng or secrets.SystemRandom()
        self._a = self._rand.randrange(1, L_ORDER)
        self._A = _mul(self._a, BASE)

    def round1(self) -> bytes:
        return _compress(self._A)

    def seeds(self, r_points: list[Point]) -> tuple[np.ndarray, np.ndarray]:
        """[R_i] -> (seeds0 uint32[n, 4], seeds1 uint32[n, 4])."""
        neg_aA = _neg(_mul(self._a, self._A))
        k0, k1 = [], []
        for i, r in enumerate(r_points):
            ar = _mul(self._a, r)
            k0.append(_seed_from_point(ar, i))
            k1.append(_seed_from_point(_add(ar, neg_aA), i))
        return np.stack(k0), np.stack(k1)


def decompress(data: bytes) -> Point:
    """Decode a compressed point; raises ValueError on malformed peer input
    (never ``assert`` — a protocol-boundary check must survive ``-O``)."""
    raw = int.from_bytes(data, "little")
    y = raw & ((1 << 255) - 1)
    sign = raw >> 255
    if y >= P:
        raise ValueError("invalid point encoding: y out of range")
    # x^2 = (y^2 - 1) / (d y^2 + 1)
    num = (y * y - 1) % P
    den = (D * y * y + 1) % P
    x2 = num * pow(den, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        raise ValueError("invalid point encoding: not a square")
    if x == 0 and sign:
        raise ValueError("invalid point encoding: sign bit on x = 0")
    if x & 1 != sign:
        x = P - x
    return Point(x, y, 1, (x * y) % P)


class BaseOtReceiver:
    """Receiver with choice bits; produces R_i points and the chosen seeds."""

    def __init__(self, choices: np.ndarray, rng: secrets.SystemRandom | None = None):
        self._rand = rng or secrets.SystemRandom()
        self.choices = np.asarray(choices, bool)
        self._bs = [self._rand.randrange(1, L_ORDER) for _ in self.choices]

    def round1(self, sender_msg: bytes) -> list[bytes]:
        A = decompress(sender_msg)
        self._A = A
        out = []
        for c, b in zip(self.choices, self._bs):
            r = _mul(b, BASE)
            if c:
                r = _add(r, A)
            out.append(_compress(r))
        return out

    def seeds(self) -> np.ndarray:
        """uint32[n, 4] — seed k(c_i) for each choice."""
        return np.stack(
            [_seed_from_point(_mul(b, self._A), i) for i, b in enumerate(self._bs)]
        )


def exchange(
    choices: np.ndarray, rng=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run both sides in-process (colocated servers, tests).

    Returns (seeds0, seeds1, chosen) with chosen[i] == seeds{choices[i]}[i].
    ``rng`` draws the sender's scalar first, then the receiver's.
    """
    sender = BaseOtSender(rng)
    receiver = BaseOtReceiver(choices, rng)
    r_msgs = receiver.round1(sender.round1())
    s0, s1 = sender.seeds([decompress(m) for m in r_msgs])
    return s0, s1, receiver.seeds()
