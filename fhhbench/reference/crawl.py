"""Heavy hitters of L∞ balls, walked over the prefix tree in NumPy.

The semantics are the reference leader's (leader.rs:185-297) over the
ibDCF comparison (ibDCF.rs:175-188), stated on plain integers:

- client i at point v_i (per dimension an L-bit MSB-first string) covers
  the box [lo_i, hi_i], lo = max(0, v - ball), hi = min(2^L - 1, v + ball)
  per dimension;
- at level l the child c of node p (per dimension one more bit, bit j of
  c for dimension j) counts every client whose box meets the child's
  subtree: lo_i[:l+1] <= child <= hi_i[:l+1] as integers in every
  dimension;
- children with count >= max(1, floor(threshold * N)) survive, in
  (node, pattern) order; more than ``f_max`` survivors is an error;
- the hitters are the last level's survivors, with their counts.

The walk keeps one row per (distinct box, node it meets) with two flags per
dimension, "the node's prefix is above lo's" and "below hi's"; a child's
membership and flags follow from its parent's flags and one bit of lo and
hi.  Boxes of equal points are walked once, weighted by how many clients
hold them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Hitters:
    paths: np.ndarray  # bool[H, d, L] per-dimension MSB-first leaves
    counts: np.ndarray  # int64[H]


def ball_bounds(points: np.ndarray, ball_size: int) -> tuple[np.ndarray, np.ndarray]:
    """bool[U, d, L] points -> (lo, hi) bool[U, d, L]: each coordinate
    ∓ ``ball_size``, saturated at 0 and 2^L - 1, in Python integers."""
    U, d, L = points.shape
    top = (1 << L) - 1
    width = (L + 7) // 8
    pad = 8 * width - L
    rows = np.packbits(points.reshape(U * d, L), axis=-1)
    lo, hi = [], []
    for row in rows:
        v = int.from_bytes(row.tobytes(), "big") >> pad
        lo.append((max(0, v - ball_size) << pad).to_bytes(width, "big"))
        hi.append((min(top, v + ball_size) << pad).to_bytes(width, "big"))

    def unpack(parts):
        by = np.frombuffer(b"".join(parts), np.uint8).reshape(U * d, width)
        return np.unpackbits(by, axis=-1)[:, :L].astype(bool).reshape(U, d, L)

    return unpack(lo), unpack(hi)


def heavy_hitters(points: np.ndarray, ball_size: int, threshold: float, f_max: int,
                  weights: np.ndarray | None = None) -> Hitters:
    """The hitters of clients at ``points`` (bool[N, d, L]).  ``weights``
    (int64[N], default ones) counts each row as that many clients; the
    threshold is taken of their sum."""
    points = np.asarray(points, bool)
    N, d, L = points.shape
    w = np.ones(N, np.int64) if weights is None else np.asarray(weights, np.int64)
    pts, inverse = np.unique(np.packbits(points.reshape(N, d * L), axis=-1), axis=0,
                             return_inverse=True)
    box_w = np.bincount(inverse.reshape(-1), weights=w, minlength=pts.shape[0]).astype(np.int64)
    pts = np.unpackbits(pts, axis=-1)[:, :d * L].astype(bool).reshape(-1, d, L)
    lo, hi = ball_bounds(pts, ball_size)
    lo_lv = np.ascontiguousarray(lo.transpose(2, 1, 0))  # [L, d, U]
    hi_lv = np.ascontiguousarray(hi.transpose(2, 1, 0))
    thresh = max(1, int(threshold * int(w.sum())))
    C = 1 << d

    box = np.flatnonzero(box_w)  # one row per (box, node): all boxes meet the root
    node = np.zeros(box.shape[0], np.int64)
    above = np.zeros((d, box.shape[0]), bool)  # node prefix > lo's prefix
    below = np.zeros((d, box.shape[0]), bool)  # node prefix < hi's prefix
    paths = np.zeros((1, d, 0), bool)
    n_nodes = 1
    counts = np.zeros(0, np.int64)
    for level in range(L):
        lo_b, hi_b = lo_lv[level][:, box], hi_lv[level][:, box]  # [d, P]
        member, flags = [], []
        for c in range(C):
            ok = np.ones(box.shape[0], bool)
            ab, bl = above.copy(), below.copy()
            for j in range(d):
                if (c >> j) & 1:  # child bit 1: needs 1 <= hi's bit unless below
                    ok &= below[j] | hi_b[j]
                    ab[j] |= ~lo_b[j]
                else:  # child bit 0: needs lo's bit <= 0 unless above
                    ok &= above[j] | ~lo_b[j]
                    bl[j] |= hi_b[j]
            member.append(ok)
            flags.append((ab, bl))
        key = np.concatenate([node[m] * C + c for c, m in enumerate(member)])
        wts = np.concatenate([box_w[box[m]] for m in member])
        tally = np.bincount(key, weights=wts, minlength=n_nodes * C).astype(np.int64)
        tally = tally.reshape(n_nodes, C)
        parent, pattern = np.nonzero(tally >= thresh)
        if parent.shape[0] > f_max:
            raise ValueError(f"{parent.shape[0]} surviving nodes exceed f_max={f_max}")
        counts = tally[parent, pattern]
        bits = ((pattern[:, None] >> np.arange(d)[None]) & 1).astype(bool)  # [F', d]
        paths = np.concatenate([paths[parent], bits[:, :, None]], axis=-1)
        if parent.shape[0] == 0 or level == L - 1:
            break
        new_id = np.full(n_nodes * C, -1, np.int64)
        new_id[parent * C + pattern] = np.arange(parent.shape[0])
        parts = []
        for c, m in enumerate(member):
            nid = new_id[node * C + c]
            keep = m & (nid >= 0)
            parts.append((box[keep], nid[keep], flags[c][0][:, keep], flags[c][1][:, keep]))
        box = np.concatenate([p[0] for p in parts])
        node = np.concatenate([p[1] for p in parts])
        above = np.concatenate([p[2] for p in parts], axis=1)
        below = np.concatenate([p[3] for p in parts], axis=1)
        n_nodes = parent.shape[0]
    return Hitters(paths=paths, counts=counts)
