"""The comparison that decides ``correct``: each collection's hitters and
counts against the plain reference over the same points.  The protocol is
exact, so every limit is 0."""

from __future__ import annotations

import numpy as np

LIMITS = {
    "hitter_mismatch": 0,  # hitters in one answer and not the other, worst collection
    "count_gap": 0,  # largest |count - reference count| over shared hitters
    "empty_reference": 0,  # point sets whose reference has no hitter: nothing to judge
    "failed": 0,  # collections that raised, or read other than the reference
}


def _table(paths: np.ndarray, counts: np.ndarray) -> dict:
    H = paths.shape[0]
    rows = np.packbits(paths.reshape(H, int(np.prod(paths.shape[1:]))), axis=-1)
    return {r.tobytes(): int(c) for r, c in zip(rows, counts)}


def compare(paths, counts, ref) -> tuple[int, int]:
    """(hitters in one answer only, largest count gap over shared hitters)."""
    got, want = _table(paths, counts), _table(ref.paths, ref.counts)
    gap = max((abs(got[k] - want[k]) for k in got.keys() & want.keys()), default=0)
    return len(got.keys() ^ want.keys()), gap


def judge(collections: list, refs: dict) -> dict:
    """The numbers compared, each {"value", "limit"}, over ``collections``
    (each with ``paths``, ``counts``, ``point_set``, ``error``) and the
    reference of each point set."""
    worst = {k: 0 for k in LIMITS}
    worst["empty_reference"] = sum(1 for r in refs.values() if r.paths.shape[0] == 0)
    for c in collections:
        if c.error is not None:
            worst["failed"] += 1
            continue
        miss, gap = compare(c.paths, c.counts, refs[c.point_set])
        worst["hitter_mismatch"] = max(worst["hitter_mismatch"], miss)
        worst["count_gap"] = max(worst["count_gap"], gap)
        worst["failed"] += int(miss > 0 or gap > 0)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in worst.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
