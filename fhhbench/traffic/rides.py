"""Synthetic Austin pickups (the RideAustin CSV is not in the repository),
frozen here so that a change to the program's samplers does not move the
yardstick.

``hotspots`` centres within ±60 centidegrees of downtown Austin (30.26,
-97.74), drawn once from the configuration's ``hotspot_seed`` (a city's
pickup spots do not move between collections, and fixed centres give every
run's seed the same frontier sizes), each client at a centre drawn from the
run's seed plus a rounded normal offset of one centidegree per axis; coordinates are i16
centidegrees, encoded as 16-bit MSB-first offset binary (sign bit flipped,
ref: sample_driving_data.rs), so that balls crossing zero stay contiguous.
"""

from __future__ import annotations

import numpy as np

DOWNTOWN = (3026, -9774)  # centidegrees


def sample(cfg: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """bool[n, 2, 16] client points."""
    if (cfg["n_dims"], cfg["data_len"]) != (2, 16):
        raise ValueError("rides points are i16 lat/lon: n_dims 2, data_len 16")
    spots = np.random.default_rng(cfg["hotspot_seed"])
    hot = np.array(DOWNTOWN) + spots.integers(-60, 60, size=(cfg["hotspots"], 2))
    idx = rng.integers(0, cfg["hotspots"], size=n)
    pts = hot[idx] + rng.normal(0, 1.0, size=(n, 2)).round().astype(np.int64)
    v = (np.clip(pts, -32768, 32767) & 0xFFFF) ^ 0x8000
    return ((v[..., None] >> np.arange(15, -1, -1)) & 1).astype(bool)
