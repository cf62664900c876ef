"""RideAustin geo workload: centidegree codecs, CSV sampler, output writer
(ref: src/sample_driving_data.rs).

The port's own copy of ``fuzzyheavyhitters_tpu/workloads/rides.py``.
Coordinates are centidegrees in i16 (2 decimal places ≈ 1.1 km); the
protocol-side bit encoding is offset-binary (sign bit flipped) so that
zero-crossing balls work.  The RideAustin CSV is not shipped; without it
the sampler draws the same synthetic Austin hotspots as the JAX package.
With the CSV present this copy samples with ``numpy`` only (the JAX package
prefers its native reservoir sampler there, so the two samples differ).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..utils import bits as bitutils

CENTIDEGREES_SCALE = 100.0


def geo_to_int(lat: float, lng: float) -> tuple[int, int]:
    """(ref: sample_driving_data.rs:11-15)"""
    return (
        int(np.clip(round(lat * CENTIDEGREES_SCALE), -32768, 32767)),
        int(np.clip(round(lng * CENTIDEGREES_SCALE), -32768, 32767)),
    )


def int_to_geo(lat_int: int, lng_int: int) -> tuple[float, float]:
    """(ref: sample_driving_data.rs:18-22)"""
    return lat_int / CENTIDEGREES_SCALE, lng_int / CENTIDEGREES_SCALE


def sample_start_locations(
    path: str, sample_size: int, seed: int | None = None
) -> np.ndarray:
    """int16[sample_size, 2] (lat, lon) centidegrees sampled uniformly
    without replacement from the RideAustin CSV — columns 14 (start lat)
    and 13 (start lon), as the reference indexes them
    (ref: sample_driving_data.rs:72-97)."""
    rng = np.random.default_rng(seed)
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader)  # header
        rows = [r for r in reader]
    take = rng.choice(len(rows), size=min(sample_size, len(rows)), replace=False)
    out = [geo_to_int(float(rows[i][14]), float(rows[i][13])) for i in take]
    return np.array(out, dtype=np.int16)


def synthetic_austin_locations(
    sample_size: int, seed: int | None = None, n_hotspots: int = 6
) -> np.ndarray:
    """Synthetic stand-in when the RideAustin CSV is absent: clustered
    pickups around downtown Austin (30.26, -97.74) in centidegrees, one
    centidegree of spread per hotspot."""
    rng = np.random.default_rng(seed)
    hot = np.array([3026, -9774]) + rng.integers(-60, 60, size=(n_hotspots, 2))
    idx = rng.integers(0, n_hotspots, size=sample_size)
    pts = hot[idx] + rng.normal(0, 1.0, size=(sample_size, 2)).round().astype(int)
    return np.clip(pts, -32768, 32767).astype(np.int16)


def load_or_synthesize_locations(
    path: str, sample_size: int, seed: int | None = None
) -> np.ndarray:
    if os.path.exists(path):
        return sample_start_locations(path, sample_size, seed)
    return synthetic_austin_locations(sample_size, seed)


def coords_to_ob_bits(coords: np.ndarray) -> np.ndarray:
    """int16[N, d] centidegrees -> bool[N, d, 16] MSB-first offset-binary
    bits: ``bits.i16_to_ob_bits`` applied to every coordinate at once."""
    v = (np.asarray(coords).astype(np.int64) & 0xFFFF) ^ 0x8000
    return ((v[..., None] >> np.arange(15, -1, -1)) & 1).astype(bool)


def paths_to_coords(paths: np.ndarray) -> np.ndarray:
    """bool[H, 2, 16] offset-binary tree paths -> int16[H, 2] centidegrees
    (the decode half of ref: sample_driving_data.rs:135-141)."""
    out = np.empty(paths.shape[:2], dtype=np.int16)
    for i in range(paths.shape[0]):
        for j in range(paths.shape[1]):
            out[i, j] = bitutils.ob_bits_to_i16(paths[i, j])
    return out


def save_heavy_hitters(paths: np.ndarray, output_path: str) -> None:
    """Append heavy hitters as (index, latitude, longitude) CSV rows,
    writing the header only when the file is empty
    (ref: sample_driving_data.rs:117-148)."""
    coords = paths_to_coords(paths)
    new = not os.path.exists(output_path) or os.path.getsize(output_path) == 0
    with open(output_path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["index", "latitude", "longitude"])
        for i, (lat_i, lon_i) in enumerate(coords):
            lat, lon = int_to_geo(int(lat_i), int(lon_i))
            w.writerow([i, lat, lon])
