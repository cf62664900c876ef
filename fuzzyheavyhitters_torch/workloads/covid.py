"""COVID-geo workload: county-centroid sampler with spatial jitter
(ref: src/sample_covid_data.rs).

The port's own copy of ``fuzzyheavyhitters_tpu/workloads/covid.py``.  The
reference streams a 9 GB case-surveillance CSV, maps each case's county
FIPS to a centroid, adds uniform jitter inside a km-side square, and emits
each coordinate as the 64 IEEE-754 bits of the f64, MSB-first
(``f64_to_bool_vec``, sample_covid_data.rs:32-35), so the tree domain of
this workload is the raw float bit pattern.  Without the case CSV,
counties are sampled uniformly from the shipped centroid file instead.

All draws come from the caller's ``rng`` (a ``numpy.random.Generator``, or
a seed for one), in the JAX package's order: the county choice, then per
client the latitude jitter and the longitude jitter.  So
``rng=np.random.default_rng(s)`` gives exactly the points of the JAX
package's ``sample_covid_locations(..., seed=s)``.  The per-client work is
vectorised; the jitter's half-widths are computed once per county by the
same scalar expressions as the JAX package's per-client loop.
"""

from __future__ import annotations

import csv
import os
import struct

import numpy as np

KM_PER_DEG_LAT = 111.32


def load_centroids(path: str) -> dict[str, tuple[float, float]]:
    """FIPS -> (lat, lon) from county_centroids.csv
    (ref: sample_covid_data.rs:17-30)."""
    out = {}
    # utf-8-sig: the shipped centroid CSV begins with a UTF-8 BOM
    with open(path, newline="", encoding="utf-8-sig") as f:
        for row in csv.DictReader(f):
            out[row["fips_code"]] = (float(row["latitude"]), float(row["longitude"]))
    return out


def f64_to_bool_vec(value: float) -> np.ndarray:
    """IEEE-754 bits of an f64, MSB-first (ref: sample_covid_data.rs:32-35)."""
    return _f64_bits(np.array([value], np.float64))[0]


def bool_vec_to_f64(bits) -> float:
    v = 0
    for b in np.asarray(bits, bool):
        v = (v << 1) | int(b)
    return struct.unpack(">d", struct.pack(">Q", v))[0]


def _f64_bits(values: np.ndarray) -> np.ndarray:
    """float64[...] -> bool[..., 64], each value's bit pattern MSB-first."""
    by = np.ascontiguousarray(values, ">f8").view(np.uint8)
    return np.unpackbits(by.reshape(values.shape + (8,)), axis=-1).astype(bool)


def _half_widths(lat: float, side_length_km: float) -> tuple[float, float]:
    """Half the side of a km square in degrees of latitude and longitude at
    this latitude (ref: sample_covid_data.rs:45-62)."""
    km_per_deg_lon = KM_PER_DEG_LAT * np.cos(np.radians(lat))
    return ((side_length_km / 2.0) / KM_PER_DEG_LAT,
            (side_length_km / 2.0) / km_per_deg_lon)


def uniform_in_square(
    lat: float, lon: float, side_length_km: float, rng: np.random.Generator
) -> tuple[float, float]:
    """Uniform jitter in a km-side square at this latitude
    (ref: sample_covid_data.rs:45-62)."""
    a_lat, a_lon = _half_widths(lat, side_length_km)
    return (
        float(np.clip(lat + rng.uniform(-a_lat, a_lat), -90.0, 90.0)),
        float(np.clip(lon + rng.uniform(-a_lon, a_lon), -180.0, 180.0)),
    )


def sample_covid_locations(
    covid_path: str,
    centroids_path: str,
    sample_size: int,
    fuzz_factor: float | None = None,
    rng: np.random.Generator | int | None = None,
    fips_column: int = 5,
) -> np.ndarray:
    """bool[sample_size, 2, 64] case locations (jittered when ``fuzz_factor``
    is a square's side in km) as f64 bit vectors
    (ref: sample_covid_data.rs:64-175).  When the case CSV is missing,
    counties are sampled uniformly from the centroid file instead."""
    rng = np.random.default_rng(rng)
    centroids = load_centroids(centroids_path)
    fips_list = sorted(centroids)
    if os.path.exists(covid_path):
        with open(covid_path, newline="") as f:
            reader = csv.reader(f)
            next(reader, None)
            rows = [row[fips_column].strip() for row in reader
                    if len(row) > fips_column and row[fips_column].strip() in centroids]
        if len(rows) < sample_size:
            raise ValueError(
                f"Need {sample_size} valid samples but only found {len(rows)}"
            )
        take = rng.choice(len(rows), size=sample_size, replace=False)
        slot = {fips: i for i, fips in enumerate(fips_list)}
        county = np.array([slot[rows[i]] for i in take], np.int64)
    else:
        county = rng.choice(len(fips_list), size=sample_size, replace=True)
    table = np.array([centroids[f] for f in fips_list], np.float64).reshape(-1, 2)
    coords = table[county]  # [n, (lat, lon)]
    if fuzz_factor is not None:
        used = np.unique(county)
        half = np.zeros_like(table)
        half[used] = [_half_widths(float(table[c, 0]), fuzz_factor) for c in used]
        a = half[county]
        # one draw per client and coordinate, lat then lon, in client order
        coords = coords + rng.uniform(-a, a)
        coords[:, 0] = np.clip(coords[:, 0], -90.0, 90.0)
        coords[:, 1] = np.clip(coords[:, 1], -180.0, 180.0)
    return _f64_bits(coords)
