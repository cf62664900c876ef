"""Client workloads (ref: leader.rs:332-388 distribution selection)."""

from __future__ import annotations

import numpy as np

RIDES_CSV = "data/RideAustin_Weather.csv"
COVID_CSV = "data/COVID-19_Case_Surveillance_Public_Use_Data_with_Geography_20250430.csv"
OUTPUT_CSV = "data/ride_heavy_hitters.csv"

AUG_LEN = 8  # zipf per-request augmentation bits (ref: leader.rs:331)


def sample_points(cfg, nreqs: int, rng: np.random.Generator) -> np.ndarray:
    """Distribution-selected client points -> bool[nreqs, n_dims, data_len]
    (ref: leader.rs:332, 372).  The rides flow is deterministic (internal
    seed 42, like the reference's seeded sampler); zipf draws from the
    caller's ``rng`` in the JAX package's order, so one seed gives the same
    points in both packages."""
    from . import rides, strings

    if cfg.distribution == "zipf":
        pts, _ = strings.zipf_workload(
            rng, cfg.num_sites, cfg.data_len, cfg.n_dims, cfg.zipf_exponent,
            nreqs, AUG_LEN,
        )
        return pts
    if cfg.distribution == "rides":
        if (cfg.data_len, cfg.n_dims) != (16, 2):
            raise ValueError("the rides flow is i16 lat/lon: data_len 16, n_dims 2")
        coords = rides.load_or_synthesize_locations(RIDES_CSV, nreqs, seed=42)
        return rides.coords_to_ob_bits(coords)
    if cfg.distribution == "covid":
        raise NotImplementedError(
            f"the covid workload is not ported yet: it needs {COVID_CSV}, "
            "which the repository does not ship"
        )
    raise ValueError(f"unknown distribution {cfg.distribution!r}")
