"""The one generator: a configuration and a traffic mix -> the points of
each point set, drawn from the run's seed."""

from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 64) - 1


def seed_sequence(seed: int, *key: int) -> np.random.SeedSequence:
    """The stream ``key`` of a run's seed (any whole number)."""
    return np.random.SeedSequence(seed & SEED_MASK, spawn_key=key)


def point_sets(sampler, cfg: dict, mix: dict, seed: int) -> list:
    """``mix["point_sets"]`` arrays bool[clients, n_dims, data_len], set k
    from stream (0, k) of ``seed``, by ``sampler`` (the module of the
    configuration's ``distribution``)."""
    return [sampler.sample(cfg, mix["clients"], np.random.default_rng(seed_sequence(seed, 0, k)))
            for k in range(mix["point_sets"])]
