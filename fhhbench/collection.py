"""One collection, the entry the window drives: what
``fuzzyheavyhitters_torch.bin.mesh.run`` does on one card after sampling.

1. keygen for the clients' points (``ops.ibdcf.gen_l_inf_ball``) from a
   generator drawn from (seed, collection index);
2. ``protocol.driver.make_servers``;
3. on a secure cell, a fresh base-OT session pair
   (``driver.make_sessions(driver.session_material(<seeded Random>))``),
   so that OT indices never approach 2^32 within a run;
4. ``driver.Leader(...).run(nreqs, threshold)``;
5. synchronise.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

from fhhbench.traffic.generate import seed_sequence


@dataclass
class Collection:
    index: int
    point_set: int
    clients: int
    seconds: float = 0.0  # host clock, steps 1-5
    base_ot_s: float | None = None  # host clock, step 3
    phases: dict = field(default_factory=dict)  # Leader.timings, summed over levels
    paths: np.ndarray | None = None  # bool[H, d, L]
    counts: np.ndarray | None = None  # int64[H]
    error: str | None = None


def collect(cfg: dict, mix: dict, points: np.ndarray, point_set: int, seed: int,
            index: int, dev) -> Collection:
    """Run collection ``index`` of a run over ``points``."""
    import torch
    from torch.profiler import record_function

    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver

    out = Collection(index=index, point_set=point_set, clients=points.shape[0])
    t0 = time.perf_counter()
    with record_function("fhhbench.keygen"):
        rng = np.random.default_rng(seed_sequence(seed, 1, index))
        k0, k1 = ibdcf.gen_l_inf_ball(points, cfg["ball_size"], rng, device=dev)
        s0, s1 = driver.make_servers(k0, k1)
        del k0, k1
    sessions = None
    if mix["secure_exchange"]:
        with record_function("fhhbench.base_ot"):
            t = time.perf_counter()
            material = driver.session_material(random.Random(f"fhhbench/{seed}/{index}"))
            sessions = driver.make_sessions(material, dev)
            out.base_ot_s = time.perf_counter() - t
    with record_function("fhhbench.crawl"):
        lead = driver.Leader(s0, s1, n_dims=cfg["n_dims"], data_len=cfg["data_len"],
                             f_max=cfg["f_max"], secure=sessions, ot_path=mix["ot_path"])
        res = lead.run(nreqs=points.shape[0], threshold=cfg["threshold"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out.seconds = time.perf_counter() - t0
    out.phases = {k: float(sum(v)) for k, v in lead.timings.items()}
    out.paths, out.counts = np.asarray(res.paths, bool), np.asarray(res.counts, np.int64)
    return out
