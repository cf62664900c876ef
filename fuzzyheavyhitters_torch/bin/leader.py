"""Leader binary: client simulation and the protocol driver (the port of
``fuzzyheavyhitters_tpu/bin/leader.py``, ref: src/bin/leader.rs)::

    python -m fuzzyheavyhitters_torch.bin.leader --config configs/config.json -n 1000

Start both ``bin.server`` processes first.  Flow (leader.rs:300-440): keygen
report, client sampling, keygen, connect, ``reset``, batched key upload,
the warmup (``FHH_WARMUP=0`` skips it, as in the JAX leader), the crawl in
rounds of ``crawl_radix_bits`` levels (``crawl.done``), one ``hitter``
line per heavy hitter and, for the rides workload, the heavy-hitter CSV
(``data/ride_heavy_hitters.csv`` under the working directory).  Events are
JSON lines on standard output.

The environment means what it means to the JAX leader, defaults included.
Unset or ``"1"``, ``FHH_SUPERVISE`` runs the supervised crawl
(``RpcLeader.run_supervised``): both servers checkpoint every
``FHH_CKPT_EVERY`` levels (default 16; the servers need ``FHH_CKPT_DIR``,
and without it the crawl goes on with no checkpoint), and a transport
loss or a server restart rolls both back and re-runs only the lost rounds
(``resilience.recover``, ``resilience.restored``).  Its ``crawl.done``
times reset, upload, warmup and rounds together, as the JAX leader's
does, and carries each part (``seconds_by_part``) and the recovery
counters.  ``FHH_SUPERVISE=0`` runs the unsupervised crawl: its upload
and warmup print ``addkeys.done`` and ``warmup.done``, and its
``crawl.done`` times the rounds alone.  Either carries each client's
reconnect ``epoch``.  Streaming windows (``FHH_WINDOWS`` > 1) and named
collections (``FHH_COLLECTION``) are not ported; a variable that asks for
one is refused by name.  Keygen runs on ``cuda`` unless
``--device`` names another device or the config says ``"backend": "cpu"``.
With ``--seed s`` sampling and keygen draw from ``default_rng(s)`` in
``bin.mesh``'s order, so the keys, and the hitters, equal ``bin.mesh``'s
for the same config, seed and N; the keygen report draws from a generator
of its own.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import time

import numpy as np
import torch

from ..ops import ibdcf
from ..protocol.leader_rpc import RpcLeader
from ..protocol.rpc import CollectorClient
from ..utils import config as configmod
from ..utils import resolve_device
from ..workloads import OUTPUT_CSV, rides, sample_points, strings
from .server import emit, split_addr


def refuse_unported_env() -> None:
    """Refuse the JAX leader's variables, read with its defaults, when they
    ask for an unported mode."""
    asks = {
        "FHH_WINDOWS": (int(os.environ.get("FHH_WINDOWS", "1")) > 1,
                        os.environ.get("FHH_WINDOWS"), "streaming ingestion in tumbling windows"),
        "FHH_COLLECTION": (os.environ.get("FHH_COLLECTION", "default") not in ("", "default"),
                           os.environ.get("FHH_COLLECTION"), "the multi-tenant collection layer"),
    }
    for var, (asked, val, path) in asks.items():
        if asked:
            raise NotImplementedError(
                f"{var}={val}: {path} is not ported to PyTorch yet; this leader crawls one "
                "collection from one bulk upload")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def keygen_report(cfg, rng, dev) -> None:
    """Key size and keygen throughput (ref: leader.rs:90-104, 319-329), after
    one untimed call."""
    n = min(cfg.num_sites, 1000)
    pts = np.stack([strings.generate_random_bit_vectors(rng, cfg.data_len, cfg.n_dims)
                    for _ in range(n)])
    ibdcf.gen_l_inf_ball(pts, 1, rng, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    k0, _ = ibdcf.gen_l_inf_ball(pts, 1, rng, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    emit("keygen.report", engine=ibdcf.best_engine(dev),
         key_bytes=sum(x[0].nbytes for x in ibdcf.keys_to_numpy(k0)), n_keys=n,
         seconds=round(dt, 3), sec_per_key=round(dt / n, 6))


def client_keys(cfg, nreqs: int, dev, seed):
    """Sampling and keygen from ``default_rng(seed)`` in ``bin.mesh``'s
    order -> (points, keys0, keys1, keygen seconds), the keys in wire form
    (``ibdcf.keys_to_numpy``)."""
    rng = np.random.default_rng(seed)
    pts = sample_points(cfg, nreqs, rng)
    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device=dev)
    keys0, keys1 = ibdcf.keys_to_numpy(k0), ibdcf.keys_to_numpy(k1)
    dt = time.perf_counter() - t0
    del k0, k1  # the servers hold the keys from here on: free the card
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return pts, keys0, keys1, dt


async def run(cfg, nreqs: int, dev, seed, warm_buckets=None) -> None:
    """The leader's flow (see the module docstring); ``warm_buckets`` names
    the warmup's buckets (None: :meth:`RpcLeader.warmup`'s ladder to
    ``f_max``)."""
    keygen_report(cfg, np.random.default_rng(), dev)
    emit("sampling", distribution=cfg.distribution, n=nreqs, device=str(dev))
    _, keys0, keys1, dt = client_keys(cfg, nreqs, dev, seed)
    emit("keygen", seconds=dt, n_keys=nreqs)
    warm = os.environ.get("FHH_WARMUP", "1") != "0"
    supervise = os.environ.get("FHH_SUPERVISE", "1") != "0"
    c0 = await CollectorClient.connect(*split_addr(cfg.server0))
    c1 = await CollectorClient.connect(*split_addr(cfg.server1))
    try:
        lead = RpcLeader(cfg, c0, c1, emit=emit)
        t0 = time.perf_counter()
        if supervise:  # the keys stay for a restarted server's re-upload
            res = await lead.run_supervised(
                nreqs, keys0, keys1, checkpoint_every=int(os.environ.get("FHH_CKPT_EVERY", "16")),
                warmup=warm, warm_buckets=warm_buckets)
            extra = {"seconds_by_part": lead.seconds, **lead.counters}
        else:
            await asyncio.gather(c0.call("reset"), c1.call("reset"))
            await lead.upload_keys(keys0, keys1)
            del keys0, keys1
            emit("addkeys.done", seconds=time.perf_counter() - t0)
            if warm:
                t0 = time.perf_counter()
                info = await lead.warmup(warm_buckets)
                emit("warmup.done", seconds=time.perf_counter() - t0,
                     f_buckets=info["f_buckets"],
                     shapes=[info["s0"]["shapes"], info["s1"]["shapes"]])
            t0 = time.perf_counter()
            res = await lead.run(nreqs)
            extra = {}
        emit("crawl.done", seconds=time.perf_counter() - t0, supervised=supervise,
             levels=cfg.data_len, radix=cfg.crawl_radix_bits, rounds=len(lead.buckets),
             hitters=int(res.paths.shape[0]), secure=cfg.secure_exchange,
             buckets=lead.buckets, pipeline=lead.pipeline, epochs=[c0.epoch, c1.epoch],
             control_bytes={"server0": c0.stats, "server1": c1.stats}, **extra)
    finally:
        await c0.aclose()
        await c1.aclose()
    for row, c in zip(res.decode_ints(), res.counts):
        emit("hitter", value=str(row.tolist()), count=int(c))
    if cfg.distribution == "rides" and res.paths.shape[0]:
        os.makedirs(os.path.dirname(OUTPUT_CSV), exist_ok=True)
        rides.save_heavy_hitters(res.paths, OUTPUT_CSV)
        emit("csv.written", path=OUTPUT_CSV, hitters=int(res.paths.shape[0]))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="Leader", description="Leader of the socket deployment (PyTorch/CUDA); runs "
        "the supervised crawl (checkpoints every FHH_CKPT_EVERY levels, default 16) unless "
        "FHH_SUPERVISE=0; FHH_WARMUP=0 skips the warmup; the FHH_WINDOWS and FHH_COLLECTION "
        "modes are not ported and are refused.")
    p.add_argument("-c", "--config", required=True, help="Location of JSON config file")
    p.add_argument("-n", "--num_requests", type=int, required=True,
                   help="Number of client requests")
    p.add_argument("--device", default=None,
                   help='keygen device (default "cuda", or "cpu" when the config says '
                        '"backend": "cpu")')
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the client sampling and keygen randomness")
    args = p.parse_args(argv)
    refuse_unported_env()
    cfg = configmod.load_config(args.config)
    dev = resolve_device(args.device or ("cpu" if cfg.backend == "cpu" else None))
    asyncio.run(run(cfg, args.num_requests, dev, args.seed))


if __name__ == "__main__":
    main()
