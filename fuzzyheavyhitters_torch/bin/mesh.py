"""Single-card entry point: the whole collection in one process on one device.

The port of ``fuzzyheavyhitters_tpu/bin/mesh.py`` for one card: sample the
clients, generate both parties' ibDCF keys, crawl the prefix tree with both
servers on the device, emit the heavy hitters, and for the rides workload
append them to the heavy-hitter CSV.  Events are JSON lines on standard
output.  With ``secure_exchange: true`` in the config the servers run the
secure exchange (``protocol/secure.py``) on two OT-extension sessions set up
by the Chou-Orlandi base OT from system randomness; otherwise the trusted
exchange.

::

    python -m fuzzyheavyhitters_torch.bin.mesh --config configs/config.json -n 1000
    python -m fuzzyheavyhitters_torch.bin.mesh --config configs/config.json -n 100 --device cpu

It runs on ``cuda`` unless ``--device`` names another device, and raises
when there is no card.  Like the JAX binary, whose ``MeshRunner`` has no
radix, it crawls one bit per level whatever ``crawl_radix_bits`` says:
fused rounds run in ``driver.Leader(radix=k)`` and the socket deployment,
and its ``crawl.done`` line counts the levels it crawled.  The
multi-process and multi-card options of the JAX binary are refused
(``NotImplementedError``): that path is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ibdcf
from ..protocol import driver
from ..utils import config as configmod
from ..utils import resolve_device
from ..workloads import OUTPUT_CSV, rides, sample_points


@dataclass
class MeshRun:
    points: np.ndarray  # bool[N, d, L] the sampled client points
    result: driver.CrawlResult
    leader: driver.Leader
    seconds: dict  # sampling / keygen / crawl wall seconds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: configmod.Config, n: int, device=None, seed: int | None = None,
        csv_path: str = OUTPUT_CSV, out=None, session: dict | None = None) -> MeshRun:
    """Sample ``n`` clients, keygen, crawl, emit; returns the points, the
    result and the leader (whose servers still hold the keys, and whose
    ``secure`` holds the OT sessions of a secure crawl).  ``session`` is the
    secure crawl's base-OT material (``driver.session_material``); None
    runs the base OT from system randomness."""
    out = sys.stdout if out is None else out
    dev = resolve_device(device)

    def emit(event: str, **kw):
        out.write(json.dumps({"event": event, **kw}) + "\n")

    rng = np.random.default_rng(seed)
    seconds = {}
    emit("sampling", distribution=cfg.distribution, n=n, device=str(dev))
    t0 = time.perf_counter()
    pts = sample_points(cfg, n, rng)
    seconds["sampling"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device=dev)
    _sync(dev)
    seconds["keygen"] = time.perf_counter() - t0
    emit("keygen.report", seconds=seconds["keygen"], n_keys=n,
         engine=ibdcf.best_engine(dev))

    s0, s1 = driver.make_servers(k0, k1)
    del k0, k1
    sessions = None
    if cfg.secure_exchange:
        t0 = time.perf_counter()
        sessions = driver.make_sessions(
            driver.session_material() if session is None else session, dev)
        seconds["base_ot"] = time.perf_counter() - t0
        emit("secure.session", seconds=seconds["base_ot"], ot_path=cfg.ot_path)
    lead = driver.Leader(s0, s1, n_dims=cfg.n_dims, data_len=cfg.data_len,
                         f_max=cfg.f_max, secure=sessions, ot_path=cfg.ot_path)
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    _sync(dev)
    seconds["crawl"] = time.perf_counter() - t0
    extra = {}
    if sessions is not None:
        extra["ot_consumed"] = [s.consumed for s in sessions.snd]
    emit("crawl.done", seconds=seconds["crawl"], levels=len(lead.timings["expand"]),
         hitters=int(res.paths.shape[0]), secure=cfg.secure_exchange, **extra)
    for row, c in zip(res.decode_ints(), res.counts):
        emit("hitter", value=str(row.tolist()), count=int(c))
    if cfg.distribution == "rides" and res.paths.shape[0]:
        # the same CSV contract as the JAX package's deployments
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        rides.save_heavy_hitters(res.paths, csv_path)
        emit("csv.written", path=csv_path, hitters=int(res.paths.shape[0]))
    return MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="Mesh", description="Single-card private fuzzy heavy hitters (PyTorch/CUDA)."
    )
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-n", "--num_requests", type=int, required=True)
    p.add_argument("--device", default=None,
                   help='device to run on (default "cuda"; "cpu" runs the '
                        "plain versions of the kernels)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the client sampling and keygen randomness")
    p.add_argument("--csv", default=OUTPUT_CSV,
                   help="rides heavy-hitter CSV to append to")
    for flag in ("--coordinator", "--processes", "--process_id", "--devices",
                 "--platform"):
        p.add_argument(flag, default=None)
    args = p.parse_args(argv)
    for flag in ("coordinator", "processes", "process_id", "devices", "platform"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag}: multi-process and multi-card runs are not ported "
                "to PyTorch yet; this binary runs one process on one card"
            )
    cfg = configmod.load_config(args.config)
    run(cfg, args.num_requests, device=args.device, seed=args.seed,
        csv_path=args.csv)


if __name__ == "__main__":
    main()
