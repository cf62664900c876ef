"""Entry point: the whole collection in one process, or in two.

The port of ``fuzzyheavyhitters_tpu/bin/mesh.py``: sample the clients,
generate both parties' ibDCF keys, crawl the prefix tree, emit the heavy
hitters, and for the rides workload append them to the heavy-hitter CSV.
Events go through ``obs.emit`` (JSON lines on standard output with
``FHH_LOG_FORMAT=json`` and ``FHH_LOG_STREAM=stdout``; a caller of
:func:`run` that wants them in a stream of its own sets it with
``obs.logs.configure(fmt="json", stream=...)``).  With ``secure_exchange: true``
in the config the servers run the secure exchange (``protocol/secure.py``)
on two OT-extension sessions set up by the Chou-Orlandi base OT from
system randomness; otherwise the trusted exchange.

Two engines:

- the device mesh (``parallel/mesh.py``): ``--devices N`` crawls on a
  2 × N/2 mesh of shards (servers × client blocks), the exchange as
  collectives between the rows.  On the card the shards go over the visible
  cards in order and wrap onto the same card when there are fewer cards
  than shards (``--devices 8`` on a one-card host: eight logical shards on
  it); with ``--device cpu`` they are logical shards on the host.  With no
  ``--devices`` the mesh spans all visible cards when there are two or
  more, as the JAX binary does;
- otherwise the single-card crawl (``protocol/driver.py``), which a
  one-card host and ``--device cpu`` run (the JAX mesh would refuse the
  odd device count of one card).

``--processes 2 --process_id p --coordinator host:port`` runs the mesh in
two processes, one row each, over a gloo process group (its tensors staged
through host memory); each process samples and generates both parties'
keys from the shared ``--seed`` (process 0 draws and broadcasts one when
none is given) and keeps its own party's.  Process 0 writes the CSV.  As
in the JAX binary, the mesh ignores ``ot_path`` (its engine follows
``secure.EQ_OT4``) and ``crawl_radix_bits`` (one level a round).

::

    python -m fuzzyheavyhitters_torch.bin.mesh --config configs/config.json -n 1000
    python -m fuzzyheavyhitters_torch.bin.mesh --config configs/config.json -n 300 --device cpu --devices 8
    python -m fuzzyheavyhitters_torch.bin.mesh -c configs/config.json -n 300 --device cpu \
        --seed 1 --devices 8 --processes 2 --process_id 0 --coordinator 127.0.0.1:29500

It runs on ``cuda`` unless ``--device`` names another device, and raises
when there is no card.  ``--platform`` (a JAX backend pin) is refused.  It
starts no /metrics exporter, as the JAX ``bin/mesh`` starts none; the
sanitizers' switches act as anywhere.  It runs under ``obs.exit_report``
(JAX bin/mesh.py:87-92): the run report at exit (``FHH_RUN_REPORT``; two
processes write ``<path>.p<id>.json`` siblings), the trace ring, the
heartbeat.
Malicious mode is refused as the JAX binary refuses it: the mesh holds both
parties in one trust domain, so the sketch would add no security; the
socket binaries run it.
"""

from __future__ import annotations

import argparse
import os
import secrets
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..ops import ibdcf
from ..parallel import mesh as meshmod
from ..protocol import driver
from ..utils import config as configmod
from ..utils import resolve_device
from ..workloads import OUTPUT_CSV, rides, sample_points


MALICIOUS_REFUSAL = (
    "mesh binary: malicious mode refused — the mesh co-locates both "
    "parties in one trust domain, so sketch verification adds no "
    "security there; use the socket binaries (bin/server.py x2 + "
    "bin/leader.py), which run the full sketch+MPC path.")


@dataclass
class MeshRun:
    points: np.ndarray  # bool[N, d, L] the sampled client points
    result: driver.CrawlResult
    leader: driver.Leader | meshmod.MeshLeader
    seconds: dict  # sampling / keygen / crawl wall seconds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_launches() -> dict:
    """This process's kernel launches so far, by kernel (the wrappers'
    counters; nothing counts on the CPU)."""
    from ..ops import expand_cuda, gc_cuda, keygen_cuda, otext_cuda

    return {"keygen": keygen_cuda.LAUNCHES, "expand": expand_cuda.LAUNCHES,
            "ot2s_encrypt": otext_cuda.ENC_LAUNCHES, "ot2s_decrypt": otext_cuda.DEC_LAUNCHES,
            "gc_garble": gc_cuda.GARBLE_LAUNCHES, "gc_eval": gc_cuda.EVAL_LAUNCHES}


def use_mesh(dev: torch.device, devices: int | None, processes: int | None) -> bool:
    """Whether a run crawls on the device mesh: asked for (``--devices``,
    ``--processes``), or on two or more visible cards."""
    if devices is not None or processes:
        return True
    return dev.type == "cuda" and torch.cuda.device_count() >= 2


def run(cfg: configmod.Config, n: int, device=None, seed: int | None = None,
        csv_path: str = OUTPUT_CSV, session: dict | None = None,
        devices: int | None = None, processes: int | None = None,
        process_id: int | None = None, coordinator: str | None = None) -> MeshRun:
    """Sample ``n`` clients, keygen, crawl, emit; returns the points, the
    result and the leader (a ``driver.Leader``, whose servers still hold the
    keys and whose ``secure`` holds the OT sessions of a secure crawl, or a
    ``parallel.mesh.MeshLeader`` on the mesh).  ``session`` is the secure
    crawl's base-OT material (``driver.session_material``); None runs the
    base OT from system randomness.  ``devices``, ``processes``,
    ``process_id`` and ``coordinator`` are the binary's mesh flags."""
    if cfg.malicious:
        raise SystemExit(MALICIOUS_REFUSAL)
    dev = resolve_device(device)
    mesh_run = use_mesh(dev, devices, processes)
    if processes and processes > 1:
        meshmod.init_distributed(coordinator, processes, process_id)
        # both processes sample the same clients
        seed = meshmod.agree(secrets.randbits(63) if seed is None else seed)

    rng = np.random.default_rng(seed)
    seconds = {}
    obs.emit("sampling", distribution=cfg.distribution, n=n, device=str(dev))
    t0 = time.perf_counter()
    pts = sample_points(cfg, n, rng)
    seconds["sampling"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device=dev)
    _sync(dev)
    seconds["keygen"] = time.perf_counter() - t0
    obs.emit("keygen.report", seconds=seconds["keygen"], n_keys=n,
         engine=ibdcf.best_engine(dev))

    extra = {}
    if mesh_run:
        keys = [k0, k1]
        if processes == 2:  # this process keeps its own party's keys only
            keys[1 - process_id] = None
        del k0, k1
        lead, res = _crawl_mesh(cfg, n, keys, dev, devices, processes, session, seconds)
        extra["levels"] = len(lead.timings["level"])
        extra["recoveries"] = lead.counters["recoveries"]
        if lead.r.link.rank is not None:
            extra["group_bytes"] = {"sent": lead.r.link.bytes_sent,
                                    "received": lead.r.link.bytes_received}
    else:
        s0, s1 = driver.make_servers(k0, k1)
        del k0, k1
        sessions = None
        if cfg.secure_exchange:
            t0 = time.perf_counter()
            sessions = driver.make_sessions(
                driver.session_material() if session is None else session, dev)
            seconds["base_ot"] = time.perf_counter() - t0
            obs.emit("secure.session", seconds=seconds["base_ot"], ot_path=cfg.ot_path)
        lead = driver.Leader(s0, s1, n_dims=cfg.n_dims, data_len=cfg.data_len,
                             f_max=cfg.f_max, secure=sessions, ot_path=cfg.ot_path)
        t0 = time.perf_counter()
        res = lead.run(nreqs=n, threshold=cfg.threshold)
        _sync(dev)
        seconds["crawl"] = time.perf_counter() - t0
        extra["levels"] = len(lead.timings["expand"])
        if sessions is not None:
            extra["ot_consumed"] = [s.consumed for s in sessions.snd]
    obs.emit("crawl.done", seconds=seconds["crawl"], hitters=int(res.paths.shape[0]),
         secure=cfg.secure_exchange, mesh=mesh_run, launches=kernel_launches(), **extra)
    for row, c in zip(res.decode_ints(), res.counts):
        obs.emit("hitter", value=str(row.tolist()), count=int(c))
    if cfg.distribution == "rides" and res.paths.shape[0] and not process_id:
        # the same CSV contract as the JAX package's deployments
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        rides.save_heavy_hitters(res.paths, csv_path)
        obs.emit("csv.written", path=csv_path, hitters=int(res.paths.shape[0]))
    return MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def _crawl_mesh(cfg, n, keys, dev, devices, processes, session, seconds):
    """Build the mesh and its runner over the parties' keys ([k0, k1], the
    peer's None in two processes) and crawl; returns (MeshLeader, result).
    ``keys`` is emptied once the runner holds its shards."""
    if dev.type == "cuda":
        mesh = meshmod.make_mesh(devices)
    else:  # logical shards on one non-card device (2 x 1 unless --devices)
        mesh = meshmod.make_mesh(devices=[dev] * (devices or 2))
    t0 = time.perf_counter()
    if processes == 2:
        my = next(kb for kb in keys if kb is not None)
        runner = meshmod.MeshRunner.from_process_local(
            mesh, my, cfg.f_max, secure_exchange=cfg.secure_exchange, session=session)
        del my
    else:
        runner = meshmod.MeshRunner(mesh, *keys, cfg.f_max,
                                    secure_exchange=cfg.secure_exchange, session=session)
    keys.clear()
    seconds["mesh_setup"] = time.perf_counter() - t0
    obs.emit("mesh.placement", rows=mesh.placement(), held_rows=list(runner.rows),
         processes=processes or 1, seconds=seconds["mesh_setup"])
    lead = meshmod.MeshLeader(runner)
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    _sync(dev)
    seconds["crawl"] = time.perf_counter() - t0
    return lead, res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="Mesh", description="Private fuzzy heavy hitters in one or two processes "
                                 "(PyTorch/CUDA).")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-n", "--num_requests", type=int, required=True)
    p.add_argument("--device", default=None,
                   help='device to run on (default "cuda"; "cpu" runs the plain versions '
                        "of the kernels)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the client sampling and keygen randomness")
    p.add_argument("--csv", default=OUTPUT_CSV, help="rides heavy-hitter CSV to append to")
    p.add_argument("--devices", type=int, default=None,
                   help="crawl on a 2 x N/2 mesh of N shards (default: all cards when there "
                        "are two or more; shards wrap onto the visible cards)")
    p.add_argument("--processes", type=int, default=None,
                   help="processes of the mesh: 1, or 2 (one row each)")
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--coordinator", default=None, help="host:port of the process group")
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    if args.platform is not None:
        p.error("--platform pins a JAX backend; this binary takes --device")
    if args.processes is not None and args.processes not in (1, 2):
        p.error(f"--processes {args.processes}: the mesh runs in one process or two")
    if args.processes == 2 and (args.coordinator is None or args.process_id not in (0, 1)):
        p.error("--processes 2 needs --coordinator host:port and --process_id 0 or 1")
    cfg = configmod.load_config(args.config)
    if args.processes == 2:  # both inherit one FHH_RUN_REPORT: one sibling each
        obs.claim_report_path(f"p{args.process_id}")
        obs.trace.claim_tag(f"p{args.process_id}")
    with obs.exit_report():
        run(cfg, args.num_requests, device=args.device, seed=args.seed, csv_path=args.csv,
            devices=args.devices, processes=args.processes, process_id=args.process_id,
            coordinator=args.coordinator)


if __name__ == "__main__":
    main()
