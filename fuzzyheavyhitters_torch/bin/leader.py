"""Leader binary: client simulation and the protocol driver (the port of
``fuzzyheavyhitters_tpu/bin/leader.py``, ref: src/bin/leader.rs)::

    python -m fuzzyheavyhitters_torch.bin.leader --config configs/config.json -n 1000

Start both ``bin.server`` processes first.  Flow (leader.rs:300-440): keygen
report, client sampling, keygen (in malicious mode the clients' sketch keys
too, ``sketch_gen``), connect, ``reset``, batched key upload,
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
reconnect ``epoch``.

``FHH_WINDOWS=N`` (N > 1) streams instead of uploading once, as the JAX
leader does: the clients' key shares go through the servers' admission
gate (``submit_keys``, ``addkey_batch_size`` keys a submission, server 0
deciding and server 1 mirroring) into N tumbling windows of ceil(n / N)
clients; each window is sealed at its boundary and its frozen pool crawled
(``protocol.leader_rpc.WindowedIngest``) while the next window's
submissions land.  Each window prints ``ingest.window`` (its submissions'
seconds and keys/s, and whether the previous window's crawl was running
when they began), ``window.done`` (its crawl seconds, seal-to-hitters
seconds, recoveries, in malicious mode the clients alive) and its own
``hitter`` lines (``window`` w); ``crawl.done`` closes the run with the
ingest counters.  No CSV is written and no warmup runs in this mode.
``FHH_COLLECTION=key`` runs the crawl (supervised, windowed, warmed
alike) in that collection of the servers: leaders of distinct collections
share one server pair, each collection with its own keys, frontier, OT
sessions, ingest gate and checkpoint names (``fhh_server{id}_c{key}_l{level}
.npz``).  The observability and sanitizer switches the port does not have
yet are refused by name (``bin.refuse_unported_switches``), and so is
``debug_guards: true`` in the config (``utils.config.refuse_debug_guards``).
Keygen runs on ``cuda`` unless ``--device`` names another device or the
config says ``"backend": "cpu"``.
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
from typing import NamedTuple

import numpy as np
import torch

from ..ops import ibdcf
from ..ops.fields import F255, FE62
from ..protocol import sessions, sketch
from . import refuse_unported_switches
from ..protocol.leader_rpc import RpcLeader, WindowedIngest
from ..protocol.rpc import CollectorClient
from ..utils import config as configmod
from ..utils import resolve_device
from ..workloads import OUTPUT_CSV, rides, sample_points, strings
from .server import emit, split_addr


def refuse_unported_env() -> None:
    """Check the JAX leader's variables, read with its defaults, before any
    keygen.  Every mode they name is ported; a ``FHH_COLLECTION`` that
    cannot name a collection is refused with the JAX session table's
    ``ValueError`` (which a server's hello would answer)."""
    sessions.check_key(os.environ.get("FHH_COLLECTION") or None)


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


class ClientKeys(NamedTuple):
    """What :func:`client_keys` makes for ``N`` clients."""

    points: np.ndarray  # bool[N, d, L]
    keys0: ibdcf.IbDcfKeyBatch  # wire form (ibdcf.keys_to_numpy)
    keys1: ibdcf.IbDcfKeyBatch
    keygen_s: float
    sketch0: list | None  # malicious mode: 16 wire leaves (sketch.sketch_to_numpy)
    sketch1: list | None
    sketch_s: float


def client_keys(cfg, nreqs: int, dev, seed) -> ClientKeys:
    """Sampling and keygen from ``default_rng(seed)`` in ``bin.mesh``'s
    order, the keys in wire form; with ``cfg.malicious`` the sketch keys
    next, from the same generator as the JAX leader draws them: seeds
    uint32[N, d, 2, 4], then the client seed uint32[4], into
    ``sketch.gen`` over the points (JAX bin/leader.py:114-128)."""
    rng = np.random.default_rng(seed)
    pts = sample_points(cfg, nreqs, rng)
    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device=dev)
    keys0, keys1 = ibdcf.keys_to_numpy(k0), ibdcf.keys_to_numpy(k1)
    dt = time.perf_counter() - t0
    del k0, k1  # the servers hold the keys from here on: free the card
    sk0 = sk1 = None
    sk_s = 0.0
    if cfg.malicious:
        seeds = rng.integers(0, 2**32, size=(nreqs, cfg.n_dims, 2, 4), dtype=np.uint32)
        cseed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
        t0 = time.perf_counter()
        s0, s1 = sketch.gen(seeds, pts, FE62, F255, cseed, device=dev)
        sk0, sk1 = sketch.sketch_to_numpy(s0), sketch.sketch_to_numpy(s1)
        sk_s = time.perf_counter() - t0
        del s0, s1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ClientKeys(pts, keys0, keys1, dt, sk0, sk1, sk_s)


async def run(cfg, nreqs: int, dev, seed, warm_buckets=None) -> None:
    """The leader's flow (see the module docstring); ``warm_buckets`` names
    the warmup's buckets (None: :meth:`RpcLeader.warmup`'s ladder to
    ``f_max``)."""
    keygen_report(cfg, np.random.default_rng(), dev)
    emit("sampling", distribution=cfg.distribution, n=nreqs, device=str(dev))
    ck = client_keys(cfg, nreqs, dev, seed)
    keys0, keys1, sk0, sk1 = ck.keys0, ck.keys1, ck.sketch0, ck.sketch1
    emit("keygen", seconds=ck.keygen_s, n_keys=nreqs)
    if sk0 is not None:
        emit("sketch_gen", seconds=ck.sketch_s, n_keys=nreqs,
             bytes_per_server=sum(a.nbytes for a in sk0))
    del ck
    warm = os.environ.get("FHH_WARMUP", "1") != "0"
    supervise = os.environ.get("FHH_SUPERVISE", "1") != "0"
    windows = max(1, int(os.environ.get("FHH_WINDOWS", "1")))
    # the collection this leader's crawl runs in on the servers (JAX
    # bin/leader.py:132-138): leaders of distinct collections share one pair
    collection = os.environ.get("FHH_COLLECTION") or None
    c0 = await CollectorClient.connect(*split_addr(cfg.server0), collection=collection)
    c1 = await CollectorClient.connect(*split_addr(cfg.server1), collection=collection)
    try:
        lead = RpcLeader(cfg, c0, c1, emit=emit)
        if windows > 1:
            await run_windows(lead, nreqs, windows, keys0, keys1, sk0, sk1)
            return
        t0 = time.perf_counter()
        if supervise:  # the keys stay for a restarted server's re-upload
            res = await lead.run_supervised(
                nreqs, keys0, keys1, sk0, sk1,
                checkpoint_every=int(os.environ.get("FHH_CKPT_EVERY", "16")),
                warmup=warm, warm_buckets=warm_buckets)
            extra = {"seconds_by_part": lead.seconds, **lead.counters}
        else:
            await asyncio.gather(c0.call("reset"), c1.call("reset"))
            await lead.upload_keys(keys0, keys1, sk0, sk1)
            del keys0, keys1, sk0, sk1
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
             alive=None if lead.alive is None else int(lead.alive.sum()),
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


def _emit_window(res, window: int) -> None:
    """A window's own heavy-hitter lines (JAX bin/leader.py:42)."""
    for row, c in zip(res.decode_ints(), res.counts):
        emit("hitter", window=window, value=str(row.tolist()), count=int(c))


async def run_windows(lead: RpcLeader, nreqs: int, windows: int, keys0, keys1, sk0=None,
                      sk1=None) -> dict:
    """The ``FHH_WINDOWS`` flow (JAX bin/leader.py:158-208): ``reset``, then
    for each window its clients' submissions (one client id per chunk, as
    the JAX leader names them), the seal, the previous window's hitters, and
    the crawl of this window started in the background, so that the next
    window's submissions overlap it.  -> the figures of ``crawl.done``."""
    cfg = lead.cfg
    t0 = time.perf_counter()
    await lead._both("reset")
    wi = WindowedIngest(lead)
    per_w = (nreqs + windows - 1) // windows
    bs = max(1, cfg.addkey_batch_size)
    crawl_task = None
    last = None

    async def finish(task, w):
        res = await task  # the next window's crawl starts after this: lead.alive is w's
        emit("window.done", window=w, hitters=int(res.paths.shape[0]),
             alive=None if lead.alive is None else int(lead.alive.sum()), **wi.windows[w])
        _emit_window(res, w)

    for w in range(windows):
        lo_w, hi_w = w * per_w, min((w + 1) * per_w, nreqs)
        overlapped = crawl_task is not None and not crawl_task.done()
        t_sub = time.perf_counter()
        for chunk_no, lo in enumerate(range(lo_w, hi_w, bs)):
            sl = slice(lo, min(lo + bs, hi_w))
            await wi.submit(f"site{chunk_no % max(1, cfg.num_sites)}",
                            tuple(leaf[sl] for leaf in keys0), tuple(leaf[sl] for leaf in keys1),
                            sk0_chunk=None if sk0 is None else [leaf[sl] for leaf in sk0],
                            sk1_chunk=None if sk1 is None else [leaf[sl] for leaf in sk1])
        dt = time.perf_counter() - t_sub
        stats = await wi.seal_window()
        emit("ingest.window", window=w, keys=int(stats["keys"]), subs=int(stats["subs"]),
             seconds=dt, keys_per_s=(hi_w - lo_w) / dt if dt > 0 else None,
             during_crawl=overlapped, sk_root=stats.get("sk_root"))
        if crawl_task is not None:
            await finish(crawl_task, last)
        crawl_task = None
        if stats["keys"]:
            crawl_task, last = asyncio.create_task(wi.crawl_window(w)), w
    if crawl_task is not None:
        await finish(crawl_task, last)
    figures = {"seconds": time.perf_counter() - t0, "windows": windows,
               "secure": cfg.secure_exchange, "malicious": cfg.malicious,
               "epochs": [lead.c0.epoch, lead.c1.epoch],
               "alive": None if lead.alive is None else int(lead.alive.sum()),
               "control_bytes": {"server0": lead.c0.stats, "server1": lead.c1.stats},
               **wi.counters}
    emit("crawl.done", **figures)
    return figures


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="Leader", description="Leader of the socket deployment (PyTorch/CUDA); runs "
        "the supervised crawl (checkpoints every FHH_CKPT_EVERY levels, default 16) unless "
        "FHH_SUPERVISE=0; FHH_WARMUP=0 skips the warmup; FHH_WINDOWS=N streams the clients "
        "into N windows; FHH_COLLECTION=key crawls that collection of the servers.")
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
    refuse_unported_switches()
    cfg = configmod.load_config(args.config)
    configmod.refuse_debug_guards(cfg)
    dev = resolve_device(args.device or ("cpu" if cfg.backend == "cpu" else None))
    asyncio.run(run(cfg, args.num_requests, dev, args.seed))


if __name__ == "__main__":
    main()
