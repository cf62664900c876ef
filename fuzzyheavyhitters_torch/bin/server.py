"""Collector server binary (the port of ``fuzzyheavyhitters_tpu/bin/server.py``,
ref: src/bin/server.rs).  Run one per party, server 1 first::

    python -m fuzzyheavyhitters_torch.bin.server --config configs/config.json --server_id 1
    python -m fuzzyheavyhitters_torch.bin.server --config configs/config.json --server_id 0

Server 1 listens for its peer on its own port + 1 and server 0 dials it;
only then does each bind its leader-facing port (server.rs:344-354).  It
runs on ``cuda`` unless ``--device`` names another device or the config
says ``"backend": "cpu"``; on the card it builds its kernels and starts its
CUDA context before it listens.  With ``FHH_CKPT_DIR`` set (made if
missing) it answers the supervising leader's ``tree_checkpoint`` and
``tree_restore`` with blobs in that directory; a server started again on
the same ports and directory after a crash rejoins the crawl there.
Events go through ``obs.emit`` (``FHH_LOG_FORMAT=json`` and
``FHH_LOG_STREAM=stdout``: JSON lines on standard output, each with its
wall clock ``ts``): ``server.plane_listening`` (server 1, once its peer may dial),
``server.serving`` once the leader may connect, the recovery events
(``resilience.server_checkpoint`` with the blob's bytes and seconds,
``resilience.server_restore``, ``resilience.plane_reset``,
``resilience.plane_break``) and on SIGTERM or SIGINT ``server.exit`` with
its registries' flat figures under the registries' own names
(``CollectorServer.summary``): the seconds per phase, the bytes of each
plane, the largest data-plane frame, the crawl verbs begun and finished,
the ``add_keys`` chunks, replays answered from the dedup cache, plane
resets, checkpoints written and restored (``checkpoint_writes``,
``checkpoint_restores``), the ``sketch_verify`` verbs and their seconds (phase
``sketch``), the prunes' sketch advance seconds (``sketch_advance_s``), the
clients still alive (``alive_clients``; null before a
``tree_init``), the launches of each kernel in this process and, on the
card, its peak ``torch.cuda.max_memory_allocated`` and the data shards'
``mesh`` section (null without them).  ``FHH_DATA_DEVICES`` overrides the
config's ``server_data_devices`` (N > 1: N data shards, wrapped onto the
visible cards, or logical CPU shards with ``--device cpu``) and
``FHH_MESH_FAULTS`` arms the device-loss drills (``mesh:kill@level=N``,
the grammar of ``resilience.chaos.parse_mesh_faults``).  With ``FHH_FLEET``
set, the server registers in that fleet directory once it serves: it writes
``<pair>_s<id>.json`` (``FHH_FLEET_PAIR``, default ``pair0``; its host, port,
boot id and ``FHH_FLEET_CAPACITY``, default 4) by a temporary file and a
rename, and prints ``fleet.registered``; ``protocol.fleet.FleetDirectory.
scan`` folds the two halves into one pair.  With ``FHH_METRICS_PORT`` set
the server serves ``/metrics`` on base + 1 (server 0) or + 2 (server 1),
claimed before the arguments are checked (JAX bin/server.py:146-153; a bind
failure is a ``metrics.disabled`` warning), with its live session rows and
the alert rules evaluated at each scrape; ``FHH_ALERT_*`` set the rules'
thresholds.  ``FHH_DEBUG_GUARDS=1`` or ``debug_guards: true`` arms the
lock-discipline sanitizer on the server and its collection sessions, and
``FHH_DEBUG_TAINT=1`` the taint sanitizer.

Telemetry (JAX bin/server.py:166-178): ``FHH_RUN_REPORT`` is claimed as
this server's ``<path>.s<id>.json`` sibling and written at exit, the trace
ring under ``FHH_TRACE_DIR`` is tagged ``s<id>``, ``FHH_PROFILE`` with
``FHH_PROFILE_LEVELS`` captures those crawl levels, and a heartbeat names
the active span every ``FHH_HEARTBEAT_S`` seconds (30 unset).  A fresh
``nvcc`` build at start-up counts as ``fresh_compiles``.  SIGTERM ends the
server with exit code 143 once ``server.exit`` is out (``obs.exit_report``'s
contract), SIGINT with 0.
The ingest front door (``submit_keys``, ``window_seal``, ``window_load``)
reads the config's ``ingest_*`` fields; ``server.exit`` counts its
submissions (``pool_*``), sealed windows and the last window's seconds from
seal to final shares (``seal_to_hitters_s``).  The counters are the
server's totals over its collections; ``sessions`` gives each
collection's row (its counters, the plane epoch its channel was keyed at,
its checkpoint levels) and the tenant scheduler's device turns and stall
fills.  ``alive_clients`` and ``mesh`` are the default collection's.  Under
``FHH_DEBUG_TAINT=1`` it also counts the secret buffers the taint
sanitizer watched (``taint_markers``).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import signal
import sys
import time

import torch

from .. import obs
from ..protocol.rpc import CollectorServer
from ..resilience.chaos import MeshChaos, parse_mesh_faults
from ..utils import config as configmod
from ..utils import guards, resolve_device, taint_guard


def emit(event: str, **kw) -> None:
    obs.emit(event, **kw)


def split_addr(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def launch_counts() -> dict:
    """Launches of each CUDA kernel in this process so far."""
    from ..ops import expand_cuda, gc_cuda, keygen_cuda, otext_cuda

    return {"keygen": keygen_cuda.LAUNCHES, "expand": expand_cuda.LAUNCHES,
            "ot2s_encrypt": otext_cuda.ENC_LAUNCHES, "ot2s_decrypt": otext_cuda.DEC_LAUNCHES,
            "gc_garble": gc_cuda.GARBLE_LAUNCHES, "gc_eval": gc_cuda.EVAL_LAUNCHES}


def fleet_register(server, server_id: int, host: str, port: int) -> str | None:
    """Write this server's half of its pair's row into the fleet directory
    ``FHH_FLEET`` (JAX bin/server.py:38-66) and return its path (None
    without ``FHH_FLEET``).  The boot id is what the fleet's probe compares,
    so a restarted process registers as a new boot; the temporary file and
    rename keep a scan from reading a torn row."""
    fleet_dir = os.environ.get("FHH_FLEET")
    if not fleet_dir:
        return None
    os.makedirs(fleet_dir, exist_ok=True)
    pair = os.environ.get("FHH_FLEET_PAIR") or "pair0"
    row = {"pair": pair, "server_id": server_id, "host": host, "port": port,
           "boot_id": server.boot_id,
           "capacity": int(os.environ.get("FHH_FLEET_CAPACITY", "4")),
           "ts": round(time.time(), 3)}
    path = os.path.join(fleet_dir, f"{pair}_s{server_id}.json")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(row, f)
    os.replace(tmp, path)
    emit("fleet.registered", pair=pair, server=server_id, boot_id=server.boot_id)
    return path


async def amain(cfg, server_id: int, device) -> None:
    host0, port0 = split_addr(cfg.server0)
    host1, port1 = split_addr(cfg.server1)
    my_host, my_port = (host0, port0) if server_id == 0 else (host1, port1)
    peer_host = host1 if server_id == 0 else my_host
    ckpt_dir = os.environ.get("FHH_CKPT_DIR") or None
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
    # data shards: FHH_DATA_DEVICES overrides the config, FHH_MESH_FAULTS
    # arms the consumed-once device-loss schedule (JAX bin/server.py:100-116)
    dd = os.environ.get("FHH_DATA_DEVICES")
    if dd is not None:
        cfg = dataclasses.replace(cfg, server_data_devices=int(dd))
    faults = os.environ.get("FHH_MESH_FAULTS")
    chaos = MeshChaos(parse_mesh_faults(faults), emit=emit) if faults else None
    server = CollectorServer(server_id, cfg, device, ckpt_dir=ckpt_dir, emit=emit,
                             mesh_chaos=chaos)
    if server.device.type == "cuda":  # kernels and CUDA context before the first verb
        from ..ops import cuda_build

        cuda_build.build()
        torch.zeros(1, device=server.device)
    stop = asyncio.Event()
    got = []  # the signal that stopped the server
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, lambda s=sig: (got.append(s), stop.set()))
    try:
        await server.start(my_host, my_port, peer_host, port1 + 1, on_plane_listen=lambda: emit(
            "server.plane_listening", server=server_id, host=my_host, port=port1 + 1))
        # after the start, so a row only ever names a pair that listens
        fleet_register(server, server_id, my_host, my_port)
        emit("server.serving", server=server_id, host=my_host, port=my_port,
             device=str(server.device))
        await stop.wait()
    finally:
        await server.aclose()
        # a last device-memory sample: a run whose leader never probes
        # status still reports the card's memory at its end
        obs.devmem.sample(server.obs, phase="exit")
        with guards.unguarded("exit report: the server is closed, no verb runs"):
            alive = server.alive_keys
        # with the taint sanitizer on: how many secret buffers it watched
        armed = {"taint_markers": taint_guard.marker_count()} if taint_guard.enabled() else {}
        emit("server.exit", server=server_id, device=str(server.device), **armed,
             boot_id=server.boot_id, **server.summary(), launches=launch_counts(),
             alive_clients=None if alive is None else int(alive.sum()),
             mesh=server.mesh_status(), sessions=server.sessions_status(),
             max_memory_allocated=(
                 torch.cuda.max_memory_allocated(server.device)
                 if server.device.type == "cuda" else 0))
    if got and got[0] == signal.SIGTERM:
        raise SystemExit(143)  # obs.exit_report's SIGTERM contract


def _peek_server_id(argv: list) -> int | None:
    """``--server_id``'s value before the arguments are parsed, so the
    /metrics port is claimed first (:func:`main`)."""
    for i, a in enumerate(argv):
        val = (argv[i + 1] if a in ("--server_id", "-i") and i + 1 < len(argv)
               else a.split("=", 1)[1] if a.startswith("--server_id=") else None)
        if val is not None:
            try:
                return int(val)
            except ValueError:
                return None
    return None


def main(argv=None) -> None:
    # the /metrics exporter claims its port first, before the arguments are
    # checked: a server that dies on a bad config was scrapeable while it
    # lived, and a port conflict shows at once (one getenv when unset)
    sid = _peek_server_id(sys.argv[1:] if argv is None else list(argv))
    obs.exporter.maybe_start(f"s{sid}" if sid in (0, 1) else "server")
    p = argparse.ArgumentParser(prog="Server", description="Collector server (PyTorch/CUDA).")
    p.add_argument("-c", "--config", required=True, help="Location of JSON config file")
    p.add_argument("-i", "--server_id", type=int, required=True, help="Zero-indexed ID of server")
    p.add_argument("--device", default=None,
                   help='device to run on (default "cuda", or "cpu" when the config says '
                        '"backend": "cpu"; "cpu" runs the plain versions of the kernels)')
    args = p.parse_args(argv)
    if args.server_id not in (0, 1):
        raise SystemExit(f"server_id must be 0 or 1, got {args.server_id}")
    cfg = configmod.load_config(args.config)
    device = resolve_device(args.device or ("cpu" if cfg.backend == "cpu" else None))
    # both servers and the leader inherit one FHH_RUN_REPORT: each server
    # writes its own sibling, and names its trace ring the same way
    obs.claim_report_path(f"s{args.server_id}")
    obs.trace.claim_tag(f"s{args.server_id}")
    with obs.exit_report():
        asyncio.run(amain(cfg, args.server_id, device))


if __name__ == "__main__":
    sys.exit(main())
