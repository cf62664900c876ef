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
Events are JSON lines on standard output, each with its wall clock
``t``: ``server.plane_listening`` (server 1, once its peer may dial),
``server.serving`` once the leader may connect, the recovery events
(``resilience.server_checkpoint`` with the blob's bytes and seconds,
``resilience.server_restore``, ``resilience.plane_reset``,
``resilience.plane_break``) and on SIGTERM or SIGINT ``server.exit`` with
the seconds per phase, the bytes of each plane, the largest data-plane
frame, the crawl verbs begun and finished, the ``add_keys`` chunks,
replays answered from the dedup cache, plane resets, checkpoints written
and restored, the ``sketch_verify`` verbs and their seconds (phase
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
scan`` folds the two halves into one pair.  The observability and sanitizer
switches the port does not have yet are refused
(``bin.refuse_unported_switches``), and so is ``debug_guards: true`` in the
config (``utils.config.refuse_debug_guards``).
The ingest front door (``submit_keys``, ``window_seal``, ``window_load``)
reads the config's ``ingest_*`` fields; ``server.exit`` counts its
submissions (``pool_*``), sealed windows and the last window's seconds from
seal to final shares (``seal_to_hitters_s``).  The counters are the
server's totals over its collections; ``sessions`` gives each
collection's row (its counters, the plane epoch its channel was keyed at,
its checkpoint levels) and the tenant scheduler's device turns and stall
fills.  ``alive_clients`` and ``mesh`` are the default collection's.
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

from . import refuse_unported_switches
from ..protocol.rpc import CollectorServer
from ..resilience.chaos import MeshChaos, parse_mesh_faults
from ..utils import config as configmod
from ..utils import resolve_device


def emit(event: str, **kw) -> None:
    print(json.dumps({"event": event, "t": time.time(), **kw}), flush=True)


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
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
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
        emit("server.exit", server=server_id, device=str(server.device),
             boot_id=server.boot_id, **server.stats, launches=launch_counts(),
             alive_clients=(None if server.alive_keys is None
                            else int(server.alive_keys.sum())),
             mesh=server.mesh_status(), sessions=server.sessions_status(),
             max_memory_allocated=(
                 torch.cuda.max_memory_allocated(server.device)
                 if server.device.type == "cuda" else 0))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="Server", description="Collector server (PyTorch/CUDA).")
    p.add_argument("-c", "--config", required=True, help="Location of JSON config file")
    p.add_argument("-i", "--server_id", type=int, required=True, help="Zero-indexed ID of server")
    p.add_argument("--device", default=None,
                   help='device to run on (default "cuda", or "cpu" when the config says '
                        '"backend": "cpu"; "cpu" runs the plain versions of the kernels)')
    args = p.parse_args(argv)
    if args.server_id not in (0, 1):
        raise SystemExit(f"server_id must be 0 or 1, got {args.server_id}")
    refuse_unported_switches()
    cfg = configmod.load_config(args.config)
    configmod.refuse_debug_guards(cfg)
    device = resolve_device(args.device or ("cpu" if cfg.backend == "cpu" else None))
    asyncio.run(amain(cfg, args.server_id, device))


if __name__ == "__main__":
    sys.exit(main())
