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
and restored, the launches of each kernel in this process and, on the
card, its peak ``torch.cuda.max_memory_allocated``.  The JAX binary's
fleet registration and multi-card options are not ported: their
variables are refused.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time

import torch

from ..protocol.rpc import CollectorServer, not_ported
from ..utils import config as configmod
from ..utils import resolve_device

# the JAX binary's environment knobs, each with the path it selects
UNPORTED_ENV = {
    "FHH_DATA_DEVICES": "a collector server sharded over several cards",
    "FHH_MESH_FAULTS": "the device-loss drills of the multi-card server",
    "FHH_FLEET": "fleet registration",
}


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


def refuse_unported_env() -> None:
    for var, path in UNPORTED_ENV.items():
        if os.environ.get(var):
            raise not_ported(var, path)


async def amain(cfg, server_id: int, device) -> None:
    host0, port0 = split_addr(cfg.server0)
    host1, port1 = split_addr(cfg.server1)
    my_host, my_port = (host0, port0) if server_id == 0 else (host1, port1)
    peer_host = host1 if server_id == 0 else my_host
    ckpt_dir = os.environ.get("FHH_CKPT_DIR") or None
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
    server = CollectorServer(server_id, cfg, device, ckpt_dir=ckpt_dir, emit=emit)
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
        emit("server.serving", server=server_id, host=my_host, port=my_port,
             device=str(server.device))
        await stop.wait()
    finally:
        await server.aclose()
        emit("server.exit", server=server_id, device=str(server.device),
             boot_id=server.boot_id, **server.stats, launches=launch_counts(),
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
    refuse_unported_env()
    cfg = configmod.load_config(args.config)
    device = resolve_device(args.device or ("cpu" if cfg.backend == "cpu" else None))
    asyncio.run(amain(cfg, args.server_id, device))


if __name__ == "__main__":
    sys.exit(main())
