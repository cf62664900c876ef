"""Time socket cells of two trees of the port on one card, interleaved.

Each run is ``chip_smoke.py``'s phase 9 shape: two ``bin.server`` processes
and a ``bin.leader`` started together from the tree's own package, with
``FHH_WARMUP=0`` and ``FHH_SUPERVISE=0``, the servers sent SIGTERM after the
leader's exit.  No telemetry switch is set: this times the path a user runs
with telemetry off.  A tree that has ``obs/logs.py`` gets
``FHH_LOG_FORMAT=json FHH_LOG_STREAM=stdout`` (an older tree prints JSON
lines on stdout by itself and refuses those switches).

``--pattern ABBA --rounds 2`` runs A B B A A B B A for every cell; each
tree's kernels are built first (``cuda_build.build``, both trees at once),
so no run compiles.  Per run it keeps the wall seconds from the first spawn
to the leader's exit, the leader's ``addkeys.done`` and ``crawl.done``
seconds, and the later server's seconds from its spawn to ``server.serving``::

    python scripts/socket_ab.py --tree A=chipcheck/parent --tree B=. \\
        --cells rides_socket,rides_secure_socket --out build/socket_ab.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {  # name: (config overrides on configs/config.json, clients)
    "rides_socket": ({}, 262144),
    "rides_secure_socket": ({"secure_exchange": True, "ot_path": "auto"}, 8192),
}
LOG_ENV = {"FHH_LOG_FORMAT": "json", "FHH_LOG_STREAM": "stdout"}
TIMEOUT_S = 420


def free_ports():
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.startswith("{")]


def one_run(tree, cell, seed, work, device="cuda", clients=None):
    """One socket run of ``cell`` from ``tree`` in directory ``work``."""
    over, n = CELLS[cell]
    n = clients or n
    os.makedirs(work)
    p0, p1 = free_ports()
    with open(os.path.join(tree, "configs", "config.json")) as f:
        raw = dict(json.load(f), **over, server0=f"127.0.0.1:{p0}", server1=f"127.0.0.1:{p1}")
    cfg = os.path.join(work, "config.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    env = {**os.environ, "FHH_WARMUP": "0", "FHH_SUPERVISE": "0", "PYTHONPATH": tree}
    if os.path.exists(os.path.join(tree, "fuzzyheavyhitters_torch", "obs", "logs.py")):
        env.update(LOG_ENV)
    procs, logs, spawned = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for who, args in (("server1", ["server", "--server_id", "1"]),
                          ("server0", ["server", "--server_id", "0"]),
                          ("leader", ["leader", "-n", str(n), "--seed", str(seed)])):
            logs[who] = os.path.join(work, f"{who}.log")
            spawned[who] = time.time()
            with open(logs[who], "w") as out:
                procs[who] = subprocess.Popen(
                    [sys.executable, "-m", f"fuzzyheavyhitters_torch.bin.{args[0]}",
                     "--config", cfg, "--device", device, *args[1:]],
                    cwd=work, env=env, stdout=out, stderr=subprocess.STDOUT)
        rc = procs["leader"].wait(timeout=TIMEOUT_S)
        wall = time.perf_counter() - t0
        for who in ("server0", "server1"):
            procs[who].send_signal(signal.SIGTERM)
            procs[who].wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc != 0:
        with open(logs["leader"]) as f:
            raise SystemExit(f"{tree} {cell}: leader exited {rc}:\n{f.read()[-3000:]}")
    ev = {who: events(path) for who, path in logs.items()}
    first = lambda who, name: next(e for e in ev[who] if e["event"] == name)
    serving = lambda who: first(who, "server.serving")
    return {"wall_s": wall, "addkeys_s": first("leader", "addkeys.done")["seconds"],
            "serving_s": max(serving(w).get("ts", serving(w).get("t")) - spawned[w]
                             for w in ("server0", "server1")),
            "crawl_s": first("leader", "crawl.done")["seconds"],
            "hitters": first("leader", "crawl.done")["hitters"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=path of a tree of the repo (two of them)")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--pattern", default="ABBA", help="order of the labels in a round")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--work", default=os.path.join(HERE, "build", "socket_ab"))
    ap.add_argument("--out", default=None, help="write every run's figures to this JSON file")
    ap.add_argument("--device", default="cuda", help='"cpu" rehearses the script on the host')
    ap.add_argument("--clients", type=int, default=None, help="clients of every cell "
                    "(default: the cell's own; for a rehearsal)")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    trees = {k: os.path.abspath(v) for k, v in trees.items()}
    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    builds = [subprocess.Popen([sys.executable, "-c", "from fuzzyheavyhitters_torch.ops "
                                "import cuda_build; cuda_build.build()"], cwd=t,
                               env={**os.environ, "PYTHONPATH": t})
              for t in (trees.values() if args.device == "cuda" else ())]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("a tree's kernels did not build")
    runs = []
    for cell in args.cells.split(","):
        for r in range(args.rounds):
            for i, label in enumerate(args.pattern):
                work = os.path.join(args.work, f"{cell}_r{r}_{i}_{label}")
                fig = dict(one_run(trees[label], cell, args.seed, work, args.device,
                                   args.clients), cell=cell,
                           tree=label, round=r, slot=i)
                runs.append(fig)
                print(json.dumps(fig), flush=True)
    summary = {}
    for cell in args.cells.split(","):
        for label in trees:
            mine = [x for x in runs if x["cell"] == cell and x["tree"] == label]
            summary[f"{cell} {label}"] = {
                k: {"median": statistics.median(x[k] for x in mine),
                    "min": min(x[k] for x in mine), "max": max(x[k] for x in mine)}
                for k in ("wall_s", "serving_s", "addkeys_s", "crawl_s")}
        if len({x["hitters"] for x in runs if x["cell"] == cell}) != 1:
            raise SystemExit(f"{cell}: the trees found different hitter counts")
    print(json.dumps({"device": smi, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "trees": trees, "runs": runs, "summary": summary}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
