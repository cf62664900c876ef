"""What phase 42's switches cost a secure socket crawl, on one card, in turns.

Runs ``chip_smoke.py``'s ``rides_secure_socket`` cell (``configs/config.json``
with the secure exchange, ot2s at S = 4, 8,192 clients, the leader
unsupervised, no warmup) through ``chip_smoke.socket_run`` under five sets of
switches: ``plain`` (none), ``sanitizers`` (``FHH_DEBUG_GUARDS=1``,
``FHH_DEBUG_TAINT=1``), ``scraped`` (``FHH_METRICS_PORT`` with phase 42's
scrape thread on the three endpoints, no ``ops top``), ``traced``
(``FHH_TRACE_DIR``) and ``live`` (all of phase 42's: ``chip_smoke.LIVE_ENV``,
the exporter scraped, the trace).  Every run's hitters must equal the first
run's.  The default order is ABCDEEDCBA; per run it keeps the leader's crawl
seconds, each server's ``gc_ot`` seconds and the scrapes made::

    python scripts/live_cost.py --out build/live_cost.json
    python scripts/live_cost.py --device cpu --clients 200   # a rehearsal

Prints the card's name and power limit first and, last, each set's crawl
seconds sorted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ORDER = ("plain", "sanitizers", "scraped", "traced", "live")
SANITIZERS = {"FHH_DEBUG_GUARDS": "1", "FHH_DEBUG_TAINT": "1"}


def switches(kind: str, tmp: str, i: int, cs) -> tuple:
    """(the environment a run of ``kind`` adds, its metrics base or None)."""
    env = dict(cs.SOCKET_ENV)
    if kind in ("sanitizers", "live"):
        env.update(SANITIZERS)
    if kind in ("traced", "live"):
        env["FHH_TRACE_DIR"] = os.path.join(tmp, f"trace{i}")
    if kind == "live":
        env.update(cs.LIVE_ENV)
    base = None
    if kind in ("scraped", "live"):
        base = cs.free_port_run(3)
        env["FHH_METRICS_PORT"] = str(base)
    return env, base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--device", default="cuda", help='"cpu" rehearses on the plain versions')
    ap.add_argument("--clients", type=int, default=None, help="default: the cell's 8,192")
    ap.add_argument("--order", default="ABCDEEDCBA",
                    help="letters A-E for plain, sanitizers, scraped, traced, live")
    ap.add_argument("--out", default=None, help="also write every figure to this JSON file")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from fuzzyheavyhitters_torch.utils import config as configmod

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        from fuzzyheavyhitters_torch.ops import cuda_build

        cuda_build.build()  # no run compiles
        cs.POOL.on = True
        cs.POOL.fill()
    else:
        smi = "cpu"
    cs.log(smi)
    with open(os.path.join(HERE, "configs", "config.json")) as f:
        raw = json.load(f)
    cfg = configmod.Config(**dict(raw, secure_exchange=True, ot_path="auto"))
    if args.device == "cpu":
        cfg = dataclasses.replace(cfg, backend="cpu")
    n = args.clients or cs.RIDES_SECURE_CLIENTS
    runs = {k: [] for k in ORDER}
    hitters = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i, letter in enumerate(args.order):
                kind = ORDER[ord(letter) - ord("A")]
                env, base = switches(kind, tmp, i, cs)
                scraper = None
                if base is not None:
                    scraper = cs._Scraper(base, {**os.environ, **env},
                                          os.path.join(tmp, f"top{i}.log"), top=False)
                    scraper.thread.start()
                try:
                    run = cs.socket_run(f"cost{i}_{kind}", cfg, n, args.seed, tmp, env)
                finally:
                    if scraper is not None:
                        scraper.stop.set()
                        scraper.thread.join(30)
                got = {e["value"]: e["count"] for e in run["hitters"]}
                hitters = hitters if hitters is not None else got
                if got != hitters:
                    raise AssertionError(f"run {i} ({kind}): hitters differ from run 0's")
                rec = {"run": i, "crawl_s": run["crawl"]["seconds"],
                       "gc_ot_s": [ex["seconds"]["gc_ot"] for ex in run["exits"]],
                       "scrapes": None if scraper is None else {
                           w: len(g) for w, g in scraper.scrapes.items()}}
                runs[kind].append(rec)
                cs.log(f"live_cost {i} {kind}: {rec}")
    finally:
        cs.POOL.close()
    crawl = {k: sorted(r["crawl_s"] for r in rs) for k, rs in runs.items() if rs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "clients": n, "runs": runs, "crawl_s": crawl}, f, indent=1)
    cs.log(json.dumps({"crawl_s": crawl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
