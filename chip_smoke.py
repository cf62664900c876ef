#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout, one card
    python3 chip_smoke.py --profile    # also: device time by kernel per crawl

Phases (any failure raises, and the script exits non-zero):

1. build every CUDA kernel of the port from ``fuzzyheavyhitters_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold the keygen kernel bit-exact against its plain PyTorch version on the
   card (a 4096-client x L=512 chunk, both PRG bit modes);
3. the main path at full size, two crawls through ``bin.mesh.run`` with both
   servers on the card: the BASELINE.json config-4 shape (zipf over 10,000
   sites, exponent 1.03, data_len 512, n_dims 1, ball 2, threshold 0.001,
   f_max 1024) at N = 196,608 clients, and the ``configs/config.json`` rides
   shape (n_dims 2, data_len 16) at N = 262,144.  Kernel launch counts are
   zeroed just before each crawl and read just after; every hitter's count
   must equal a plaintext recount from the sampled points;
4. after each crawl, the expand kernel held bit-exact against its plain
   version on that crawl's real frontiers, re-crawled from its keys: each
   time the frontier reaches a new width (so at the widest), and at the
   last level, which builds no child cache; each check is timed;
5. the keygen kernel held bit-exact against its plain version at each
   crawl's shape (all N x n_dims x 2 keys, L levels) and timed.

The shapes are fixed: there is no option to cut them.  Exact comparisons
throughout (tolerance 0: the system is bitwise).  Prints the card's name
and power limit, every check with its times against its bound, crawl
figures, a ``{"kernels": [...]}`` line (the config-4 crawl's launches and
times; ``max_abs_err`` over every check of the kernel), and as its last
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer ops: the data sheet gives no integer rate, so take the issue
# limit, one warp instruction per clock per SM quarter = 128 thread ops per
# SM per clock (the rate behind its 67 TFLOP/s fp32: 2 flops x 128 x 132 SMs
# x 1.98 GHz).  The 64 INT32 lanes per SM are no limit: integer adds also
# issue to the FMA pipe as IMAD.  128 x 132 x 1.98e9 = 33.5e12 ops/s.
INT32_OPS_PER_S = 128 * 132 * 1.98e9
CHACHA8_OPS = 4 * 8 * 12 + 16  # 4 double rounds x 8 quarter-rounds x 12 ops + feed-forward
# ops that output word 8 alone needs (the derived t/y bits, all a level
# without a child cache reads): 3 full double rounds, the last one's 4 column
# quarter-rounds and 10 ops of one diagonal quarter-round, 1 feed-forward
# add and the seed mask
CHACHA8_WORD8_OPS = 7 * 4 * 12 + 10 + 1 + 1

CONFIG4 = dict(
    data_len=512, n_dims=1, ball_size=2, addkey_batch_size=100, num_sites=10000,
    threshold=0.001, zipf_exponent=1.03, server0="127.0.0.1:8000",
    server1="127.0.0.1:8001", distribution="zipf", f_max=1024,
)
ZIPF_CLIENTS = 196608
RIDES_CLIENTS = 262144
KEYGEN_CHUNK = (4096 * 2, 512)  # keys, levels
PLAIN_ROWS = 1 << 23  # rows per plain-expand slice: bounds its int64 temporaries


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(got, want, what: str) -> int:
    """Largest |difference| over paired integer/bool tensors; raises unless
    every pair is identical, so the return value is 0."""
    import torch

    err = 0
    for a, b in zip(got, want, strict=True):
        d = (a.long() - b.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel != plain (max_abs_err {err})")
    return err


def _ints(bits: np.ndarray) -> list:
    """bool[..., L] MSB-first bitstrings -> flat list of Python ints."""
    L = bits.shape[-1]
    rows = np.packbits(bits.reshape(-1, L), axis=-1)
    return [int.from_bytes(r.tobytes(), "big") >> (-L % 8) for r in rows]


def plaintext_counts(points: np.ndarray, ball: int, paths: np.ndarray) -> np.ndarray:
    """Clients whose L∞ ball holds each hitter in every dimension, from the
    sampled points alone (no FSS, no port code): a client at v covers
    [max(0, v - ball), min(2^L - 1, v + ball)] per dimension, in Python
    integers.  Interval ends and hitters are ranked together, so the
    containment test is a vectorised comparison of ranks."""
    N, d, L = points.shape
    top = (1 << L) - 1
    inside = np.ones((paths.shape[0], N), bool)
    for j in range(d):
        v, x = _ints(points[:, j]), _ints(paths[:, j])
        lo = [max(0, a - ball) for a in v]
        hi = [min(top, a + ball) for a in v]
        rank = {val: r for r, val in enumerate(sorted(set(lo) | set(hi) | set(x)))}
        r_lo, r_hi, r_x = (np.array([rank[a] for a in vals], np.int64) for vals in (lo, hi, x))
        inside &= (r_lo[None] <= r_x[:, None]) & (r_x[:, None] <= r_hi[None])
    return inside.sum(1)


def run_main_path(name, cfg, n, seed, tmp, kernels):
    """Drive ``bin.mesh.run`` once with the kernel counts zeroed just before
    and read just after; check the answer; return (run, launches, figures)."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.LAUNCHES = 0
    with open(os.path.join(tmp, f"{name}_events.jsonl"), "w") as out:
        run = mesh.run(cfg, n, device="cuda", seed=seed,
                       csv_path=os.path.join(tmp, f"{name}_hitters.csv"), out=out)
    launches = {kn: k.LAUNCHES for kn, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    res = run.result
    levels = len(run.leader.timings["expand"])
    phases = {k: float(np.sum(v)) for k, v in run.leader.timings.items()}
    H = res.paths.shape[0]
    log(f"crawl {name}: N={n} data_len={cfg.data_len} n_dims={cfg.n_dims} "
        f"levels={levels} hitters={H} sampling_s={run.seconds['sampling']:.3f} "
        f"keygen_s={run.seconds['keygen']:.3f} crawl_wall_s={run.seconds['crawl']:.3f} "
        f"clients_per_s={n / run.seconds['crawl']:.1f} "
        f"max_memory_allocated={peak} launches={launches} "
        f"host_phase_s={ {k: round(v, 4) for k, v in phases.items()} }")
    for kn, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{name}: kernel {kn} was never launched on the main path")
    if not 0 < H <= cfg.f_max:
        raise AssertionError(f"{name}: {H} hitters, want 1..f_max={cfg.f_max}")
    if res.paths.shape[1:] != (cfg.n_dims, cfg.data_len):
        raise AssertionError(f"{name}: hitter paths shaped {res.paths.shape}")
    thresh = max(1, int(cfg.threshold * n))
    if (res.counts < thresh).any():
        raise AssertionError(f"{name}: a hitter count is below the threshold {thresh}")
    want = plaintext_counts(run.points, cfg.ball_size, res.paths)
    if not np.array_equal(res.counts, want):
        bad = np.nonzero(res.counts != want)[0][:5]
        raise AssertionError(f"{name}: counts {res.counts[bad]} != plaintext {want[bad]}")
    log(f"crawl {name}: all {H} hitter counts equal the plaintext recount")
    return run, launches, {"n": n, "levels": levels, "hitters": H,
                           "seconds": run.seconds, "host_phase_s": phases,
                           "max_memory_allocated": peak,
                           "clients_per_s": n / run.seconds["crawl"]}


def profile_crawl(name, run, cfg, torch):
    """``--profile``: crawl the run's keys once more under ``torch.profiler``;
    report device time by kernel and the device's busy and idle share of the
    crawl (kernels run on one stream, so busy time is the sum of their times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = run.leader
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = lead.run(nreqs=run.points.shape[0], threshold=cfg.threshold)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not np.array_equal(res.paths, run.result.paths):
        raise AssertionError(f"{name}: profiled crawl disagrees with the main-path run")
    by_kernel = {}  # device-side events only: kernels, memcpys, memsets
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e6
    busy = float(sum(by_kernel.values()))
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    log(f"profile {name}: profiled_wall_s={wall:.4f} device_busy_s={busy:.4f} "
        f"idle_share={1.0 - busy / wall:.4f}")
    for k, v in top.items():
        log(f"  {v * 1e3:10.3f} ms  {k[:100]}")
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "device_s_by_kernel": top}


def check_keygen_chunk(kg, torch, rng):
    """Phase 2: keygen kernel vs plain on random alphas, both PRG bit modes."""
    K, L = KEYGEN_CHUNK
    seeds = torch.from_numpy(rng.integers(-2**31, 2**31, size=(K, 2, 4)).astype(np.int32)).cuda()
    alpha = torch.from_numpy(rng.integers(0, 2, size=(K, L)).astype(bool)).cuda()
    side = torch.from_numpy(np.tile([True, False], K // 2)).cuda()
    err = 0
    for derived in (False, True):
        got = kg.gen_cw(seeds, alpha, side, derived)
        want = kg.gen_cw_plain(seeds, alpha, side, derived)
        torch.cuda.synchronize()
        err = max(err, same(got, want, f"keygen chunk (derived_bits={derived})"))
    log(f"keygen chunk K={K} L={L}: kernel == plain in both PRG bit modes, max_abs_err={err}")
    return err


def expand_check(ex, args, want_children, derived, torch):
    """The expand kernel against its plain version on one frontier (the
    plain version on row slices); returns (max_abs_err, ms, plain_ms)."""
    seed, t, y, cws, cwf = args
    B = t.shape[1]
    got = ex.expand_packed(*args, derived, want_children)
    torch.cuda.synchronize()
    if not want_children and (got[1] is not None or got[2] is not None):
        raise AssertionError("expand built a child cache it was not asked for")
    err, plain_ms = 0, 0.0
    for lo in range(0, B, PLAIN_ROWS):
        hi = min(B, lo + PLAIN_ROWS)
        sl = (seed[..., lo:hi], t[:, lo:hi], y[:, lo:hi], cws, cwf)
        box = {}
        plain_ms += cuda_ms(lambda: box.update(
            w=ex.expand_packed_plain(*sl, derived, want_children, row0=lo)), 1)
        part = (got[0][lo:hi],)
        if want_children:
            part += (got[1][..., lo:hi], got[2][:, lo:hi])
        err = max(err, same(part, box["w"][:len(part)], f"expand rows [{lo}, {hi})"))
    del got
    ms = cuda_ms(lambda: ex.expand_packed(*args, derived, want_children), 5)
    return err, ms, plain_ms


def measure_expand(name, run, cfg, ex, collect, prg, torch):
    """Phase 4: re-crawl the run's keys level by level and hold the expand
    kernel against its plain version on server 0's frontier each time it
    reaches a new width, and at the last level (no child cache, as the
    crawl calls it there).  Returns the checks."""
    lead = run.leader
    L, n = lead.data_len, run.points.shape[0]
    lead.tree_init()
    widest, checks = 0, []
    for level in range(L):
        st = lead.server0.frontier.states
        d, _, F, N = st.bit.shape
        last = level == L - 1
        if F > widest or last:
            widest = max(widest, F)
            d2, B = 2 * d, F * N
            cws, cwf = collect.level_cw_planar(lead.server0.keys, level)
            args = (st.seed.reshape(4, d2, B), st.bit.reshape(d2, B),
                    st.y_bit.reshape(d2, B), cws, cwf)
            err, ms, plain_ms = expand_check(ex, args, not last, prg.DERIVED_BITS, torch)
            # read seed + t + y per (row, plane) and the cw planes once, write
            # packed per row and, with the child cache, 8 seed words + flags
            if last:
                nbytes = B * d2 * 18 + N * d2 + B * 4
                ops = B * d2 * (CHACHA8_WORD8_OPS if prg.DERIVED_BITS else 0)
            else:
                nbytes = B * d2 * (18 + 33) + N * d2 * 17 + B * 4
                ops = B * d2 * CHACHA8_OPS
            b_ms, b_by = bound(nbytes, ops)
            checks.append({"level": level, "F": F, "N": N, "d2": d2, "B": B,
                           "want_children": not last, "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            log(f"expand {name} level={level} F={F} N={N} d2={d2} want_children={not last}: "
                f"kernel == plain, max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
        if not last:
            lead.run_level(level, n, cfg.threshold)
    for s in (lead.server0, lead.server1):
        s.frontier = s.children = None
    return checks


def measure_keygen(name, points, cfg, kg, ibdcf, torch, rng):
    """Phase 5: keygen at a crawl's shape (all N clients x n_dims x 2 keys
    x L levels in one call): kernel vs plain, bit-exact, timed."""
    lo, hi = ibdcf.ball_bounds(points, cfg.ball_size)
    alpha = torch.from_numpy(np.stack([lo, hi], axis=-2).reshape(-1, cfg.data_len)).cuda()
    K, L = alpha.shape
    seeds = torch.from_numpy(rng.integers(-2**31, 2**31, size=(K, 2, 4)).astype(np.int32)).cuda()
    side = torch.from_numpy(np.tile([True, False], K // 2)).cuda()
    derived = ibdcf.prg.DERIVED_BITS
    ms = cuda_ms(lambda: kg.gen_cw(seeds, alpha, side, derived), 3)
    got = kg.gen_cw(seeds, alpha, side, derived)
    box = {}
    plain_ms = cuda_ms(lambda: box.update(w=kg.gen_cw_plain(seeds, alpha, side, derived)), 1)
    err = same(got, box["w"], f"keygen {name}")
    nbytes = K * 32 + K * L + K + K * L * (16 + 2 + 2)
    b_ms, b_by = bound(nbytes, K * L * 2 * CHACHA8_OPS)
    log(f"keygen {name} K={K} L={L}: kernel == plain, max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"K": K, "L": L, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--profile", action="store_true",
                    help="also crawl each cell once more under torch.profiler")
    ap.add_argument("--out", default=None, help="also write all figures to this JSON file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from fuzzyheavyhitters_torch.ops import cuda_build, expand_cuda, ibdcf, keygen_cuda, prg
    from fuzzyheavyhitters_torch.protocol import collect
    from fuzzyheavyhitters_torch.utils import config as configmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = cuda_build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in cuda_build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    errs = {"keygen": [check_keygen_chunk(keygen_cuda, torch, rng)], "expand": []}
    kernels = {"keygen": keygen_cuda, "expand": expand_cuda}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "config.json")) as f:
        rides_cfg = configmod.Config(**json.load(f))
    cells = {"config4_zipf": (configmod.Config(**CONFIG4), ZIPF_CLIENTS),
             "rides": (rides_cfg, RIDES_CLIENTS)}
    report = {"device": smi, "crawls": {}}
    points, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cfg, n) in cells.items():
            run, launches[name], fig = run_main_path(name, cfg, n, args.seed, tmp, kernels)
            if args.profile:
                fig["profile"] = profile_crawl(name, run, cfg, torch)
            fig["expand_checks"] = measure_expand(name, run, cfg, expand_cuda, collect,
                                                  prg, torch)
            errs["expand"] += [c["max_abs_err"] for c in fig["expand_checks"]]
            report["crawls"][name] = fig
            points[name] = run.points
            del run
            torch.cuda.empty_cache()
    for name, (cfg, _) in cells.items():
        kg = measure_keygen(name, points[name], cfg, keygen_cuda, ibdcf, torch, rng)
        report["crawls"][name]["keygen_check"] = kg
        errs["keygen"].append(kg["max_abs_err"])

    main4 = report["crawls"]["config4_zipf"]
    meas = {"keygen": main4["keygen_check"],
            "expand": max((c for c in main4["expand_checks"] if c["want_children"]),
                          key=lambda c: c["B"])}
    sources = {"keygen": ("fuzzyheavyhitters_torch/csrc/keygen.cu",
                          "fuzzyheavyhitters_tpu/ops/keygen_pallas.py:206"),
               "expand": ("fuzzyheavyhitters_torch/csrc/expand.cu",
                          "fuzzyheavyhitters_tpu/ops/expand_pallas.py:182")}
    rows = []
    for name in ("keygen", "expand"):
        m = meas[name]
        log(f"kernel {name}: ms={m['ms']:.4f} plain_ms={m['plain_ms']:.4f} "
            f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
            f"launches={launches['config4_zipf'][name]} "
            f"rides_launches={launches['rides'][name]} checks={len(errs[name])} "
            f"max_abs_err={max(errs[name])}")
        rows.append({"name": name, "route": "cuda", "source": sources[name][0],
                     "replaces": sources[name][1], "launches": launches["config4_zipf"][name],
                     "max_abs_err": max(errs[name]), "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": None})
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    log(f"chip_smoke wall_s={report['wall_s']:.1f} (build, checks and both crawls)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
