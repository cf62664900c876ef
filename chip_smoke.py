#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout, one card
    python3 chip_smoke.py --profile    # also: device time by kernel per crawl

Phases (any failure raises, and the script exits non-zero):

1. build every CUDA kernel of the port from ``fuzzyheavyhitters_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold the keygen kernel bit-exact against its plain PyTorch version on the
   card, in both PRG bit modes: a 4096-client x L=512 chunk, and a chunk of
   K = 8,191 keys x L = 509 levels, off the kernel's block and tile sizes;
3. the main path at full size, two crawls through ``bin.mesh.run`` with both
   servers on the card: the BASELINE.json config-4 shape (zipf over 10,000
   sites, exponent 1.03, data_len 512, n_dims 1, ball 2, threshold 0.001,
   f_max 1024) at N = 196,608 clients, and the ``configs/config.json`` rides
   shape (n_dims 2, data_len 16) at N = 262,144.  Kernel launch counts are
   zeroed just before each crawl and read just after; every hitter's count
   must equal a plaintext recount from the sampled points.  Then the trusted
   covid crawl of the JAX package's ``bench.bench_covid``: 64 hot counties
   written from the seed into a centroid file, jitterless f64 lat/lon bits
   (data_len 64, n_dims 2, ball 1, threshold 0.01, f_max 2048) at N = 65,536
   clients, through ``ibdcf.gen_l_inf_ball`` and ``driver.Leader``; every
   hot county with its 3 x 3 ulp ball (at least 576 hitters) must survive;
4. after each crawl (the secure ones of phase 6 too), the expand kernel
   held bit-exact against its plain version on that crawl's real
   frontiers, re-crawled from its keys with the trusted exchange (the
   same counts, so the same frontiers): each time the frontier reaches a
   new width (so at the widest), and at the last level, which builds no
   child cache; each check is timed;
5. the keygen kernel held bit-exact against its plain version at each of
   the six crawls' shapes (all N x n_dims x 2 keys, L levels) and timed;
6. the secure exchange through ``bin.mesh.run``: ``config4_zipf_secure``
   (the config-4 shape with ``secure_exchange``, S = 2 so the 1-of-2^S OT
   kernels, at N = 32,768 — half the JAX package's one-chip secure shape),
   ``rides_secure_gc`` (``configs/config.json`` with ``secure_exchange`` and
   ``ot_path: "gc"``, S = 4, the garbled-circuit kernels, N = 262,144) and
   ``rides_secure`` (that config with ``ot_path: "auto"``, S = 4 on the
   ot2s kernels, N = 65,536: the engine a user of the config gets).
   Launches must be one per level of the path's two kernels and none of the
   other path's; every hitter count must equal the plaintext recount;
7. after each secure crawl, its kernels held bit-exact against their plain
   versions on that crawl's real inputs, replayed from its keys and
   sessions (the trusted exchange carries the frontier between the checked
   levels): at the widest FE62 level and at the F255 last level, each timed;
8. chunk checks of 1,048,576 tests, the pad index starting at 2^32 - 1000 so
   it wraps inside the batch: ot2s at S in {2, 4, 6} and the GC kernels at
   S in {2, 4, 6, 8, 16}, each at W in {4, 8};
9. the socket deployment: two ``bin.server`` processes and a ``bin.leader``
   (``--seed``) as real OS processes on the card, started together on free
   localhost ports (server 0 and the leader dial with retries),
   for ``rides_socket`` (``configs/config.json``, trusted, N = 262,144) and
   ``rides_secure_socket`` (the same config with ``secure_exchange``, ot2s at
   S = 4, N = 65,536, whose in-process crawl ``rides_secure`` phase 6 runs
   through ``bin.mesh.run``).  The leaders run with ``FHH_SUPERVISE=0`` and
   ``FHH_WARMUP=0`` (``SOCKET_ENV``).  Each hitter count must equal the plaintext
   recount, the hitters must equal ``bin.mesh.run``'s for the same config,
   seed and N, and each server's ``server.exit`` line must show one expand
   launch per level and, secure, one ot2s encrypt per level it garbled and
   one decrypt per level it evaluated, with no GC launch.  A process that
   exits non-zero, prints a traceback or outlives its timeout fails the
   script.

10. ``config4_zipf_stream``: the config-4 shape at 196,608 clients through
    the streaming crawl of the JAX package's ``bench_crawl_hbm_max``:
    keygen in chunks of 32,768 clients on the card, landed level-major in
    host memory (``ibdcf.gen_l_inf_ball_host``), then ``driver.Leader(
    stream_chunk=32, stream_window=64, min_bucket=128)`` over those keys.  Its
    hitters must equal ``config4_zipf``'s and the plaintext recount, and
    expand must launch once per server per level plus once per advance
    chunk.  The expand kernel is held against its plain version on that
    path's new inputs (a window-sliced level's cw past the first window, a
    gathered 32-parent chunk with the child cache, the widest bucket), and
    keygen at the chunk's shape;
11. ``config4_zipf_resume``: the same streamed crawl checkpointing after
    level 255 (``checkpoint_every=256``) into the temporary directory,
    stopped there; a fresh ``Leader`` over the same host keys resumes it.
    Its hitters must equal phase 10's, and the file must be gone;
12. ``rides_socket_spans`` and ``rides_secure_socket_spans``: the two socket
    cells of phase 9 with ``crawl_shard_nodes: 8`` and
    ``crawl_pipeline_depth: 2`` (the secure one with ``secure_whole_level:
    false``).  Hitters must equal the unsplit runs' (so ``bin.mesh``'s) and
    the recount, each server must launch expand once per span and the ot2s
    kernels once per span it garbled or evaluated;
13. ``config4_zipf_radix3``: ``config4_zipf``'s keys (same seed) crawled
    through ``driver.Leader(radix=3)``, 170 fused rounds of 3 levels and a
    tail of 2; hitters equal ``config4_zipf``'s and the recount, expand
    launches 2 x 512 (r passes of the kernel per round and server), peak
    memory and crawl seconds beside ``config4_zipf``'s.  Server 0's whole
    fused level (radix word and child cache) built through the kernel is
    held against the same level built with the plain expand, at the widest
    round with a child cache and at the r = 2 tail round;
14. ``rides_socket_radix2``: ``rides_socket`` with ``crawl_radix_bits: 2``:
    8 crawl verbs and 16 expand launches per server, the hitters of
    ``bin.mesh`` and the recount, data-plane bytes and crawl seconds beside
    ``rides_socket``'s;
15. ``rides_secure_socket_radix2``: the same with ``secure_exchange`` and
    ``ot_path: "auto"`` at N = 16,384, so the garbled circuit at S' = 8: GC
    garble once per fused round a server garbled and eval once per round it
    evaluated (the garbler flips per round), no ot2s launch; the hitters of
    ``bin.mesh.run`` at the same config, seed and N (one level a round) and
    the recount;
16. ``rides_socket_radix2_warm``: phase 14 again, its leader ``bin.leader.run``
    in this process with the warmup (``FHH_WARMUP``'s default) over the
    buckets phase 14's crawl walked: each server must warm one shape per
    bucket and launch expand 4 times per shape (a full round with the child
    cache and the tail round, 2 levels each) besides the crawl's 16; the
    hitters must equal phase 14's; the warmup's seconds and the servers'
    peak memory and crawl seconds beside phase 14's;
17. ``rides_socket_supervised``: ``rides_socket`` under the leader's
    default, the supervised crawl (``FHH_SUPERVISE`` unset,
    ``FHH_CKPT_EVERY=4``, each server with a ``FHH_CKPT_DIR`` of its own):
    the hitters of phase 9 and the recount, 3 checkpoints a server (after
    the rounds ending at levels 4, 8 and 12), no recovery; the leader's
    seconds (reset, upload and rounds, and the rounds alone), each
    checkpoint's bytes and write seconds, each server's peak memory;
18. ``rides_socket_supervised_kill``: phase 17 with server 1 SIGKILLed as
    soon as its log shows its first checkpoint and started again at once on
    the same ports and directory: the hitters of phase 17, at least one
    recovery and one rollback, one restore in the new process at the
    leader's rollback level, the re-upload all of its 2,622 ``add_keys``
    chunks and none to server 0, expand launched once per crawl verb in
    each process (the restored frontier through the kernel); the seconds
    from the kill to ``resilience.restored``, the new process's start-up,
    the re-upload and the restore.  Then the restored blob is loaded in
    this process through ``rpc.CollectorServer.tree_restore`` on the card
    over rides' keys made again from the seed (``keys_fp`` must match) and
    expand is held against its plain version on that frontier;
19. ``rides_secure_socket_supervised_sever``: ``rides_secure`` (ot2s at S =
    4) at 16,384 clients, supervised as phase 17, the leader's link to
    server 0 through a ``ChaosProxy`` here that severs the answer of the
    first crawl verb after the first checkpoint, and server 1 killed and
    started again as in phase 18: the hitters of the in-process trusted
    ``driver.Leader`` on the same keys and the recount, server 0's replay
    dedup hits at least 1, the leader's client to it at epoch 2 or more, a
    recovery, the sever fired, and in each process one ot2s launch per
    crawl verb between the verbs it finished and those it began (the
    re-run levels included).

The shapes are fixed: there is no option to cut them.  Exact comparisons
throughout (tolerance 0: the system is bitwise).  Prints the card's name
and power limit, every check with its times against its bound, crawl
figures, the seconds each stage took, a ``{"kernels": [...]}`` line (each
kernel's launches in the crawl that runs it, its time at that crawl's
widest checked level; ``max_abs_err`` over every check of the kernel;
expand's row also carries its restored-frontier check), and
as its last line ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
# the secure config-4 cell runs half of bench.py's bench_secure_device shape
# (65,536 clients, about 155 s of crawl on the card), so that the script,
# with the radix cells, stays inside 600 s; the 1,048,576-test chunk checks
# keep the pad index's wrap past 2^32 covered
ZIPF_SECURE_CLIENTS = 32768
# bench.py:bench_covid's trusted covid crawl, at 8 x its 8,192 clients: about
# 1,024 clients per hot county
COVID = dict(
    data_len=64, n_dims=2, ball_size=1, addkey_batch_size=100, num_sites=64,
    threshold=0.01, zipf_exponent=1.03, server0="127.0.0.1:8000",
    server1="127.0.0.1:8001", distribution="covid", f_max=2048,
)
COVID_CLIENTS = 65536
# the secure socket cell's cut is forced by the wire: at the last level (F =
# 32, F255) the 1-of-16 table is 512 B a test, 4.3 GB a frame at 65,536
# clients, 17 GB at 262,144, held three or four times over in host memory
RIDES_SECURE_CLIENTS = 65536
SOCKET_START_S = 240  # seconds for a server to listen (torch import, CUDA init)
SOCKET_LEADER_S = 420  # seconds for a leader's whole run
KEYGEN_CHUNKS = ((4096 * 2, 512), (8191, 509))  # keys, levels
PLAIN_ROWS = 1 << 23  # rows per plain-expand slice: bounds its int64 temporaries
PLAIN_TESTS = 1 << 19  # tests per plain ot2s/GC slice
CHUNK_TESTS = 1 << 20  # tests of each chunk check
CHUNK_IDX0 = 2**32 - 1000  # the chunk checks' pad index wraps inside the batch
PROFILE_LEVELS = 8  # secure levels --profile traces per secure crawl
# bench.py:485-489 (bench_crawl_hbm_max): the streaming crawl's leader
STREAM = dict(stream_chunk=32, stream_window=64, min_bucket=128)
KEYGEN_HOST_CHUNK = 32768  # clients per keygen chunk landed in host memory (bench.py:469)
RESUME_EVERY = 256  # one checkpoint, after level 255 of 512
SPANS = dict(crawl_shard_nodes=8, crawl_pipeline_depth=2)
ZIPF_RADIX = 3  # phase 13: config4_zipf in rounds of 3 levels (170 and a tail of 2)
RIDES_RADIX = 2  # phase 14-15: rides over sockets in rounds of 2 levels (S' = 8 secure)
# phase 15's cut: a fused level carries 16 patterns of GC tests at about 512 B
# a test, where two radix-1 levels carry 2 x 4 patterns of ot2s tests at
# about 320 B; 16,384 clients move about the bytes of rides_secure_socket
RIDES_RADIX_SECURE_CLIENTS = 16384
# the socket leaders skip the warmup: its default ladder runs every bucket up
# to f_max = 1024, whose expansion alone (rides, 262,144 clients) needs about
# 55 GB per server, two servers on one card; phase 16 warms the buckets its
# crawl walks
SOCKET_ENV = {"FHH_WARMUP": "0"}
# phases 17-19: the supervised crawl (FHH_SUPERVISE unset) banking a checkpoint
# every 4 levels, after the rounds ending at levels 4, 8 and 12 of rides' 16
# (the JAX leader's default of 16 banks none there)
SUPERVISED_ENV = {"FHH_WARMUP": "0", "FHH_CKPT_EVERY": "4"}
CKPT_EVERY = 4
# phase 19's cut, for the script's time: rides_secure_socket's 65,536 clients
# took 51-74 s a stage
RIDES_SEVER_CLIENTS = 16384
PLAIN_COMPARE = 1 << 26  # elements per slice of a large kernel-vs-plain comparison

# every kernel of the port: (module, launch counter, source, TPU kernel it replaces)
KERNELS = {
    "keygen": ("keygen_cuda", "LAUNCHES", "fuzzyheavyhitters_torch/csrc/keygen.cu",
               "fuzzyheavyhitters_tpu/ops/keygen_pallas.py:206"),
    "expand": ("expand_cuda", "LAUNCHES", "fuzzyheavyhitters_torch/csrc/expand.cu",
               "fuzzyheavyhitters_tpu/ops/expand_pallas.py:182"),
    "ot2s_encrypt": ("otext_cuda", "ENC_LAUNCHES", "fuzzyheavyhitters_torch/csrc/ot2s.cu",
                     "fuzzyheavyhitters_tpu/ops/otext_pallas.py:214"),
    "ot2s_decrypt": ("otext_cuda", "DEC_LAUNCHES", "fuzzyheavyhitters_torch/csrc/ot2s.cu",
                     "fuzzyheavyhitters_tpu/ops/otext_pallas.py:259"),
    "gc_garble": ("gc_cuda", "GARBLE_LAUNCHES", "fuzzyheavyhitters_torch/csrc/gc.cu",
                  "fuzzyheavyhitters_tpu/ops/gc_pallas.py:279"),
    "gc_eval": ("gc_cuda", "EVAL_LAUNCHES", "fuzzyheavyhitters_torch/csrc/gc.cu",
                "fuzzyheavyhitters_tpu/ops/gc_pallas.py:336"),
}
# the wrapper of each secure kernel, as the protocol code calls it
WRAPPERS = {"ot2s_encrypt": ("otext_cuda", "enc_planar"),
            "ot2s_decrypt": ("otext_cuda", "dec_planar"),
            "gc_garble": ("gc_cuda", "garble_planar"),
            "gc_eval": ("gc_cuda", "eval_planar")}
OT2S, GC = ("ot2s_encrypt", "ot2s_decrypt"), ("gc_garble", "gc_eval")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def cuda_ms(fn, reps: int, warm: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs (CUDA events).
    ``warm`` runs it once untimed first, so that a kernel's output blocks are
    already in the caching allocator and no timed run waits on cudaMalloc
    (a check's plain slices in between leave the cache fragmented)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if warm:
        fn()
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
    [max(0, v - ball), min(2^L - 1, v + ball)] per dimension, in int64 up
    to L = 62 and in Python integers past it, where interval ends and
    hitters are ranked together, so the containment test is a vectorised
    comparison of ranks."""
    N, d, L = points.shape
    top = (1 << L) - 1
    inside = np.ones((paths.shape[0], N), bool)
    if L <= 62:
        w = np.int64(1) << np.arange(L - 1, -1, -1, dtype=np.int64)
        v, x = (points * w).sum(-1), (paths * w).sum(-1)  # [N, d], [H, d]
        for j in range(d):
            lo, hi = np.maximum(0, v[:, j] - ball), np.minimum(top, v[:, j] + ball)
            inside &= (lo[None] <= x[:, j, None]) & (x[:, j, None] <= hi[None])
        return inside.sum(1)
    for j in range(d):
        v, x = _ints(points[:, j]), _ints(paths[:, j])
        lo = [max(0, a - ball) for a in v]
        hi = [min(top, a + ball) for a in v]
        rank = {val: r for r, val in enumerate(sorted(set(lo) | set(hi) | set(x)))}
        r_lo, r_hi, r_x = (np.array([rank[a] for a in vals], np.int64) for vals in (lo, hi, x))
        inside &= (r_lo[None] <= r_x[:, None]) & (r_x[:, None] <= r_hi[None])
    return inside.sum(1)


def _ops(name):
    import importlib

    return importlib.import_module(f"fuzzyheavyhitters_torch.ops.{name}")


def _counter(kn):
    mod, attr, _, _ = KERNELS[kn]
    return _ops(mod), attr


def mesh_run(name, cfg, n, seed, tmp):
    """One collection through ``bin.mesh.run`` on the card."""
    from fuzzyheavyhitters_torch.bin import mesh

    with open(os.path.join(tmp, f"{name}_events.jsonl"), "w") as out:
        return mesh.run(cfg, n, device="cuda", seed=seed,
                        csv_path=os.path.join(tmp, f"{name}_hitters.csv"), out=out)


def covid_run(name, cfg, n, seed, tmp):
    """The JAX package's ``bench.bench_covid`` on the card: ``cfg.num_sites``
    hot counties written from the seed into a centroid file, jitterless
    points (clients of one county share one f64 pattern), keygen through
    ``ibdcf.gen_l_inf_ball`` and the trusted crawl through ``driver.Leader``."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver
    from fuzzyheavyhitters_torch.workloads import covid

    rng = np.random.default_rng(seed)
    cpath = os.path.join(tmp, f"{name}_centroids.csv")
    with open(cpath, "w") as f:
        f.write("fips_code,latitude,longitude\n")
        for i in range(cfg.num_sites):
            f.write(f"{10000 + i},{25 + 25 * rng.random():.4f},"
                    f"{-120 + 50 * rng.random():.4f}\n")
    seconds = {}
    t0 = time.perf_counter()
    pts = covid.sample_covid_locations(os.path.join(tmp, "absent.csv"), cpath, n,
                                       fuzz_factor=None, rng=rng)
    seconds["sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device="cuda")
    torch.cuda.synchronize()
    seconds["keygen"] = time.perf_counter() - t0
    lead = driver.Leader(*driver.make_servers(k0, k1), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max)
    del k0, k1
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    torch.cuda.synchronize()
    seconds["crawl"] = time.perf_counter() - t0
    return mesh.MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def run_main_path(name, cfg, n, seed, tmp, per_level, drive, min_hitters):
    """Drive one collection (``drive``: ``mesh_run`` or ``covid_run``) with
    every kernel count zeroed just before and read just after; check the
    answer; return (run, launches, figures).  keygen and expand must launch;
    the kernels in ``per_level`` once per level; every other kernel never."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    for kn in KERNELS:
        setattr(*_counter(kn), 0)
    run = drive(name, cfg, n, seed, tmp)
    launches = {kn: getattr(*_counter(kn)) for kn in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    res = run.result
    levels = len(run.leader.timings["expand"])
    # expand, count, advance on the host clock; the secure phases as spans of
    # the device stream (Leader.timings)
    phases = {k: float(np.sum(v)) for k, v in run.leader.timings.items()}
    consumed = ([s.consumed for s in run.leader.secure.snd]
                if run.leader.secure is not None else None)
    H = res.paths.shape[0]
    log(f"crawl {name}: N={n} data_len={cfg.data_len} n_dims={cfg.n_dims} "
        f"secure={cfg.secure_exchange} ot_path={cfg.ot_path} "
        f"levels={levels} hitters={H} sampling_s={run.seconds['sampling']:.3f} "
        f"keygen_s={run.seconds['keygen']:.3f} crawl_wall_s={run.seconds['crawl']:.3f} "
        f"clients_per_s={n / run.seconds['crawl']:.1f} "
        f"max_memory_allocated={peak} launches={launches} "
        f"phase_s={ {k: round(v, 4) for k, v in phases.items()} }"
        + (f" ot_consumed_per_session={consumed}" if consumed is not None else ""))
    for kn, c in launches.items():
        want = levels if kn in per_level else None
        if kn in ("keygen", "expand") and c <= 0:
            raise AssertionError(f"{name}: kernel {kn} was never launched on the main path")
        if kn not in ("keygen", "expand") and c != (want or 0):
            raise AssertionError(f"{name}: kernel {kn} launched {c} times, want {want or 0}")
    if not min_hitters <= H <= cfg.f_max:
        raise AssertionError(f"{name}: {H} hitters, want {min_hitters}..f_max={cfg.f_max}")
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
                           "seconds": run.seconds, "phase_s": phases,
                           "max_memory_allocated": peak, "ot_consumed": consumed,
                           "clients_per_s": n / run.seconds["crawl"]}


def replay(lead, n, threshold, secure_levels, each=None):
    """Crawl the leader's keys once more, level by level: the secure
    exchange at ``secure_levels`` (on the leader's own OT sessions), the
    trusted one elsewhere, which gives the same counts and so carries the
    same frontier.  ``each(level, before)`` runs around every level."""
    sessions = lead.secure
    try:
        lead.tree_init()
        for level in range(lead.data_len):
            lead.secure = sessions if level in secure_levels else None
            if each:
                each(level, True)
            lead.run_level(level, n, threshold)
            if each:
                each(level, False)
    finally:
        lead.secure = sessions
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None


def profile_crawl(name, run, cfg, torch, window=None):
    """``--profile``: crawl the run's keys once more under ``torch.profiler``;
    report device time by kernel and the device's busy and idle share of the
    crawl (kernels run on one stream, so busy time is the sum of their times).
    A secure crawl profiles the secure levels in ``window`` of a replay (a
    whole 512-level secure crawl is millions of launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = run.leader
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    if window is None:
        with prof:
            t0 = time.perf_counter()
            res = lead.run(nreqs=run.points.shape[0], threshold=cfg.threshold)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if not np.array_equal(res.paths, run.result.paths):
            raise AssertionError(f"{name}: profiled crawl disagrees with the main-path run")
    else:
        clock = {}

        def each(level, before):
            if before and level == window[0]:
                torch.cuda.synchronize()
                prof.start()
                clock["t0"] = time.perf_counter()
            if not before and level == window[-1]:
                torch.cuda.synchronize()
                clock["wall"] = time.perf_counter() - clock["t0"]
                prof.stop()

        replay(lead, run.points.shape[0], cfg.threshold, set(window), each)
        wall = clock["wall"]
    by_kernel = {}  # device-side events only: kernels, memcpys, memsets
    runtime = {}  # host-side CUDA runtime calls: (count, host seconds)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e6
        elif ev.key.startswith("cuda"):
            runtime[ev.key] = (ev.count, ev.cpu_time_total / 1e6)
    busy = float(sum(by_kernel.values()))
    ours = {k: v for k, v in by_kernel.items() if "fhh_" in k}
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    span = "whole crawl" if window is None else f"secure levels {window[0]}..{window[-1]}"
    log(f"profile {name} ({span}): profiled_wall_s={wall:.4f} device_busy_s={busy:.4f} "
        f"idle_share={1.0 - busy / wall:.4f} port_kernels_s={sum(ours.values()):.4f} "
        f"plain_pytorch_s={busy - sum(ours.values()):.4f}")
    for k, v in top.items():
        log(f"  {v * 1e3:10.3f} ms  {k[:100]}")
    for k, v in ours.items():
        if k not in top:
            log(f"  {v * 1e3:10.3f} ms  {k[:100]}")
    runtime = dict(sorted(runtime.items(), key=lambda kv: -kv[1][1])[:8])
    log("  host CUDA runtime calls: " + ", ".join(
        f"{k} n={n} {s:.4f} s" for k, (n, s) in runtime.items()))
    return {"span": span, "profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "port_kernels_s": sum(ours.values()),
            "device_s_by_kernel": top, "port_kernel_s_by_name": ours,
            "host_cuda_runtime": runtime}


def free_ports():
    """(port0, port1) free on localhost with port1 + 1 free too: server 1's
    data plane listens there."""
    import socket

    while True:
        with socket.socket() as a, socket.socket() as b, socket.socket() as c:
            a.bind(("127.0.0.1", 0))
            p1 = a.getsockname()[1]
            try:
                b.bind(("127.0.0.1", p1 + 1))
            except OSError:
                continue
            c.bind(("127.0.0.1", 0))
            return c.getsockname()[1], p1


def _events(path) -> list:
    """The JSON event lines of a log (a line still being written is left
    for the next read)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{") and line.endswith("\n")]


def _wait_event(path, event, proc, timeout):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if any(e["event"] == event for e in _events(path)):
            return
        if proc.poll() is not None:
            with open(path) as f:
                raise AssertionError(f"{path}: exited {proc.returncode} before {event}:\n"
                                     f"{f.read()[-3000:]}")
        time.sleep(0.1)
    raise AssertionError(f"{path}: no {event} within {timeout} s")


def _chaos_proxy(spec, target_port):
    """A ``resilience.chaos.ChaosProxy`` with the fault ``spec`` in front of
    localhost ``target_port``, on an event loop of its own in a thread (the
    leader it serves is another process).  Returns (proxy, stop)."""
    import asyncio
    import threading

    from fuzzyheavyhitters_torch.resilience.chaos import ChaosProxy, parse_faults

    box, ready = {}, threading.Event()

    async def serve():
        box["loop"], box["stop"] = asyncio.get_running_loop(), asyncio.Event()
        box["proxy"] = await ChaosProxy("127.0.0.1", free_ports()[0], "127.0.0.1", target_port,
                                        parse_faults(spec), link="ctl0").start()
        ready.set()
        await box["stop"].wait()
        await box["proxy"].stop()

    th = threading.Thread(target=asyncio.run, args=(serve(),), daemon=True)
    th.start()
    if not ready.wait(30):
        raise AssertionError(f"the chaos proxy did not start: {box}")

    def stop():
        box["loop"].call_soon_threadsafe(box["stop"].set)
        th.join(30)

    return box["proxy"], stop


def socket_run(name, cfg, n, seed, tmp, env=None, warm_buckets=None, supervise=False,
               kill=False, ctl0_faults=None):
    """Phase 9: ``bin.server --server_id 1``, ``--server_id 0`` and ``bin.leader
    --seed`` started together as OS processes (on the card unless
    ``cfg.backend`` is ``"cpu"``; server 0 and the leader dial with retries,
    after start-ups at least as long as the servers'), in the working
    directory ``tmp/name``; SIGTERM to the servers after the leader's exit.
    The leader runs with ``FHH_SUPERVISE=0`` (the unsupervised crawl) unless
    ``supervise``: then the variable is unset, the JAX leader's default,
    and each server gets a checkpoint directory of its own
    (``FHH_CKPT_DIR``); ``env`` adds variables to the processes'
    environment.  With ``kill`` server 1 is SIGKILLed as soon as its log
    shows its first ``resilience.server_checkpoint`` and started again at
    once on the same ports and directory; the blob the new process restores
    is copied aside (``restored_blob``), since later checkpoints prune it.
    With ``ctl0_faults`` the leader reaches server 0 through a
    ``ChaosProxy`` with that fault spec, in this process.  With
    ``warm_buckets`` the leader is ``bin.leader.run`` in this process once
    both servers serve, in the environment its process would have, its
    events written to its log as the process's are, and its warmup over
    those buckets.  Every process must exit 0 without a
    traceback inside its timeout, but the killed one, which must exit -9;
    all are killed in a ``finally``.  Returns the leader's and the servers'
    events and the working directory."""
    import asyncio
    import contextlib
    import shutil
    import signal
    import threading

    p0, p1 = free_ports()
    work = os.path.join(tmp, name)
    os.makedirs(work)
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(dataclasses.asdict(cfg), server0=f"127.0.0.1:{p0}",
                       server1=f"127.0.0.1:{p1}"), f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "FHH_SUPERVISE": "0", **(env or {}),
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    if supervise:
        del env["FHH_SUPERVISE"]
    ckpt = {sid: os.path.join(work, f"ckpt{sid}") for sid in (0, 1)}
    procs, logs = {}, {who: os.path.join(work, f"{who}.log")
                       for who in ("server0", "server1", "leader")}
    leader_cfg = cfg_path
    stop_proxy = proxy = None

    device = "cpu" if cfg.backend == "cpu" else "cuda"

    def spawn(who, mod, *args, config=cfg_path, extra=None):
        with open(logs[who], "w") as out:
            procs[who] = subprocess.Popen(
                [sys.executable, "-m", f"fuzzyheavyhitters_torch.bin.{mod}", "--config",
                 config, "--device", device, *args], cwd=work, env={**env, **(extra or {})},
                stdout=out, stderr=subprocess.STDOUT)
        return time.time()

    def spawn_server(sid):
        extra = {"FHH_CKPT_DIR": ckpt[sid]} if supervise else None
        return spawn(f"server{sid}", "server", "--server_id", str(sid), extra=extra)

    killed, done = {}, threading.Event()

    def killer():
        """SIGKILL server 1 at its first checkpoint, start it again, and
        copy the blob the new process restores."""
        while not done.is_set():
            if any(e["event"] == "resilience.server_checkpoint" for e in _events(logs["server1"])):
                break
            time.sleep(0.01)
        else:
            return
        old = procs["server1"]
        old.kill()
        killed["t_kill"] = time.time()
        killed["rc"] = old.wait()
        killed["log"] = os.path.join(work, "server1_killed.log")
        os.replace(logs["server1"], killed["log"])
        killed["t_spawn"] = spawn_server(1)
        while not done.is_set():
            ev = [e for e in _events(logs["server1"]) if e["event"] == "resilience.server_restore"]
            if ev:
                lvl = ev[0]["level"]
                killed["restored_blob"] = os.path.join(work, f"restored_l{lvl}.npz")
                shutil.copyfile(os.path.join(ckpt[1], f"fhh_server1_l{lvl}.npz"),
                                killed["restored_blob"])
                return
            time.sleep(0.01)

    rcs = {}
    killer_th = None
    try:
        for sid in (1, 0):
            spawn_server(sid)
        if ctl0_faults is not None:
            proxy, stop_proxy = _chaos_proxy(ctl0_faults, p0)
            leader_cfg = os.path.join(work, "leader.json")
            with open(leader_cfg, "w") as f:
                json.dump(dict(dataclasses.asdict(cfg), server0=f"127.0.0.1:{proxy.listen_port}",
                               server1=f"127.0.0.1:{p1}"), f)
        if kill:
            killer_th = threading.Thread(target=killer, daemon=True)
            killer_th.start()
        t0 = time.perf_counter()
        if warm_buckets is None:
            spawn("leader", "leader", "-n", str(n), "--seed", str(seed), config=leader_cfg)
            rcs["leader"] = procs["leader"].wait(timeout=SOCKET_LEADER_S)
        else:
            import torch

            from fuzzyheavyhitters_torch.bin import leader
            from fuzzyheavyhitters_torch.utils import config as configmod

            for who in ("server0", "server1"):
                _wait_event(logs[who], "server.serving", procs[who], SOCKET_START_S)
            t0 = time.perf_counter()
            here, saved = os.getcwd(), dict(os.environ)
            os.chdir(work)  # the rides CSV lands under the working directory
            os.environ.clear()  # the environment the leader's process would have
            os.environ.update(env)
            try:
                with open(logs["leader"], "w") as out, contextlib.redirect_stdout(out):
                    asyncio.run(leader.run(configmod.load_config(leader_cfg), n,
                                           torch.device(device), seed, warm_buckets))
            finally:
                os.chdir(here)
                os.environ.clear()
                os.environ.update(saved)
            rcs["leader"] = 0
        wall = time.perf_counter() - t0
        done.set()
        if killer_th is not None:
            killer_th.join(60)
        for who in ("server0", "server1"):
            procs[who].send_signal(signal.SIGTERM)
            rcs[who] = procs[who].wait(timeout=60)
    finally:
        done.set()
        if stop_proxy is not None:
            stop_proxy()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if kill and killed.get("rc") != -signal.SIGKILL:
        raise AssertionError(f"{name}: server 1 was not killed at a checkpoint: {killed}")
    if "log" in killed:
        with open(killed["log"]) as f:
            if "Traceback" in f.read():
                raise AssertionError(f"{name}: the killed server 1 printed a traceback")
    for who, path in logs.items():
        with open(path) as f:
            text = f.read()
        if rcs.get(who) != 0 or "Traceback" in text:
            raise AssertionError(f"{name}: {who} exited {rcs.get(who)}:\n{text[-3000:]}")
    ev = {who: _events(path) for who, path in logs.items()}
    if "log" in killed:
        ev["server1_killed"] = _events(killed["log"])
    one = lambda who, event: next((e for e in ev[who] if e["event"] == event), None)
    return {"work": work, "wall_s": wall, "crawl": one("leader", "crawl.done"),
            "warmup": one("leader", "warmup.done"),
            "addkeys": one("leader", "addkeys.done"), "keygen": one("leader", "keygen"),
            "hitters": [e for e in ev["leader"] if e["event"] == "hitter"],
            "exits": [one(f"server{sid}", "server.exit") for sid in (0, 1)],
            "events": ev, "killed": killed, "proxy_fired": proxy.fired if proxy else None}


def _recount(name, got, cfg, points):
    """Every hitter count against the plaintext recount from the points."""
    vals = np.array([json.loads(v) for v in got], np.int64).reshape(len(got), cfg.n_dims)
    paths = ((vals[..., None] >> np.arange(cfg.data_len - 1, -1, -1)) & 1).astype(bool)
    want = plaintext_counts(points, cfg.ball_size, paths)
    if not np.array_equal(np.array(list(got.values())), want):
        raise AssertionError(f"{name}: counts {list(got.values())} != plaintext {want}")


def check_socket_run(name, run, cfg, points, mesh_hitters, mesh_crawl_s, per_level):
    """Phase 9's (and 12's, 14's, 15's) checks: the hitters equal
    ``bin.mesh.run``'s and every count the plaintext recount; each server
    ran one crawl verb per round (of ``crawl_radix_bits`` levels) or per
    node span of it, launched expand once per level of each verb, and, with
    ``per_level`` (the ot2s or the GC pair), the garbling kernel once per
    verb of a round it garbled (round index % 2 == its id) and the other
    once per verb of a round it evaluated; no other kernel.  After a
    (trusted) warmup each server must also report one shape per warmed
    bucket and span size, and launch expand once per level of the rounds
    ``rpc.CollectorServer._warm_bucket`` runs at each shape."""
    from fuzzyheavyhitters_torch.protocol import collect

    L, k = cfg.data_len, cfg.crawl_radix_bits
    bases = list(range(0, L, k))
    buckets = run["crawl"]["buckets"]
    whole = cfg.secure_exchange and cfg.secure_whole_level
    spans = [1 if whole else len(collect.shard_spans(b, cfg.crawl_shard_nodes))
             for b in buckets]
    if len(spans) != len(bases):
        raise AssertionError(f"{name}: the leader crawled {len(spans)} rounds, "
                             f"want {len(bases)}")
    got = {e["value"]: e["count"] for e in run["hitters"]}
    if got != mesh_hitters:
        raise AssertionError(f"{name}: socket hitters {got} != bin.mesh's {mesh_hitters}")
    _recount(name, got, cfg, points)
    launches = {}
    verbs = sum(spans)
    passes = sum(n * min(k, L - lv) for n, lv in zip(spans, bases))
    warm = run["warmup"]
    if warm is not None:
        if per_level:
            raise AssertionError(f"{name}: the launch check counts a trusted warmup only")
        shapes = sum(len({hi - lo for lo, hi in collect.shard_spans(b, cfg.crawl_shard_nodes)}
                         | {b}) for b in set(warm["f_buckets"]))
        if warm["shapes"] != [shapes, shapes]:
            raise AssertionError(f"{name}: the servers warmed {warm['shapes']} shapes, want "
                                 f"{shapes} each")
        base_last = k * ((L - 1) // k)  # a full round with the cache, and the tail round
        passes += shapes * (min(k, L) if base_last == 0 else k + L - base_last)
    for sid, ex in enumerate(run["exits"]):
        garbled = sum(n for i, n in enumerate(spans) if i % 2 == sid)
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = passes
        if per_level:
            want_l.update({per_level[0]: garbled, per_level[1]: verbs - garbled})
        if ex["launches"] != want_l or ex["levels"] != verbs:
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{ex['levels']} crawl verbs, want {want_l} over {verbs}")
        launches[f"server{sid}"] = ex["launches"]
        log(f"socket {name} server{sid}: data_bytes_sent={ex['data_bytes_sent']} "
            f"data_bytes_recv={ex['data_bytes_recv']} data_frame_max={ex['data_frame_max']} "
            f"control_bytes_recv="
            f"{ex['control_bytes_recv']} control_bytes_sent={ex['control_bytes_sent']} "
            f"phase_s={ {k: round(v, 4) for k, v in ex['seconds'].items()} } "
            f"launches={ex['launches']}")
    log(f"socket {name}: N={points.shape[0]} hitters={len(got)} (= bin.mesh's, each = the "
        f"plaintext recount) crawl_s={run['crawl']['seconds']:.3f} bin.mesh crawl_s="
        f"{mesh_crawl_s:.3f} addkeys_s={run['addkeys']['seconds']:.3f} keygen_s="
        f"{run['keygen']['seconds']:.3f} leader_wall_s={run['wall_s']:.3f} "
        f"crawl_verbs_per_server={verbs} radix={k} pipeline={run['crawl']['pipeline']}")
    return {"n": int(points.shape[0]), "hitters": len(got), "hitter_map": got, "crawl_s": run["crawl"]["seconds"],
            "mesh_crawl_s": mesh_crawl_s, "addkeys_s": run["addkeys"]["seconds"],
            "keygen_s": run["keygen"]["seconds"], "leader_wall_s": run["wall_s"],
            "launches": launches, "servers": run["exits"], "crawl_verbs": verbs,
            "pipeline": run["crawl"]["pipeline"], "radix": k,
            "data_bytes_sent": [ex["data_bytes_sent"] for ex in run["exits"]],
            "data_frame_max": [ex["data_frame_max"] for ex in run["exits"]],
            "max_memory_allocated": [ex["max_memory_allocated"] for ex in run["exits"]],
            "buckets": buckets, "warmup": warm}


def check_supervised_run(name, run, cfg, want_hitters, points, per_level=()):
    """Phases 17-19's checks of a supervised socket run (faults or none):
    the hitters ``want_hitters`` and the plaintext recount; each server
    process launched expand once per crawl verb it began and, with
    ``per_level`` (the ot2s pair), one of the pair per verb between the
    verbs it finished and the verbs it began (a verb cut on the plane may
    fail before or after its kernel), no other kernel; after a kill the
    restarted server 1 restored once, at the leader's restored level, and
    re-uploads alone: ``add_keys`` chunks of all clients to it, none again
    to server 0.  Returns the figures."""
    got = {e["value"]: e["count"] for e in run["hitters"]}
    if got != want_hitters:
        raise AssertionError(f"{name}: hitters {got} != {want_hitters}")
    _recount(name, got, cfg, points)
    crawl, ev = run["crawl"], run["events"]
    if not crawl["supervised"]:
        raise AssertionError(f"{name}: the leader ran the unsupervised crawl")
    chunks = -(-points.shape[0] // cfg.addkey_batch_size)
    servers = []
    for sid, ex in enumerate(run["exits"]):
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = ex["levels"]
        want_l.update({kn: ex["launches"][kn] for kn in per_level})
        pair = sum(ex["launches"][kn] for kn in per_level)
        if ex["launches"] != want_l or (per_level and not
                                        ex["levels_done"] <= pair <= ex["levels"]):
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{ex['levels']} crawl verbs begun, {ex['levels_done']} done")
        if ex["add_keys"] != chunks:
            raise AssertionError(f"{name}: server {sid} took {ex['add_keys']} add_keys "
                                 f"chunks, want {chunks}")
        ckpts = [e for e in ev[f"server{sid}"] if e["event"] == "resilience.server_checkpoint"]
        servers.append({k: ex[k] for k in (
            "boot_id", "levels", "levels_done", "launches", "dedup_hits", "plane_resets",
            "ckpt_writes", "ckpt_bytes", "ckpt_write_s", "restores", "restore_s",
            "data_bytes_sent", "data_bytes_recv", "data_frame_max", "max_memory_allocated")})
        servers[-1]["checkpoints"] = [{k: e[k] for k in ("level", "bytes", "seconds")}
                                      for e in ckpts]
    fig = {"n": int(points.shape[0]), "hitters": len(got), "hitter_map": got,
           "crawl_s": crawl["seconds"], "seconds_by_part": crawl["seconds_by_part"],
           "counters": {k: crawl[k] for k in ("recoveries", "levels_rerun", "shards_rerun",
                                              "crawl_checkpoints", "pipeline_faults")},
           "epochs": crawl["epochs"], "buckets": crawl["buckets"], "servers": servers,
           "launches": {f"server{sid}": ex["launches"] for sid, ex in enumerate(run["exits"])},
           "keygen_s": run["keygen"]["seconds"], "leader_wall_s": run["wall_s"]}
    killed = run["killed"]
    if killed:
        restored = [e for e in ev["leader"] if e["event"] == "resilience.restored"]
        restores = [e for e in ev["server1"] if e["event"] == "resilience.server_restore"]
        if len(restores) != 1 or restores[0]["level"] != restored[-1]["level"]:
            raise AssertionError(f"{name}: the new server 1 restored {restores}, the leader "
                                 f"rolled back to {restored}")
        new_ev = {e["event"]: e for e in ev["server1"]}
        fig["recovery"] = {
            "restored_level": restored[-1]["level"],
            "kill_to_restored_s": restored[-1]["t"] - killed["t_kill"],
            "startup_to_plane_listening_s": new_ev["server.plane_listening"]["t"]
            - killed["t_spawn"],
            "startup_to_serving_s": new_ev["server.serving"]["t"] - killed["t_spawn"],
            "leader_probe_s": restored[-1]["probe_s"],
            "leader_reupload_s": restored[-1]["reupload_s"],
            "leader_restore_s": restored[-1]["restore_s"],
            "server1_restore_s": restores[0]["seconds"],
            "recover_s": crawl["seconds_by_part"]["recover"]}
    log(f"supervised {name}: N={points.shape[0]} hitters={len(got)} (as wanted, each = the "
        f"plaintext recount) crawl_s={crawl['seconds']:.3f} by part="
        f"{ {k: round(v, 3) for k, v in crawl['seconds_by_part'].items()} } counters="
        f"{fig['counters']} epochs={crawl['epochs']} recovery={fig.get('recovery')}")
    for sid, sv in enumerate(servers):
        log(f"supervised {name} server{sid}: " + " ".join(
            f"{k}={sv[k]}" for k in ("levels", "levels_done", "launches", "dedup_hits",
                                     "plane_resets", "ckpt_writes", "ckpt_bytes",
                                     "ckpt_write_s", "restores", "restore_s", "data_bytes_sent",
                                     "max_memory_allocated", "checkpoints")))
    return fig


def restored_expand_check(name, run, cfg, n, seed, ex, collect, prg, torch):
    """Phase 18's check of the restored route into the expand kernel: the
    blob server 1 restored, loaded in this process through
    ``rpc.CollectorServer.tree_restore`` on the card over rides' keys made
    again from the seed (its ``keys_fp`` must equal the blob's), then
    expand held against its plain version on that frontier at the round
    the crawl resumed with."""
    import asyncio

    from fuzzyheavyhitters_torch.bin import leader
    from fuzzyheavyhitters_torch.protocol import rpc

    blob = run["killed"]["restored_blob"]
    with np.load(blob) as z:
        level, blob_fp = int(z["level"]), z["keys_fp"]
    _, _, keys1, _ = leader.client_keys(cfg, n, torch.device("cuda"), seed)
    ckdir = os.path.join(os.path.dirname(blob), "restored_check")
    os.makedirs(ckdir)
    os.link(blob, os.path.join(ckdir, f"fhh_server1_l{level}.npz"))
    srv = rpc.CollectorServer(1, cfg, "cuda", ckpt_dir=ckdir)

    async def restore():
        await srv.add_keys({"keys": tuple(keys1), "sketch": None})
        return await srv.tree_restore({"level": level})

    asyncio.run(restore())
    if not np.array_equal(srv._keys_fp(), blob_fp):
        raise AssertionError(f"{name}: the regenerated keys' keys_fp != the blob's")
    nxt = level + srv.crawl_radix(level)
    last = nxt + srv.crawl_radix(nxt) == cfg.data_len
    st = srv.frontier.states
    if st.seed.device.type != "cuda":
        raise AssertionError(f"{name}: the restored frontier is on {st.seed.device}")
    d, _, F, N = st.bit.shape
    d2, B = 2 * d, F * N
    cws, cwf = collect.level_cw_planar(srv.keys, nxt)
    args = (st.seed.reshape(4, d2, B), st.bit.reshape(d2, B), st.y_bit.reshape(d2, B), cws, cwf)
    err, ms, plain_ms = expand_check(ex, args, not last, prg.DERIVED_BITS, torch)
    b_ms, b_by = expand_bound(B, N, d2, not last, prg.DERIVED_BITS)
    check = {"kind": "restored", "restored_level": level, "level": nxt, "F": F, "N": N,
             "d2": d2, "B": B, "want_children": not last, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "blob_bytes": os.path.getsize(blob)}
    log(f"expand {name} restored from the level-{level} blob ({check['blob_bytes']} B, keys_fp = "
        f"the blob's), level={nxt} F={F} N={N} d2={d2} want_children={not last}: kernel == "
        f"plain, max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by})")
    del srv, keys1
    torch.cuda.empty_cache()
    return check


def check_keygen_chunks(kg, torch, rng):
    """Phase 2: keygen kernel vs plain on random alphas and sides, both PRG
    bit modes, at each of KEYGEN_CHUNKS."""
    err = 0
    for K, L in KEYGEN_CHUNKS:
        seeds = torch.from_numpy(
            rng.integers(-2**31, 2**31, size=(K, 2, 4)).astype(np.int32)).to("cuda")
        alpha = torch.from_numpy(rng.integers(0, 2, size=(K, L)).astype(bool)).to("cuda")
        side = torch.from_numpy(rng.integers(0, 2, size=K).astype(bool)).to("cuda")
        for derived in (False, True):
            got = kg.gen_cw(seeds, alpha, side, derived)
            want = kg.gen_cw_plain(seeds, alpha, side, derived)
            torch.cuda.synchronize()
            err = max(err, same(got, want, f"keygen chunk K={K} L={L} (derived_bits={derived})"))
        log(f"keygen chunk K={K} L={L}: kernel == plain in both PRG bit modes, "
            f"max_abs_err={err}")
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
    ms = cuda_ms(lambda: ex.expand_packed(*args, derived, want_children), 5, warm=True)
    return err, ms, plain_ms


def expand_bound(B, N, d2, want_children, derived):
    """Least time of one expansion of B rows: read seed + t + y per (row,
    plane) and the cw planes once, write packed per row and, with the child
    cache, 8 seed words + flags; hash a whole ChaCha8 block per (row,
    plane) with the cache, without it only what word 8 needs."""
    if not want_children:
        return bound(B * d2 * 18 + N * d2 + B * 4,
                     B * d2 * (CHACHA8_WORD8_OPS if derived else 0))
    return bound(B * d2 * (18 + 33) + N * d2 * 17 + B * 4, B * d2 * CHACHA8_OPS)


def measure_expand(name, run, cfg, ex, collect, prg, torch):
    """Phase 4: re-crawl the run's keys level by level and hold the expand
    kernel against its plain version on server 0's frontier each time it
    reaches a new width, and at the last level (no child cache, as the
    crawl calls it there).  A secure crawl is replayed with the trusted
    exchange, which gives the same counts and so the same frontiers.
    Returns the checks."""
    lead = run.leader
    L, n = lead.data_len, run.points.shape[0]
    sessions, lead.secure = lead.secure, None
    try:
        return _expand_checks(name, lead, L, n, cfg, ex, collect, prg, torch)
    finally:
        lead.secure = sessions
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None


def _expand_checks(name, lead, L, n, cfg, ex, collect, prg, torch):
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
            b_ms, b_by = expand_bound(B, N, d2, not last, prg.DERIVED_BITS)
            checks.append({"level": level, "F": F, "N": N, "d2": d2, "B": B,
                           "want_children": not last, "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            log(f"expand {name} level={level} F={F} N={N} d2={d2} want_children={not last}: "
                f"kernel == plain, max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
        if not last:
            lead.run_level(level, n, cfg.threshold)
    return checks


def radix_run(name, cfg, n, seed, tmp, tail):
    """Phase 13: ``bin.mesh``'s sampling and keygen on the card (the same
    seed gives ``config4_zipf``'s keys), then the trusted crawl through
    ``driver.Leader(radix=cfg.crawl_radix_bits)``.  Keeps in ``tail`` the
    tail round's level and server 0's input frontier, which the round
    itself drops, for :func:`measure_radix`."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver
    from fuzzyheavyhitters_torch.workloads import sample_points

    rng = np.random.default_rng(seed)
    seconds = {}
    t0 = time.perf_counter()
    pts = sample_points(cfg, n, rng)
    seconds["sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device="cuda")
    torch.cuda.synchronize()
    seconds["keygen"] = time.perf_counter() - t0
    lead = driver.Leader(*driver.make_servers(k0, k1), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max, radix=cfg.crawl_radix_bits)
    del k0, k1
    step = lead.run_level

    def keep_tail(level, nreqs, threshold):
        if level + min(lead.radix, lead.data_len - level) == lead.data_len:
            tail.update(level=level, frontier=lead.server0.frontier)
        return step(level, nreqs, threshold)

    lead.run_level = keep_tail
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    torch.cuda.synchronize()
    seconds["crawl"] = time.perf_counter() - t0
    del lead.run_level
    return mesh.MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def same_sliced(got, want, what: str) -> int:
    """``same`` over paired tensors too large for its int64 copies, in
    slices of PLAIN_COMPARE elements."""
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: kernel {list(a.shape)} != plain {list(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for lo in range(0, a.numel(), PLAIN_COMPARE):
            hi = lo + PLAIN_COMPARE
            err = max(err, same((a[lo:hi],), (b[lo:hi],), f"{what} elements [{lo}, {hi})"))
    return err


def radix_check(name, keys, fr, level, r, want_children, ex, collect, prg, torch):
    """The fused level at ``level`` (r passes) of one server's ``keys`` from
    its frontier ``fr``, built twice: through the expand kernel, as the
    crawl builds it, and with the kernel replaced by its plain version on
    row slices; the radix word and the child cache of one against the
    other.  Times the fused level, its r kernel launches alone (CUDA events
    around each), and the plain build."""
    d, _, F, N = fr.states.bit.shape
    d2 = 2 * d
    orig = ex.expand_packed
    marks = []

    def timed(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig(*a)
        ev[1].record()
        marks.append(ev)
        return out

    def plain(seed, t, y, cws, cwf, derived, wc):
        B = t.shape[1]
        out = (torch.empty(B, dtype=torch.int32, device=t.device),
               torch.empty((2, 4, d2, B), dtype=torch.int32, device=t.device) if wc else None,
               torch.empty((d2, B), dtype=torch.uint8, device=t.device) if wc else None)
        for lo in range(0, B, PLAIN_ROWS):
            hi = min(B, lo + PLAIN_ROWS)
            p, sd, fl = ex.expand_packed_plain(seed[..., lo:hi], t[:, lo:hi], y[:, lo:hi],
                                               cws, cwf, derived, wc, row0=lo)
            out[0][lo:hi] = p
            if wc:
                out[1][..., lo:hi] = sd
                out[2][:, lo:hi] = fl
        return out

    build = lambda: collect.expand_share_bits_radix(keys, fr, level, r, want_children)
    flat = lambda w: (w[0],) if w[1] is None else (w[0], w[1].seed, w[1].flags)
    ex.expand_packed = timed
    try:
        got = flat(build())
    finally:
        ex.expand_packed = orig
    torch.cuda.synchronize()
    kernel_ms = sum(a.elapsed_time(b) for a, b in marks)
    box = {}
    ex.expand_packed = plain
    try:
        plain_ms = cuda_ms(lambda: box.update(w=flat(build())), 1)
    finally:
        ex.expand_packed = orig
    err = same_sliced(got, box.pop("w"), f"radix expand {name} level={level} r={r}")
    del got
    ms = cuda_ms(build, 3, warm=True)
    bounds = [expand_bound(F * N << t, N, d2, want_children or t + 1 < r, prg.DERIVED_BITS)
              for t in range(r)]
    b_ms = sum(b for b, _ in bounds)
    b_by = "+".join(by for _, by in bounds)
    log(f"radix expand {name} level={level} r={r} F={F} N={N} d2={d2} "
        f"want_children={want_children}: kernel == plain (radix word"
        f"{' and child cache' if want_children else ''}), max_abs_err={err} ms={ms:.4f} "
        f"kernel_ms={kernel_ms:.4f} ({r} launches) plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    return {"level": level, "r": r, "F": F, "N": N, "d2": d2, "want_children": want_children,
            "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def measure_radix(name, run, cfg, tail, ex, collect, prg, torch):
    """Phase 13's kernel checks: server 0's fused level held against its
    plain build (``radix_check``) at the tail round, from the frontier
    ``radix_run`` kept in ``tail``, and at the widest round with a child
    cache, re-crawled from the keys up to that round only."""
    lead = run.leader
    L, k, n = lead.data_len, lead.radix, run.points.shape[0]
    keys = lead.server0.keys
    checks = [radix_check(name, keys, tail.pop("frontier"), tail["level"], L - tail["level"],
                          False, ex, collect, prg, torch)]
    checks[0]["kind"] = "tail"
    torch.cuda.empty_cache()
    bases = list(range(0, L, k))
    inner = lead.buckets[:-1]
    widest = bases[inner.index(max(inner))]
    lead.tree_init()
    try:
        for level in bases[:bases.index(widest)]:
            lead.run_level(level, n, cfg.threshold)
        checks.insert(0, radix_check(name, keys, lead.server0.frontier, widest, k, True, ex,
                                     collect, prg, torch))
        checks[0]["kind"] = "widest"
    finally:
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None
    return checks


def measure_keygen(name, points, cfg, kg, ibdcf, torch, rng):
    """Phase 5: keygen at a crawl's shape (all N clients x n_dims x 2 keys
    x L levels in one call): kernel vs plain, bit-exact, timed."""
    lo, hi = ibdcf.ball_bounds(points, cfg.ball_size)
    alpha = torch.from_numpy(np.stack([lo, hi], axis=-2).reshape(-1, cfg.data_len)).to("cuda")
    K, L = alpha.shape
    seeds = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(K, 2, 4)).astype(np.int32)).to("cuda")
    side = torch.from_numpy(np.tile([True, False], K // 2)).to("cuda")
    derived = ibdcf.prg.DERIVED_BITS
    ms = cuda_ms(lambda: kg.gen_cw(seeds, alpha, side, derived), 3, warm=True)
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


PLAIN = {"ot2s_encrypt": ("otext_cuda", "enc_planar_plain"),
         "ot2s_decrypt": ("otext_cuda", "dec_planar_plain"),
         "gc_garble": ("gc", "garble_planar_plain"),
         "gc_eval": ("gc", "eval_planar_plain")}


def secure_shape(kn, args):
    """(S, W, bp) of one call of a secure kernel's wrapper."""
    if kn == "ot2s_encrypt":
        return args[1].shape[0], args[2].shape[0], args[0].shape[1]
    if kn == "ot2s_decrypt":
        S = args[1].shape[0]
        return S, args[2].shape[0] >> S, args[0].shape[1]
    if kn == "gc_garble":
        return args[3].shape[0], args[5].shape[0], args[1].shape[1]
    return args[0].shape[0] // 4, args[4].shape[0] // 2, args[0].shape[1]


def secure_bound(kn, S, W, bp):
    """Least time for one call: the bytes it must move — each input plane
    read once, except that of the ciphertext slots a test holds (2^S for
    ot2s, 2 for GC) it reads only the one it opens; each output plane
    written once — and the ChaCha8 blocks it must hash."""
    if kn == "ot2s_encrypt":
        nbytes, blocks = bp * (16 * S + 4 * S + 8 * W + (1 << S) * 4 * W), bp * (1 << S)
    elif kn == "ot2s_decrypt":
        nbytes, blocks = bp * (16 * S + 4 * S + 4 * W + 4 * W), bp
    elif kn == "gc_garble":
        nbytes = bp * (32 * S + 4 * S + 4 + 8 * W + 32 * (S - 1) + 16 * S + 4 + 8 * W)
        blocks = bp * (4 * (S - 1) + 2)
    else:
        nbytes = bp * (32 * S + 32 * (S - 1) + 4 + 4 * W + 4 + 4 * W)
        blocks = bp * (2 * (S - 1) + 1)
    return bound(nbytes, blocks * CHACHA8_OPS)


def _slice(kn, args, lo, hi):
    """One call's arguments cut to tests [lo, hi): every plane by column,
    the pad index moved to test lo."""
    head, planes = (args[:1], args[1:-1]) if kn == "gc_garble" else ((), args[:-1])
    if kn == "ot2s_encrypt":
        planes, tail = planes[:4], (planes[4],)  # the offsets are per choice, not per test
    else:
        tail = ()
    return head + tuple(a[:, lo:hi] for a in planes) + tail + (args[-1] + lo,)


def secure_check(kn, args, got, kernel, what, reps=3):
    """A secure kernel's output on one call against its plain version on
    slices of PLAIN_TESTS tests, and the kernel timed on the same inputs."""
    S, W, bp = secure_shape(kn, args)
    plain = getattr(_ops(PLAIN[kn][0]), PLAIN[kn][1])
    outs = got if isinstance(got, tuple) else (got,)
    err, plain_ms = 0, 0.0
    for lo in range(0, bp, PLAIN_TESTS):
        hi = min(bp, lo + PLAIN_TESTS)
        sl, box = _slice(kn, args, lo, hi), {}
        plain_ms += cuda_ms(lambda: box.update(w=plain(*sl)), 1)
        want = box["w"] if isinstance(box["w"], tuple) else (box["w"],)
        err = max(err, same(tuple(o[:, lo:hi] for o in outs), want,
                            f"{kn} {what} tests [{lo}, {hi})"))
    ms = cuda_ms(lambda: kernel(*args), reps, warm=True)
    b_ms, b_by = secure_bound(kn, S, W, bp)
    log(f"{kn} {what} S={S} W={W} bp={bp} idx0={args[-1]}: kernel == plain, "
        f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"what": what, "S": S, "W": W, "bp": bp, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def measure_secure(name, run, cfg, kns, torch):
    """Replay a secure crawl from its keys and sessions and hold each of its
    kernels against the plain version on the inputs the crawl gives it: at
    the widest FE62 level and at the F255 last level.  Between those levels
    the trusted exchange carries the frontier (it gives the same counts).
    The wrappers are wrapped to keep those calls' inputs and outputs."""
    lead = run.leader
    L, n = lead.data_len, run.points.shape[0]
    widest = max(lead.buckets[:-1])
    levels = {lead.buckets.index(widest): "widest_fe62", L - 1: "last_f255"}
    orig = {kn: getattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1]) for kn in kns}
    kept, on = {}, [False]

    def keeping(kn):
        def call(*a):
            out = orig[kn](*a)
            if on[0]:
                kept[kn] = (a, out)
            return out
        return call

    checks = []

    def each(level, before):
        on[0] = before and level in levels
        if before or level not in levels:
            return
        for kn in kns:
            a, out = kept.pop(kn)
            c = secure_check(kn, a, out, orig[kn], f"{name} level={level} "
                             f"({levels[level]}, F={lead.buckets[level]})")
            c.update(kernel=kn, level=level, kind=levels[level])
            checks.append(c)
            del a, out
        torch.cuda.empty_cache()

    for kn in kns:
        setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], keeping(kn))
    try:
        replay(lead, n, cfg.threshold, set(levels), each)
    finally:
        for kn in kns:
            setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], orig[kn])
    return checks


def stream_run(name, cfg, n, seed, tmp):
    """Phase 10: ``bench.py``'s streaming crawl on the card.  Sampling draws
    from ``default_rng(seed)`` as ``bin.mesh`` does; keygen runs in chunks
    of KEYGEN_HOST_CHUNK clients, each landed in host memory (timed with
    the copies); the peak memory counter is reset just before the crawl."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver
    from fuzzyheavyhitters_torch.workloads import sample_points

    rng = np.random.default_rng(seed)
    seconds = {}
    t0 = time.perf_counter()
    pts = sample_points(cfg, n, rng)
    seconds["sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h0, h1 = ibdcf.gen_l_inf_ball_host(pts, cfg.ball_size, rng, device="cuda",
                                       chunk=KEYGEN_HOST_CHUNK)
    torch.cuda.synchronize()
    seconds["keygen"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    lead = driver.Leader(*driver.make_servers(h0, h1, "cuda"), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max, **STREAM)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    torch.cuda.synchronize()
    seconds["crawl"] = time.perf_counter() - t0
    return mesh.MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def stream_launches(buckets, chunk):
    """Expand launches of a streamed crawl over ``buckets`` (one per level):
    per server, the level's expansion, and at each inner level one per
    advance chunk of the next bucket (the whole bucket when the chunk does
    not tile it)."""
    per = 0
    for level, F in enumerate(buckets):
        per += 1
        if level + 1 < len(buckets):
            F2 = buckets[level + 1]
            c = min(F2, chunk)
            per += F2 // c if F2 % c == 0 else 1
    return 2 * per


def measure_stream_expand(name, run, cfg, ex, prg, torch):
    """Phase 10's kernel checks: replay the streamed crawl level by level,
    keep server 0's expand calls of three kinds and hold each against the
    plain version: the level expansion at the first level of the second
    window (its cw sliced from an uploaded window), the first advance chunk
    (gathered parents, child cache) at the level before the widest inner
    bucket, and the level expansion at the widest bucket."""
    lead = run.leader
    b = lead.buckets
    L = lead.data_len
    want = {"window_slice": (lead.stream_window, False),
            "gathered_chunk": (max(range(L - 1), key=lambda lv: (b[lv + 1], -lv)), True),
            "widest_bucket": (b.index(max(b)), False)}
    kept, level_now = {}, [0]
    orig = ex.expand_packed

    def keeping(*a):
        for kind, key in want.items():
            if key == (level_now[0], a[-1]) and kind not in kept:
                kept[kind] = a
        return orig(*a)

    ex.expand_packed = keeping
    try:
        lead.tree_init()
        for level in range(L):
            level_now[0] = level
            lead.run_level(level, run.points.shape[0], cfg.threshold)
    finally:
        ex.expand_packed = orig
    checks = []
    for kind, (level, wc) in want.items():
        args = kept.pop(kind)[:5]
        d2, B = args[1].shape
        N = args[4].shape[1]
        err, ms, plain_ms = expand_check(ex, args, wc, prg.DERIVED_BITS, torch)
        b_ms, b_by = expand_bound(B, N, d2, wc, prg.DERIVED_BITS)
        checks.append({"kind": kind, "level": level, "F": B // N, "N": N, "d2": d2, "B": B,
                       "want_children": wc, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        log(f"expand {name} {kind} level={level} F={B // N} N={N} d2={d2} "
            f"want_children={wc}: kernel == plain, max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        del args
    return checks


class _Stopped(Exception):
    """Raised after the resume phase's checkpoint to stop its crawl there."""


def resume_run(name, run, cfg, tmp, want_hitters):
    """Phase 11: the streamed crawl of ``run``'s host keys, checkpointed
    after level RESUME_EVERY - 1 and stopped; a fresh leader over the same
    keys resumes it.  Returns its figures."""
    import torch

    from fuzzyheavyhitters_torch.protocol import driver

    keys = (run.leader.server0.keys, run.leader.server1.keys)
    n = run.points.shape[0]
    path = os.path.join(tmp, f"{name}.npz")
    fig = {}

    def leader():
        return driver.Leader(*driver.make_servers(*keys, "cuda"), n_dims=cfg.n_dims,
                             data_len=cfg.data_len, f_max=cfg.f_max, **STREAM)

    first = leader()
    write = first.checkpoint

    def checkpoint(*a):
        t0 = time.perf_counter()
        first._key_fingerprint()
        fig["fingerprint_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write(*a)
        fig["write_s"] = time.perf_counter() - t0
        fig["level"] = a[1]
        raise _Stopped

    first.checkpoint = checkpoint
    t0 = time.perf_counter()
    try:
        first.run(nreqs=n, threshold=cfg.threshold, checkpoint_path=path,
                  checkpoint_every=RESUME_EVERY)
        raise AssertionError(f"{name}: the crawl wrote no checkpoint")
    except _Stopped:
        pass
    fig["first_s"] = time.perf_counter() - t0
    fig["bytes"] = os.path.getsize(path)
    del first
    torch.cuda.empty_cache()
    second = leader()
    restore = second.restore

    def timed_restore(*a):
        t0 = time.perf_counter()
        second._key_fingerprint()
        t1 = time.perf_counter()
        out = restore(*a)
        torch.cuda.synchronize()
        fig["restore_fingerprint_s"], fig["restore_s"] = t1 - t0, time.perf_counter() - t1
        return out

    second.restore = timed_restore
    t0 = time.perf_counter()
    res = second.run(nreqs=n, threshold=cfg.threshold, checkpoint_path=path,
                     checkpoint_every=RESUME_EVERY, resume=True)
    torch.cuda.synchronize()
    fig["resumed_s"] = time.perf_counter() - t0
    fig["levels_resumed"] = len(second.timings["expand"])
    got = {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
    if got != want_hitters:
        raise AssertionError(f"{name}: resumed hitters differ from the streamed crawl's")
    if os.path.exists(path) or os.path.exists(path + ".tmp"):
        raise AssertionError(f"{name}: the completed crawl left its checkpoint behind")
    if fig["level"] != RESUME_EVERY - 1 or fig["levels_resumed"] != cfg.data_len - RESUME_EVERY:
        raise AssertionError(f"{name}: checkpoint after level {fig['level']}, "
                             f"{fig['levels_resumed']} levels resumed")
    log(f"resume {name}: checkpoint after level {fig['level']} bytes={fig['bytes']} "
        f"fingerprint_s={fig['fingerprint_s']:.3f} write_s={fig['write_s']:.3f} "
        f"restore_s={fig['restore_s']:.3f} (its fingerprint "
        f"{fig['restore_fingerprint_s']:.3f} s) crawl_to_checkpoint_s={fig['first_s']:.3f} "
        f"resumed_crawl_s={fig['resumed_s']:.3f} levels_resumed={fig['levels_resumed']} "
        f"hitters={len(got)} (= the streamed crawl's); the file is gone")
    return fig


def chunk_checks(torch, seed):
    """Every secure kernel on CHUNK_TESTS random tests with the pad index
    starting at CHUNK_IDX0, so the u32 index wraps inside the batch."""
    oc, gcc = _ops("otext_cuda"), _ops("gc_cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = CHUNK_TESTS
    words = lambda r: torch.randint(-2**31, 2**31, (r, n), dtype=torch.int32,
                                    device="cuda", generator=g)
    bits = lambda r: torch.randint(0, 2, (r, n), dtype=torch.int32, device="cuda", generator=g)
    checks = {kn: [] for kn in OT2S + GC}
    for S in (2, 4, 6):
        for W in (4, 8):
            offs = torch.randint(-2**31, 2**31, (1 << S, 4), dtype=torch.int32,
                                 device="cuda", generator=g)
            a = (words(4 * S), bits(S), words(W), words(W), offs, CHUNK_IDX0)
            cts = oc.enc_planar(*a)
            checks["ot2s_encrypt"].append(secure_check("ot2s_encrypt", a, cts,
                                                       oc.enc_planar, "chunk", 1))
            a = (words(4 * S), bits(S), cts, CHUNK_IDX0)
            checks["ot2s_decrypt"].append(secure_check("ot2s_decrypt", a, oc.dec_planar(*a),
                                                       oc.dec_planar, "chunk", 1))
    for S in (2, 4, 6, 8, 16):
        for W in (4, 8):
            R = [int(v) for v in torch.randint(0, 2**32, (4,), generator=torch.Generator()
                                               .manual_seed(seed + S + W))]
            R[0] |= 1
            a = (R, words(4 * S), words(4 * S), bits(S), bits(1), words(W), words(W),
                 CHUNK_IDX0)
            tab, gbl, dec, cts = gcc.garble_planar(*a)
            checks["gc_garble"].append(secure_check("gc_garble", a, (tab, gbl, dec, cts),
                                                    gcc.garble_planar, "chunk", 1))
            a = (gbl, words(4 * S), tab, dec, cts, CHUNK_IDX0)
            checks["gc_eval"].append(secure_check("gc_eval", a, gcc.eval_planar(*a),
                                                  gcc.eval_planar, "chunk", 1))
            del tab, gbl, dec, cts, a
    return checks


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
    stage_s, clock = {}, [time.perf_counter()]

    def stage(what):
        """Log and keep the seconds since the previous stage ended."""
        now = time.perf_counter()
        stage_s[what] = now - clock[0]
        log(f"stage {what}: {stage_s[what]:.1f} s")
        clock[0] = now

    libs = cuda_build.build()
    log(f"built {sorted(libs)}")
    stage("build")
    for name in libs:
        for line in cuda_build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    errs = {kn: [] for kn in KERNELS}
    errs["keygen"].append(check_keygen_chunks(keygen_cuda, torch, rng))
    stage("keygen_chunk")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "config.json")) as f:
        rides_raw = json.load(f)
    # name: (config, clients, kernels launched once per level, driver, least
    # hitters); covid wants every hot county and its 3 x 3 ulp ball
    covid_cfg = configmod.Config(**COVID)
    cells = {
        "config4_zipf": (configmod.Config(**CONFIG4), ZIPF_CLIENTS, (), mesh_run, 1),
        "rides": (configmod.Config(**rides_raw), RIDES_CLIENTS, (), mesh_run, 1),
        "config4_zipf_secure": (configmod.Config(**CONFIG4, secure_exchange=True,
                                                 ot_path="auto"), ZIPF_SECURE_CLIENTS, OT2S,
                                mesh_run, 1),
        "rides_secure_gc": (configmod.Config(**dict(rides_raw, secure_exchange=True,
                                                    ot_path="gc")), RIDES_CLIENTS, GC,
                            mesh_run, 1),
        "rides_secure": (configmod.Config(**dict(rides_raw, secure_exchange=True,
                                                 ot_path="auto")), RIDES_SECURE_CLIENTS, OT2S,
                         mesh_run, 1),
        "covid": (covid_cfg, COVID_CLIENTS, (), covid_run, covid_cfg.num_sites * 9),
    }
    # phase 9: socket cell -> the in-process cell of the same config, seed and N
    sockets = {"rides_socket": "rides", "rides_secure_socket": "rides_secure"}
    report = {"device": smi, "crawls": {}, "sockets": {}, "stage_s": stage_s}
    points, launches, hitters = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cfg, n, per_level, drive, min_hitters) in cells.items():
            run, launches[name], fig = run_main_path(name, cfg, n, args.seed, tmp,
                                                     per_level, drive, min_hitters)
            stage(f"{name} crawl")
            if args.profile:
                window = None
                if per_level:  # PROFILE_LEVELS secure levels from the widest FE62 one
                    w0 = run.leader.buckets.index(max(run.leader.buckets[:-1]))
                    window = list(range(w0, min(cfg.data_len, w0 + PROFILE_LEVELS)))
                fig["profile"] = profile_crawl(name, run, cfg, torch, window)
                stage(f"{name} profile")
            if per_level:
                fig["secure_checks"] = measure_secure(name, run, cfg, per_level, torch)
                for c in fig["secure_checks"]:
                    errs[c["kernel"]].append(c["max_abs_err"])
                stage(f"{name} secure checks")
            fig["expand_checks"] = measure_expand(name, run, cfg, expand_cuda, collect,
                                                  prg, torch)
            errs["expand"] += [c["max_abs_err"] for c in fig["expand_checks"]]
            points[name] = run.points
            hitters[name] = {str(row.tolist()): int(c) for row, c in
                             zip(run.result.decode_ints(), run.result.counts)}
            stage(f"{name} expand checks")
            report["crawls"][name] = fig
            del run
            torch.cuda.empty_cache()
        # phase 13: config4_zipf's keys crawled in fused rounds of ZIPF_RADIX levels
        name = "config4_zipf_radix3"
        cfg_r = dataclasses.replace(cells["config4_zipf"][0], crawl_radix_bits=ZIPF_RADIX)
        tail = {}
        run, launches[name], fig = run_main_path(name, cfg_r, ZIPF_CLIENTS, args.seed, tmp, (),
                                                 functools.partial(radix_run, tail=tail), 1)
        got = {str(row.tolist()): int(c) for row, c in
               zip(run.result.decode_ints(), run.result.counts)}
        if got != hitters["config4_zipf"]:
            raise AssertionError(f"{name}: hitters differ from config4_zipf's")
        # r passes of the kernel per fused round and server: 2 x data_len
        want_ex, rounds = 2 * cfg_r.data_len, -(-cfg_r.data_len // ZIPF_RADIX)
        if launches[name]["expand"] != want_ex or len(run.leader.buckets) != rounds:
            raise AssertionError(f"{name}: {launches[name]['expand']} expand launches over "
                                 f"{len(run.leader.buckets)} rounds, want {want_ex} over {rounds}")
        main4 = report["crawls"]["config4_zipf"]
        log(f"radix {name}: hitters={len(got)} (= config4_zipf's, each = the plaintext recount) "
            f"rounds={rounds} crawl_s={run.seconds['crawl']:.3f} (config4_zipf: "
            f"{main4['seconds']['crawl']:.3f}) max_memory_allocated={fig['max_memory_allocated']} "
            f"(config4_zipf: {main4['max_memory_allocated']}) expand_launches="
            f"{launches[name]['expand']} (= {want_ex}) buckets_max={max(run.leader.buckets)}")
        stage(f"{name} crawl")
        if args.profile:
            fig["profile"] = profile_crawl(name, run, cfg_r, torch)
            stage(f"{name} profile")
        fig["radix_checks"] = measure_radix(name, run, cfg_r, tail, expand_cuda, collect, prg,
                                            torch)
        errs["expand"] += [c["max_abs_err"] for c in fig["radix_checks"]]
        stage(f"{name} checks")
        report["crawls"][name] = fig
        del run
        torch.cuda.empty_cache()
        # phases 10-11: the streamed config-4 crawl from host keys, and its resume
        name, cfg4 = "config4_zipf_stream", cells["config4_zipf"][0]
        run, launches[name], fig = run_main_path(name, cfg4, ZIPF_CLIENTS, args.seed, tmp,
                                                 (), stream_run, 1)
        lead = run.leader
        got = {str(row.tolist()): int(c) for row, c in
               zip(run.result.decode_ints(), run.result.counts)}
        if got != hitters["config4_zipf"]:
            raise AssertionError(f"{name}: hitters differ from config4_zipf's")
        want_ex = stream_launches(lead.buckets, STREAM["stream_chunk"])
        want_kg = -(-ZIPF_CLIENTS // KEYGEN_HOST_CHUNK)
        if launches[name]["expand"] != want_ex or launches[name]["keygen"] != want_kg:
            raise AssertionError(f"{name}: launches {launches[name]}, want expand={want_ex} "
                                 f"keygen={want_kg}")
        keys = (lead.server0.keys, lead.server1.keys)
        # the parties share their correction words: count each tensor once
        fig["host_key_bytes"] = sum(t.nbytes for t in {id(t): t for k in keys for t in k}.values())
        log(f"stream {name}: hitters={len(got)} (= config4_zipf's, each = the plaintext "
            f"recount) keygen_s={run.seconds['keygen']:.3f} (chunks of {KEYGEN_HOST_CHUNK} "
            f"into host memory) crawl_s={run.seconds['crawl']:.3f} host_key_bytes="
            f"{fig['host_key_bytes']} max_memory_allocated={fig['max_memory_allocated']} "
            f"(cached config4_zipf: "
            f"{report['crawls']['config4_zipf']['max_memory_allocated']}) "
            f"expand_launches={launches[name]['expand']} (= {want_ex}) "
            f"buckets_max={max(lead.buckets)}")
        stage(f"{name} crawl")
        if args.profile:
            fig["profile"] = profile_crawl(name, run, cfg4, torch)
            stage(f"{name} profile")
        fig["stream_checks"] = measure_stream_expand(name, run, cfg4, expand_cuda, prg, torch)
        errs["expand"] += [c["max_abs_err"] for c in fig["stream_checks"]]
        kg = measure_keygen(f"{name} chunk", run.points[:KEYGEN_HOST_CHUNK], cfg4, keygen_cuda,
                            ibdcf, torch, rng)
        fig["keygen_check"] = kg
        errs["keygen"].append(kg["max_abs_err"])
        stage(f"{name} checks")
        fig["resume"] = resume_run("config4_zipf_resume", run, cfg4, tmp, got)
        stage("config4_zipf_resume")
        report["crawls"][name] = fig
        del run, lead, keys
        torch.cuda.empty_cache()
        for name, cell in sockets.items():
            cfg, n, per_level = cells[cell][0], cells[cell][1], cells[cell][2]
            run = socket_run(name, cfg, n, args.seed, tmp, SOCKET_ENV)
            report["sockets"][name] = check_socket_run(
                name, run, cfg, points[cell], hitters[cell],
                report["crawls"][cell]["seconds"]["crawl"], per_level)
            stage(f"{name} socket run")
        # phase 12: the same socket cells crawled in node spans, pipelined
        for base in list(sockets):
            name, cell = f"{base}_spans", sockets[base]
            cfg, n, per_level = cells[cell][0], cells[cell][1], cells[cell][2]
            extra = dict(SPANS, **({"secure_whole_level": False} if cfg.secure_exchange else {}))
            cfg = dataclasses.replace(cfg, **extra)
            run = socket_run(name, cfg, n, args.seed, tmp, SOCKET_ENV)
            rep = check_socket_run(name, run, cfg, points[cell], hitters[cell],
                                   report["crawls"][cell]["seconds"]["crawl"], per_level)
            whole = report["sockets"][base]
            if rep["hitter_map"] != whole["hitter_map"]:
                raise AssertionError(f"{name}: hitters differ from {base}'s")
            log(f"spans {name}: {extra} hitters = {base}'s; data_frame_max={rep['data_frame_max']}"
                f" ({base}: {whole['data_frame_max']}) crawl_s={rep['crawl_s']:.3f} ({base}: "
                f"{whole['crawl_s']:.3f}) crawl_verbs_per_server={rep['crawl_verbs']} "
                f"pipeline={rep['pipeline']}")
            report["sockets"][name] = rep
            stage(f"{name} socket run")
        # phases 14-15: rides over sockets in fused rounds of RIDES_RADIX levels
        rides_cfg = cells["rides"][0]
        radix_sockets = {
            "rides_socket_radix2": (
                dataclasses.replace(rides_cfg, crawl_radix_bits=RIDES_RADIX), RIDES_CLIENTS, (),
                "rides_socket"),
            "rides_secure_socket_radix2": (
                dataclasses.replace(rides_cfg, secure_exchange=True, ot_path="auto",
                                    crawl_radix_bits=RIDES_RADIX),
                RIDES_RADIX_SECURE_CLIENTS, GC, "rides_secure_socket"),
        }
        for name, (cfg, n, per_level, base) in radix_sockets.items():
            if n == RIDES_CLIENTS:  # the rides cell: bin.mesh at this config, seed and N
                pts, want_h = points["rides"], hitters["rides"]
                mesh_s = report["crawls"]["rides"]["seconds"]["crawl"]
            else:  # bin.mesh at this config, seed and N, which crawls one level a round
                mrun = mesh_run(f"{name}_mesh", cfg, n, args.seed, tmp)
                res = mrun.result
                if len(mrun.leader.timings["expand"]) != cfg.data_len:
                    raise AssertionError(f"{name}: bin.mesh crawled "
                                         f"{len(mrun.leader.timings['expand'])} rounds")
                if not np.array_equal(res.counts, plaintext_counts(mrun.points, cfg.ball_size,
                                                                   res.paths)):
                    raise AssertionError(f"{name}: bin.mesh counts != the plaintext recount")
                pts, mesh_s = mrun.points, mrun.seconds["crawl"]
                want_h = {str(row.tolist()): int(c) for row, c in
                          zip(res.decode_ints(), res.counts)}
                del mrun, res
                torch.cuda.empty_cache()
            run = socket_run(name, cfg, n, args.seed, tmp, SOCKET_ENV)
            rep = check_socket_run(name, run, cfg, pts, want_h, mesh_s, per_level)
            whole = report["sockets"][base]
            log(f"radix {name}: crawl_radix_bits={RIDES_RADIX} N={n} hitters = bin.mesh's; "
                f"crawl_verbs_per_server={rep['crawl_verbs']} ({base}: {whole['crawl_verbs']}) "
                f"data_bytes_sent={rep['data_bytes_sent']} ({base} at N={whole['n']}: "
                f"{whole['data_bytes_sent']}) data_frame_max={rep['data_frame_max']} "
                f"crawl_s={rep['crawl_s']:.3f} ({base}: {whole['crawl_s']:.3f})")
            report["sockets"][name] = rep
            stage(f"{name} socket run")
        # phase 16: phase 14 again, its leader warming the buckets that crawl walked
        name, base = "rides_socket_radix2_warm", "rides_socket_radix2"
        cfg, cold = radix_sockets[base][0], report["sockets"][base]
        run = socket_run(name, cfg, RIDES_CLIENTS, args.seed, tmp,
                         warm_buckets=sorted(set(cold["buckets"])))
        if run["warmup"] is None:
            raise AssertionError(f"{name}: the leader ran no warmup (FHH_WARMUP=0 is set)")
        rep = check_socket_run(name, run, cfg, points["rides"], hitters["rides"],
                               report["crawls"]["rides"]["seconds"]["crawl"], ())
        if rep["hitter_map"] != cold["hitter_map"]:
            raise AssertionError(f"{name}: hitters differ from {base}'s")
        log(f"warmup {name}: f_buckets={run['warmup']['f_buckets']} shapes="
            f"{run['warmup']['shapes']} warmup_s={run['warmup']['seconds']:.3f} hitters = "
            f"{base}'s; crawl_s={rep['crawl_s']:.3f} ({base}, no warmup: {cold['crawl_s']:.3f}) "
            f"server max_memory_allocated={rep['max_memory_allocated']} ({base}: "
            f"{cold['max_memory_allocated']}) expand_launches="
            f"{[rep['launches'][w]['expand'] for w in ('server0', 'server1')]}")
        report["sockets"][name] = rep
        stage(f"{name} socket run")
        # phase 17: rides_socket under the supervised crawl, no fault
        name, rides_cfg = "rides_socket_supervised", cells["rides"][0]
        run = socket_run(name, rides_cfg, RIDES_CLIENTS, args.seed, tmp, SUPERVISED_ENV,
                         supervise=True)
        sup = check_supervised_run(name, run, rides_cfg, report["sockets"]["rides_socket"][
            "hitter_map"], points["rides"])
        want_ck = len([lv for lv in range(CKPT_EVERY, rides_cfg.data_len, CKPT_EVERY)])
        if sup["counters"]["recoveries"] or any(sv["ckpt_writes"] != want_ck
                                                for sv in sup["servers"]):
            raise AssertionError(f"{name}: {sup['counters']}, checkpoints "
                                 f"{[sv['ckpt_writes'] for sv in sup['servers']]}, want "
                                 f"{want_ck} each and no recovery")
        base = report["sockets"]["rides_socket"]
        log(f"supervised {name}: crawl_s={sup['crawl_s']:.3f} (reset, upload and rounds; "
            f"rides_socket: rounds {base['crawl_s']:.3f}, upload {base['addkeys_s']:.3f}) "
            f"rounds_s={sup['seconds_by_part']['levels']:.3f} checkpoints a server={want_ck}")
        report["sockets"][name] = sup
        stage(f"{name} socket run")
        # phase 18: phase 17 with server 1 killed at its first checkpoint
        name = "rides_socket_supervised_kill"
        run = socket_run(name, rides_cfg, RIDES_CLIENTS, args.seed, tmp, SUPERVISED_ENV,
                         supervise=True, kill=True)
        rep = check_supervised_run(name, run, rides_cfg, sup["hitter_map"], points["rides"])
        if rep["counters"]["recoveries"] < 1 or rep["counters"]["levels_rerun"] < 1:
            raise AssertionError(f"{name}: counters {rep['counters']} after a kill")
        stage(f"{name} socket run")
        rep["restored_check"] = restored_expand_check(name, run, rides_cfg, RIDES_CLIENTS,
                                                      args.seed, expand_cuda, collect, prg,
                                                      torch)
        errs["expand"].append(rep["restored_check"]["max_abs_err"])
        report["sockets"][name] = rep
        stage(f"{name} restored check")
        # phase 19: secure rides (ot2s at S = 4), the leader's link to server 0
        # severed in the answer's direction at level CKPT_EVERY's crawl verb, and
        # server 1 killed at its first checkpoint
        name = "rides_secure_socket_supervised_sever"
        cfg = cells["rides_secure"][0]
        chunks = -(-RIDES_SEVER_CLIENTS // cfg.addkey_batch_size)
        # frames to the leader: hello, reset, the chunks, tree_init, a crawl and
        # a prune a level, the checkpoint after the round ending at CKPT_EVERY
        at = chunks + 3 + 2 * CKPT_EVERY + 2
        run = socket_run(name, cfg, RIDES_SEVER_CLIENTS, args.seed, tmp, SUPERVISED_ENV,
                         supervise=True, kill=True, ctl0_faults=f"ctl0:sever@msg={at},dir=s2c")
        from fuzzyheavyhitters_torch.bin import leader as leader_bin
        from fuzzyheavyhitters_torch.protocol import driver

        trusted = dataclasses.replace(cfg, secure_exchange=False)
        pts, k0, k1, _ = leader_bin.client_keys(trusted, RIDES_SEVER_CLIENTS,
                                                torch.device("cuda"), args.seed)
        lead = driver.Leader(*driver.make_servers(
            *(ibdcf.keys_from_numpy(k, "cuda") for k in (k0, k1))), n_dims=cfg.n_dims,
            data_len=cfg.data_len, f_max=cfg.f_max)
        res = lead.run(nreqs=RIDES_SEVER_CLIENTS, threshold=cfg.threshold)
        want_h = {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
        del lead, res, k0, k1
        torch.cuda.empty_cache()
        rep = check_supervised_run(name, run, cfg, want_h, pts, OT2S)
        s0 = rep["servers"][0]
        if (s0["dedup_hits"] < 1 or rep["epochs"][0] < 2 or rep["counters"]["recoveries"] < 1
                or run["proxy_fired"] != [("sever", "s2c", at)]):
            raise AssertionError(f"{name}: dedup_hits={s0['dedup_hits']} epochs={rep['epochs']} "
                                 f"counters={rep['counters']} fired={run['proxy_fired']}")
        rep["sever_at"] = at
        log(f"supervised {name}: sever at ctl0 s2c frame {at} fired, server 0 dedup_hits="
            f"{s0['dedup_hits']}, leader epochs={rep['epochs']}, hitters = driver.Leader's "
            f"(trusted, same keys); data_bytes_sent={[sv['data_bytes_sent'] for sv in rep['servers']]}")
        report["sockets"][name] = rep
        stage(f"{name} socket run")
    for name in points:
        kg = measure_keygen(name, points[name], cells[name][0], keygen_cuda, ibdcf, torch, rng)
        report["crawls"][name]["keygen_check"] = kg
        errs["keygen"].append(kg["max_abs_err"])
    stage("keygen checks")
    report["chunk_checks"] = chunk_checks(torch, args.seed)
    stage("chunk checks")
    for kn, cs in report["chunk_checks"].items():
        errs[kn] += [c["max_abs_err"] for c in cs]

    main4 = report["crawls"]["config4_zipf"]
    widest = lambda cell, kn: next(c for c in report["crawls"][cell]["secure_checks"]
                                   if c["kind"] == "widest_fe62" and c["kernel"] == kn)
    meas = {"keygen": (main4["keygen_check"], "config4_zipf"),
            "expand": (max((c for c in main4["expand_checks"] if c["want_children"]),
                           key=lambda c: c["B"]), "config4_zipf")}
    for kn in OT2S:
        meas[kn] = (widest("config4_zipf_secure", kn), "config4_zipf_secure")
    for kn in GC:
        meas[kn] = (widest("rides_secure_gc", kn), "rides_secure_gc")
    rows = []
    for kn, (_, _, source, replaces) in KERNELS.items():
        m, cell = meas[kn]
        sock = {f"{c}/{who}": report["sockets"][c]["launches"][who][kn]
                for c in report["sockets"] for who in ("server0", "server1")}
        log(f"kernel {kn}: cell={cell} ms={m['ms']:.4f} plain_ms={m['plain_ms']:.4f} "
            f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
            f"launches={ {c: launches[c][kn] for c in launches} } socket_launches={sock} "
            f"checks={len(errs[kn])} max_abs_err={max(errs[kn])}")
        rows.append({"name": kn, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[cell][kn], "max_abs_err": max(errs[kn]),
                     "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": None})
        if kn == "expand":  # the streamed path's inputs, under the same launch counter
            rows[-1]["stream_checks"] = [
                {k: c[k] for k in ("kind", "level", "F", "want_children", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms")}
                for c in report["crawls"]["config4_zipf_stream"]["stream_checks"]]
            rows[-1]["stream_launches"] = launches["config4_zipf_stream"][kn]
            rows[-1]["radix_checks"] = [
                {k: c[k] for k in ("kind", "level", "r", "F", "want_children", "max_abs_err",
                                   "ms", "kernel_ms", "plain_ms", "bound_ms")}
                for c in report["crawls"]["config4_zipf_radix3"]["radix_checks"]]
            rows[-1]["radix_launches"] = launches["config4_zipf_radix3"][kn]
            rows[-1]["restored_check"] = report["sockets"]["rides_socket_supervised_kill"][
                "restored_check"]
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    log(f"chip_smoke wall_s={report['wall_s']:.1f} (build, checks, nine crawls, a resume "
        "and ten socket runs)")
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
