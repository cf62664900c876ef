"""One run of one cell: set-up, warm-up, the window, the judgement, the
result line.  ``run.py`` is its command line."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from fhhbench import judge
from fhhbench.collection import Collection, collect
from fhhbench.reference import crawl as reference
from fhhbench.spec import Spec
from fhhbench.trace import KernelTap, Trace, profile_collection
from fhhbench.traffic.generate import point_sets

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fuzzyheavyhitters_tpu")
MIN_COLLECTIONS = 2  # so that both point sets are judged, whatever the window


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    cell: dict
    cfg: dict
    mix: dict
    setup_s: float = 0.0
    window_s: float = 0.0  # the first window collection's start to the last one's end
    collections: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: Trace | None = None


def parse(argv):
    p = argparse.ArgumentParser(prog="fhhbench", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["FHH_TORCH_BUILD_DIR"] = str(build / "fhh_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t0: float, root: Path = ROOT, device=None) -> int:
    """Run one cell; returns the exit code.  ``device`` None is the card
    (the command line); tests pass ``"cpu"`` to drive the rest of a run
    on the plain versions of the kernels."""
    args = parse(argv)
    cache_dirs(root)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"fhhbench: {cell['name']} needs {cell['chips']} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    import fuzzyheavyhitters_torch  # noqa: F401  the program under test: without it, no run
    dev = torch.device(device)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    run = Run(cell=cell, cfg=cfg, mix=mix)
    sets = point_sets(spec.sampler(cfg["distribution"]), cfg, mix, args.seed)
    tap = None
    if args.trace:
        tap = KernelTap(spec.kernels())
        tap.install()
    try:
        if attempt(run, lambda: collect(cfg, mix, sets[0], 0, args.seed, 0, dev), sets[0], 0, 0):
            run.collections.clear()  # the warm-up is judged only when it fails
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            run.setup_s = time.perf_counter() - t0
            window(run, sets, args, dev, tap)
    finally:
        if tap is not None:
            tap.uninstall()
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    used = sorted({c.point_set for c in run.collections})
    refs = {k: reference.heavy_hitters(sets[k], cfg["ball_size"], cfg["threshold"], cfg["f_max"])
            for k in used}
    checks = judge.judge(run.collections, refs)
    found = forbidden_modules()
    if found:
        print(f"fhhbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 4
    print(result_line(spec, run, checks, kind, dev, bool(args.trace)))
    return 0


def window(run: Run, sets: list, args, dev, tap) -> None:
    """Collections back to back, whole ones only: another starts while the
    window would still end within ``--seconds`` at the mean pace so far,
    and at least MIN_COLLECTIONS run.  A traced run profiles the first."""
    start = time.perf_counter()
    index = 1
    while index <= MIN_COLLECTIONS or (time.perf_counter() - start) * index / (index - 1) \
            <= args.seconds:
        k = index % len(sets)
        profiled = tap is not None and index == 1
        if profiled:
            run.trace = Trace()
        with profile_collection(run.trace, tap, dev) if profiled else contextlib.nullcontext():
            ok = attempt(run, lambda: collect(run.cfg, run.mix, sets[k], k, args.seed, index, dev),
                         sets[k], k, index)
        if not ok:
            break
        index += 1
    run.window_s = time.perf_counter() - start


def attempt(run: Run, fn, points, point_set: int, index: int) -> bool:
    """Append ``fn()``'s collection to the run; one that raises is appended
    as a failed answer, its traceback on standard error.  Returns whether
    it completed."""
    try:
        c = fn()
        run.collections.append(c)
        print(f"collection {index} point_set {point_set}: {c.seconds:.4f} s"
              + ("" if c.base_ot_s is None else f", base OT {c.base_ot_s:.4f} s"),
              file=sys.stderr)
        return True
    except Exception:  # a collection that raises is a wrong answer, reported, never hidden
        traceback.print_exc()
        run.collections.append(Collection(index=index, point_set=point_set,
                                          clients=points.shape[0],
                                          error=traceback.format_exc(limit=1)))
        return False


def result_line(spec: Spec, run: Run, checks: dict, kind: str, dev, traced: bool) -> str:
    metrics = {}
    for m in spec.metrics(run.cell["name"], traced):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
              "count": run.cell["chips"], "memory_peak_bytes": run.peak_bytes}
    line = {"correct": judge.passed(checks) and bool(run.collections),
            "attempted": len(run.collections), "failed": checks["failed"]["value"],
            "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.span_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return json.dumps(line)
