"""End-of-run machine-readable report (the port of
``fuzzyheavyhitters_tpu/obs/report.py``: the same schema and summaries).

One JSON document aggregating every registry's snapshot — the artifact
postmortems consume instead of scraping stdout.  Schema
(``fhh-run-report/1``)::

    {
      "schema": "fhh-run-report/1",
      "written_at": <epoch seconds>,
      "registries": {
        "server0": {
          "counters": {"data_bytes_sent": {"total": N, "by_level": {"0": n0, ...}}, ...},
          "gauges":   {"survivors":       {"last": v, "by_level": {...}}, ...},
          "phases":   {"fss": {"seconds": s, "count": c, "by_level": {...}}, ...}
        },
        ...
      }
    }

Well-known metric names (what populates them):

- phases ``fss`` / ``gc_ot`` / ``field`` — the reference's per-level
  3-phase server taxonomy (protocol/rpc.py crawl verbs; trusted mode's
  ``gc_ot`` slot is the plaintext exchange), plus ``level`` on the
  leader/driver side and ``upload_keys`` / ``setup`` one-offs.
- phases ``otext`` / ``garble`` / ``eval`` / ``b2a`` — the secure-kernel
  split of ``gc_ot`` (extension, circuit garble/eval — zero on the
  1-of-2^S path — and payload-table/open + field conversion); they are
  a BREAKDOWN of gc_ot, not additive with it, and the wire wait is the
  gc_ot remainder.  Counters ``ot_path_ot2s`` / ``ot_path_gc`` count
  levels by the equality-test engine taken.  Rolled up across
  registries into a top-level ``secure_kernels`` section whenever a
  secure crawl ran.
- counters ``data_bytes_sent`` / ``data_bytes_recv`` /
  ``data_msgs_sent`` — server↔server data plane, per level;
  ``control_bytes_*`` — leader↔server control plane;
  ``device_fetches`` — device->host transfers (the floor for
  remote-chip tunnels: fetch COUNT, not byte count — now both are
  measured); ``gc_tests`` — secure-mode equality tests;
  ``checkpoint_writes`` / ``checkpoint_restores``.
- gauges ``ot_batch_size`` (per level), ``survivors`` /
  ``frontier_nodes`` (per level).
- counters ``recoveries`` / ``levels_rerun`` / ``shards_rerun``
  (supervising leaders, socket and mesh) and ``dedup_hits`` /
  ``verb_requests`` (servers' idempotent-replay accounting) — rolled up
  across registries into a top-level ``recovery`` section
  (``{count, levels_rerun, shards_rerun, dedup_hits, dedup_hit_rate}``)
  whenever any supervised component ran, so a recovered run is
  distinguishable from a fault-free one in the report alone.
- gauge ``data_shards`` + phase ``ici_reduce`` + counters
  ``mesh_reshards`` / ``mesh_faults`` (multi-chip servers,
  parallel/server_mesh.py: client-axis shard count, the pre-wire ICI
  psum's fetch-synced seconds, and device-loss recovery events), plus
  gauge ``kernel_shards`` + phase ``kernel_gather`` / counter
  ``kernel_gathers`` (the row-sharded secure kernel stage,
  parallel/kernel_shard.py: the level's active kernel shard count — 1 =
  the degraded gather-to-one-device path — and that gather's dispatch
  seconds, ~0 whenever the sharded stage carries the crawl) — rolled
  up into a top-level ``mesh`` section whenever a multi-chip crawl ran.
- counters ``ingest_admitted`` / ``ingest_shed`` / ``ingest_rejected`` /
  ``ingest_windows`` + phases ``ingest`` / ``window_crawl`` (the
  windowed front-door driver's dedicated registry,
  leader_rpc.WindowedIngest) — rolled up into a top-level ``ingest``
  section (``{admitted, shed, rejected, windows, keys_per_sec,
  window_crawl_seconds}``) whenever a streaming run happened; servers
  additionally keep ``pool_*`` counters surfaced by the ``status`` verb.

``FHH_RUN_REPORT=<path>`` makes the binaries write the
report there at exit / on SIGTERM; :func:`maybe_write_run_report` is
that one-liner.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time

from . import alerts as _alerts
from . import metrics
from . import trace as tracemod
from .hist import Histogram
from ..utils import taint_guard

SCHEMA = "fhh-run-report/1"


def run_report(registries=None) -> dict:
    """Aggregate snapshot of ``registries`` (default: every live one,
    plus the retained final snapshots of dropped ones — see
    ``metrics._retain_final``; snapshots beyond the retention bound are
    counted under ``dropped_registries`` so the cap is never silent).

    Same-named registries (a second ``driver.Leader`` after a checkpoint
    restore registers another ``driver``) get deterministic ``name#2``,
    ``name#3``, ... keys in registration order instead of silently
    overwriting each other."""
    dropped = 0
    if registries is None:
        # dedupe by (name, seq), live snapshot winning: at interpreter
        # exit the weakref finalizers (whose exitfunc registers at first
        # Registry creation, AFTER e.g. an atexit dump) may have
        # already retained final snapshots of registries that are still
        # alive — without the dedupe every one would appear twice
        by_id = {
            (name, seq): (name, seq, snap)
            for name, seq, snap in metrics.final_snapshots()
        }
        for r in metrics.all_registries():
            by_id[(r.name, r.seq)] = (r.name, r.seq, r.report())
        items = sorted(by_id.values(), key=lambda t: (t[0], t[1]))
        dropped = metrics.final_dropped()
    else:
        items = [(r.name, r.seq, r.report()) for r in registries]
    out: dict = {}
    seen: dict = {}
    for name, _seq, snap in items:
        n = seen[name] = seen.get(name, 0) + 1
        out[name if n == 1 else f"{name}#{n}"] = snap
    doc = {
        "schema": SCHEMA,
        "written_at": round(time.time(), 3),
        "registries": out,
    }
    rec = _recovery_summary(out)
    if rec is not None:
        doc["recovery"] = rec
    pipe = _pipeline_summary(out)
    if pipe is not None:
        doc["pipeline"] = pipe
    sk = _secure_kernel_summary(out)
    if sk is not None:
        doc["secure_kernels"] = sk
    sketch = _sketch_summary(out)
    if sketch is not None:
        doc["sketch"] = sketch
    ing = _ingest_summary(out)
    if ing is not None:
        doc["ingest"] = ing
    fleet = _fleet_summary(out)
    if fleet is not None:
        doc["fleet"] = fleet
    mesh = _mesh_summary(out)
    if mesh is not None:
        doc["mesh"] = mesh
    sess = _sessions_summary(out)
    if sess is not None:
        doc["sessions"] = sess
    slo = _slo_summary(out)
    if slo is not None:
        doc["slo"] = slo
    # the alerts fired in this process (obs.alerts), beside the accounting
    # they explain; absent when none fired
    al = _alerts.report_section()
    if al is not None:
        doc["alerts"] = al
    if dropped:
        doc["dropped_registries"] = dropped
    # the document goes to files whole: no registered secret may ride a
    # summary row (the taint sanitizer)
    taint_guard.check(doc, sink="run-report")
    return doc


def _slo_summary(registries: dict) -> dict | None:
    """Cross-registry SLO rollup: every latency histogram
    (obs.hist.Histogram — fixed buckets, so same-named histograms merge
    across the leader, both servers, and every per-session registry by
    summing bucket counts) reduced to p50/p95/p99 + max.  Per-verb RPC
    latencies (``rpc:<verb>`` histograms on the servers) fold into a
    ``verbs`` sub-table; everything else (``level_latency``,
    ``seal_to_hitters``, ``ingest_admit``) is a top-level metric with a
    ``by_registry`` breakdown so the merged count's multiplicity (each
    server observes every level once) stays visible.  Device-profiler
    captures (FHH_PROFILE) ride along under ``profile`` with the trace
    ids they were taken in.  Present only when some histogram (or
    capture) exists — pre-SLO runs omit the section entirely."""
    merged: dict = {}
    by_reg: dict = {}
    for name, snap in registries.items():
        for hname, hsnap in (snap.get("hists") or {}).items():
            h = Histogram.from_snapshot(hsnap)
            if hname in merged:
                merged[hname].merge(h)
            else:
                merged[hname] = h
            by_reg.setdefault(hname, {})[name] = {
                k: v for k, v in hsnap.items() if k != "buckets"
            }
    captures = tracemod.profile_captures()
    if not merged and not captures:
        return None
    out: dict = {}
    verbs: dict = {}
    for hname in sorted(merged):
        row = merged[hname].summary()
        if hname.startswith("rpc:"):
            verbs[hname.split(":", 1)[1]] = row
            continue
        row["by_registry"] = by_reg.get(hname, {})
        out[hname] = row
    if verbs:
        out["verbs"] = verbs
    if captures:
        out["profile"] = captures
    return out


def _recovery_summary(registries: dict) -> dict | None:
    """Cross-registry recovery rollup: a RECOVERED run must be
    distinguishable from a fault-free one in the report alone.  Sums the
    supervisor counters (``recoveries`` / ``levels_rerun`` /
    ``shards_rerun``) and the servers' replay-dedup accounting
    (``dedup_hits`` over ``verb_requests`` -> hit rate) across every
    registry.  Present whenever any of those counters exists — a
    supervised fault-free run reports zeros, an unsupervised legacy run
    omits the section entirely."""
    names = (
        "recoveries", "levels_rerun", "shards_rerun",
        "dedup_hits", "verb_requests",
    )
    sums = dict.fromkeys(names, 0)
    seen = False
    for snap in registries.values():
        counters = snap.get("counters", {})
        for n in names:
            if n in counters:
                seen = True
                sums[n] += counters[n].get("total", 0)
    if not seen:
        return None
    return {
        "count": sums["recoveries"],
        "levels_rerun": sums["levels_rerun"],
        "shards_rerun": sums["shards_rerun"],
        "dedup_hits": sums["dedup_hits"],
        "dedup_hit_rate": round(
            sums["dedup_hits"] / max(1, sums["verb_requests"]), 6
        ),
    }


def _pipeline_summary(registries: dict) -> dict | None:
    """Cross-registry pipelined-crawl rollup (protocol/leader_rpc.py's
    bounded-depth span pipeline): per level and overall, the configured
    in-flight ``depth``, ``overlap_seconds`` (span busy-time the pipeline
    hid behind the level's wall-clock), and ``stalls`` (head-of-line
    reassembly waits while a later span had already finished), plus
    ``faults`` whenever a mid-flight failure quiesced the pipeline into
    the sequential fallback.  Present only when a pipelined crawl ran —
    sequential (depth 1) runs never emit these metrics."""
    depth_by, overlap_by, stall_by = {}, {}, {}
    overlap_total = stalls_total = faults_total = 0
    depth_last = None
    seen = False
    for snap in registries.values():
        g = snap.get("gauges", {}).get("pipeline_depth")
        if g is not None:
            seen = True
            depth_last = g.get("last")
            depth_by.update(g.get("by_level", {}))
        t = snap.get("phases", {}).get("pipeline_overlap")
        if t is not None:
            seen = True
            overlap_total += t.get("seconds", 0.0)
            for lvl, s in t.get("by_level", {}).items():
                overlap_by[lvl] = overlap_by.get(lvl, 0.0) + s
        for name, total, by in (
            ("pipeline_stalls", "stalls", stall_by),
            ("pipeline_faults", "faults", None),
        ):
            c = snap.get("counters", {}).get(name)
            if c is None:
                continue
            seen = True
            if total == "stalls":
                stalls_total += c.get("total", 0)
                for lvl, n in c.get("by_level", {}).items():
                    by[lvl] = by.get(lvl, 0) + n
            else:
                faults_total += c.get("total", 0)
    if not seen:
        return None
    levels = sorted(
        set(depth_by) | set(overlap_by) | set(stall_by), key=lambda k: int(k)
    )
    return {
        "depth": depth_last,
        "overlap_seconds": round(overlap_total, 6),
        "stalls": stalls_total,
        "faults": faults_total,
        "by_level": {
            lvl: {
                "depth": depth_by.get(lvl),
                "overlap_seconds": round(overlap_by.get(lvl, 0.0), 6),
                "stalls": stall_by.get(lvl, 0),
            }
            for lvl in levels
        },
    }


def _secure_kernel_summary(registries: dict) -> dict | None:
    """Cross-registry secure-kernel rollup (the acceptance instrument of
    the device-resident GC/OT work): per phase, total seconds summed
    across every registry (garbler and evaluator roles alternate per
    level, so one server's registry holds half of each phase), plus the
    per-level union breakdown and the equality-test path actually taken
    (``ot2s`` / ``gc`` / ``mixed`` from the ot_path_* counters).
    Present only when a secure crawl ran — trusted runs never emit these
    metrics."""
    names = ("otext", "garble", "eval", "b2a")
    totals = dict.fromkeys(names, 0.0)
    by_level: dict = {}
    paths = {"ot2s": 0, "gc": 0}
    kshards = None
    kgather = 0.0
    seen = False
    for snap in registries.values():
        phases = snap.get("phases", {})
        for n in names:
            t = phases.get(n)
            if t is None:
                continue
            seen = True
            totals[n] += t.get("seconds", 0.0)
            for lvl, s in t.get("by_level", {}).items():
                by_level.setdefault(lvl, dict.fromkeys(names, 0.0))
                by_level[lvl][n] += s
        for p in paths:
            c = snap.get("counters", {}).get(f"ot_path_{p}")
            if c is not None:
                seen = True
                paths[p] += c.get("total", 0)
        g = snap.get("gauges", {}).get("kernel_shards")
        if g is not None:
            kshards = g.get("last") if kshards is None else max(
                kshards, g.get("last")
            )
        t = phases.get("kernel_gather")
        if t is not None:
            kgather += t.get("seconds", 0.0)
    if not seen:
        return None
    if paths["ot2s"] and paths["gc"]:
        ot_path = "mixed"
    elif paths["gc"]:
        ot_path = "gc"
    else:
        ot_path = "ot2s"
    return {
        "ot_path": ot_path,
        "levels_ot2s": paths["ot2s"],
        "levels_gc": paths["gc"],
        # kernel-stage layout (multi-chip servers only; None/0.0 on a
        # single-device crawl — see the mesh section for the per-level
        # breakdown): the phase seconds above are the SHARDED kernels'
        # whenever kernel_shards > 1
        "kernel_shards": kshards,
        "kernel_gather_seconds": round(kgather, 6),
        **{f"{n}_seconds": round(totals[n], 6) for n in names},
        "by_level": {
            lvl: {n: round(v[n], 6) for n in names}
            for lvl, v in sorted(by_level.items(), key=lambda kv: int(kv[0]))
        },
    }


def _sketch_summary(registries: dict) -> dict | None:
    """Cross-registry malicious-sketch rollup (the device-resident
    sharded verify, parallel/sketch_shard.py): total verify seconds
    (the per-level ``sketch`` phase summed across both servers), the
    levels verified, and the verify's shard layout (``sketch_shards``
    gauge — max across levels; 1 = the single fused program).  Present
    only when a sketch verification ran — semi-honest runs never emit
    these metrics."""
    seconds = 0.0
    levels: set = set()
    shards = None
    seen = False
    for snap in registries.values():
        t = snap.get("phases", {}).get("sketch")
        if t is not None:
            seen = True
            seconds += t.get("seconds", 0.0)
            levels |= set(t.get("by_level", {}))
        g = snap.get("gauges", {}).get("sketch_shards")
        if g is not None:
            seen = True
            vals = [v for v in g.get("by_level", {}).values()]
            if g.get("last") is not None:
                vals.append(g["last"])
            if vals:
                m = max(vals)
                shards = m if shards is None else max(shards, m)
    if not seen:
        return None
    return {
        "verify_seconds": round(seconds, 6),
        "levels_verified": len(levels),
        "sketch_shards": shards,
    }


def _ingest_summary(registries: dict) -> dict | None:
    """Cross-registry streaming-ingest rollup (the windowed front door,
    protocol/leader_rpc.WindowedIngest): admitted/shed keys and rejected
    (Overloaded) attempts, sealed-window count, sustained admission rate
    over the ingest phase's wall-clock, and the windowed crawls' total
    seconds.  The driver's dedicated ``ingest`` registry is the source
    of truth (servers keep their own ``pool_*`` counters for ``status``);
    present only when a streaming run happened — batch-upload runs omit
    the section entirely."""
    names = ("ingest_admitted", "ingest_shed", "ingest_rejected",
             "ingest_windows")
    sums = dict.fromkeys(names, 0)
    ingest_s = crawl_s = 0.0
    seen = False
    for snap in registries.values():
        counters = snap.get("counters", {})
        for n in names:
            if n in counters:
                seen = True
                sums[n] += counters[n].get("total", 0)
        phases = snap.get("phases", {})
        t = phases.get("ingest")
        if t is not None:
            seen = True
            ingest_s += t.get("seconds", 0.0)
        t = phases.get("window_crawl")
        if t is not None:
            seen = True
            crawl_s += t.get("seconds", 0.0)
    if not seen:
        return None
    return {
        "admitted": sums["ingest_admitted"],
        "shed": sums["ingest_shed"],
        "rejected": sums["ingest_rejected"],
        "windows": sums["ingest_windows"],
        "keys_per_sec": round(
            sums["ingest_admitted"] / ingest_s, 2
        ) if ingest_s > 0 else None,
        "window_crawl_seconds": round(crawl_s, 6),
    }


def _fleet_summary(registries: dict) -> dict | None:
    """Cross-registry fleet rollup (protocol/fleet.py): placement
    decisions, live migrations and whole-host failovers (the placer's
    ``fleet`` registry), plus the per-server ``session_exports`` /
    ``session_imports`` verb counters and the driver-side journal
    replays that made each transfer exactly-once.  Present only when a
    fleet operation happened — single-pair runs omit the section."""
    names = ("placement_decisions", "session_migrations",
             "session_failovers", "session_exports", "session_imports",
             "ingest_migrations", "ingest_failovers", "sessions_retired")
    sums = dict.fromkeys(names, 0)
    seen = False
    for snap in registries.values():
        counters = snap.get("counters", {})
        for n in names:
            if n in counters:
                seen = True
                sums[n] += counters[n].get("total", 0)
    if not seen:
        return None
    return {
        "placement_decisions": sums["placement_decisions"],
        "session_migrations": sums["session_migrations"],
        "session_failovers": sums["session_failovers"],
        "session_exports": sums["session_exports"],
        "session_imports": sums["session_imports"],
        "sessions_retired": sums["sessions_retired"],
    }


def _mesh_summary(registries: dict) -> dict | None:
    """Cross-registry multi-chip rollup (per-server client sharding,
    parallel/server_mesh.py): the shard count the crawl ran at
    (``data_shards`` gauge, per level), total + per-level
    ``ici_reduce_seconds`` (the pre-wire psum's cost instrument — fetch-
    synced, so these are real seconds), and the device-loss recovery
    counters (``mesh_reshards`` — frontier re-placed from a host-side
    checkpoint; ``mesh_faults`` — every injected/detected mesh fault).
    Present only when a multi-chip crawl ran — single-device servers
    never emit these metrics."""
    shards_last = None
    shards_by: dict = {}
    kshards_last = None
    kshards_by: dict = {}
    ici_total = kgather_total = 0.0
    ici_by: dict = {}
    reshards = faults = kgathers = 0
    seen = False
    for snap in registries.values():
        g = snap.get("gauges", {}).get("data_shards")
        if g is not None:
            seen = True
            shards_last = g.get("last")
            shards_by.update(g.get("by_level", {}))
        g = snap.get("gauges", {}).get("kernel_shards")
        if g is not None:
            seen = True
            kshards_last = g.get("last")
            for lvl, v in g.get("by_level", {}).items():
                kshards_by[lvl] = max(kshards_by.get(lvl, 0), v)
        t = snap.get("phases", {}).get("ici_reduce")
        if t is not None:
            seen = True
            ici_total += t.get("seconds", 0.0)
            for lvl, s in t.get("by_level", {}).items():
                ici_by[lvl] = ici_by.get(lvl, 0.0) + s
        t = snap.get("phases", {}).get("kernel_gather")
        if t is not None:
            seen = True
            kgather_total += t.get("seconds", 0.0)
        c = snap.get("counters", {}).get("kernel_gathers")
        if c is not None:
            seen = True
            kgathers += c.get("total", 0)
        for name in ("mesh_reshards", "mesh_faults"):
            c = snap.get("counters", {}).get(name)
            if c is None:
                continue
            seen = True
            if name == "mesh_reshards":
                reshards += c.get("total", 0)
            else:
                faults += c.get("total", 0)
    if not seen:
        return None
    levels = sorted(set(shards_by) | set(ici_by), key=lambda k: int(k))
    return {
        "data_shards": shards_last,
        "ici_reduce_seconds": round(ici_total, 6),
        # row-sharded secure kernel stage (parallel/kernel_shard.py):
        # the active kernel-shard count (1 = the degraded gather path).
        # kernel_gathers counts exactly the crawl levels that gathered
        # the packed share bits onto one device — the LAYOUT detector
        # (0 on a fully sharded crawl); kernel_gather_seconds is those
        # gathers' dispatch time (the transfer completes lazily under
        # the level's later fetch), a supplement to the counter
        "kernel_shards": kshards_last,
        "kernel_gathers": kgathers,
        "kernel_gather_seconds": round(kgather_total, 6),
        "reshards": reshards,
        "faults": faults,
        "by_level": {
            lvl: {
                "data_shards": shards_by.get(lvl),
                "ici_reduce_seconds": round(ici_by.get(lvl, 0.0), 6),
                **(
                    {"kernel_shards": kshards_by[lvl]}
                    if lvl in kshards_by
                    else {}
                ),
            }
            for lvl in levels
        },
    }


def _sessions_summary(registries: dict) -> dict | None:
    """Cross-registry multi-tenant rollup (per-collection sessions,
    protocol/sessions.py + tenancy.py): per collection, the crawl phase
    seconds and ingest counters summed across its per-session
    registries (named ``server{N}:{key}`` / ``leader:{key}``; the
    default collection rides the bare ``server{N}``/``leader``
    registries and is NOT broken out), plus the tenant scheduler's
    device-turn/stall-fill accounting (``tenant_device_turns`` /
    ``tenant_stall_fills`` on the server registries — a stall fill is a
    device dispatch that ran while ANOTHER collection waited on the
    GC/OT wire, i.e. the idle gap multi-tenancy exists to fill).
    Present only when a multi-tenant run happened — single-collection
    runs omit the section entirely."""
    per: dict = {}
    turns = fills = 0
    seen = False
    for name, snap in registries.items():
        counters = snap.get("counters", {})
        for cname, total_key in (
            ("tenant_device_turns", "turns"),
            ("tenant_stall_fills", "fills"),
        ):
            c = counters.get(cname)
            if c is None:
                continue
            # turns/fills alone do NOT make the section present: every
            # crawl takes device turns — only a per-session registry
            # (a non-default collection) marks a multi-tenant run
            if total_key == "turns":
                turns += c.get("total", 0)
            else:
                fills += c.get("total", 0)
        base = name.split("#", 1)[0]  # strip the dedup suffix
        if ":" not in base:
            continue
        seen = True
        key = base.split(":", 1)[1]
        row = per.setdefault(
            key,
            {"crawl_seconds": 0.0, "levels": 0, "ingest_admitted": 0,
             "data_bytes": 0},
        )
        # heartbeat-gap instrument: the server stamps a per-session
        # last_progress_ts gauge at every verb completion, so a wedged
        # tenant is visible from the report (and live from ``status``)
        # without reading logs — the age here is "as of report time"
        g = snap.get("gauges", {}).get("last_progress_ts")
        if g is not None and g.get("last") is not None:
            row["last_progress_s"] = round(
                max(0.0, time.time() - float(g["last"])), 3
            )
        phases = snap.get("phases", {})
        for ph in ("fss", "gc_ot", "field"):
            t = phases.get(ph)
            if t is not None:
                row["crawl_seconds"] += t.get("seconds", 0.0)
                lv = [int(k) for k in t.get("by_level", {})]
                if lv:
                    row["levels"] = max(row["levels"], max(lv) + 1)
        for cname in ("pool_admitted_keys", "ingest_admitted"):
            c = counters.get(cname)
            if c is not None:
                row["ingest_admitted"] += c.get("total", 0)
        for cname in ("data_bytes_sent", "data_bytes_recv"):
            c = counters.get(cname)
            if c is not None:
                row["data_bytes"] += c.get("total", 0)
    if not seen:
        return None
    for row in per.values():
        row["crawl_seconds"] = round(row["crawl_seconds"], 6)
    return {
        "count": len(per),
        "device_turns": turns,
        "stall_fills": fills,
        "fill_ratio": round(fills / max(1, turns), 6),
        "per_session": dict(sorted(per.items())),
    }


def write_run_report(path: str, registries=None) -> dict:
    rep = run_report(registries)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=1)
    os.replace(tmp, path)  # atomic: a SIGKILL mid-write leaves no torn file
    return rep


def maybe_write_run_report(registries=None) -> str | None:
    """Write to ``$FHH_RUN_REPORT`` if set; returns the path written."""
    path = os.environ.get("FHH_RUN_REPORT")
    if not path:
        return None
    write_run_report(path, registries)
    return path


def per_process_report_path(path: str, tag: str) -> str:
    """``/tmp/r.json`` + ``s0`` -> ``/tmp/r.s0.json``.  Multi-process
    deployments (socket servers, 2-process mesh) inherit ONE
    ``FHH_RUN_REPORT`` path from the shared environment, and each process
    writes the whole document atomically at exit — without a per-process
    suffix the last exiter silently clobbers the other parties' reports."""
    root, ext = os.path.splitext(path)
    return f"{root}.{tag}{ext}"


def claim_report_path(tag: str) -> None:
    """Rewrite this process's ``$FHH_RUN_REPORT`` to its per-process
    path (no-op when the env var is unset)."""
    path = os.environ.get("FHH_RUN_REPORT")
    if path:
        os.environ["FHH_RUN_REPORT"] = per_process_report_path(path, tag)


def _sigterm(_sig, _frame):
    raise SystemExit(143)


@contextlib.contextmanager
def exit_report(heartbeat_default_s: float = 30.0):
    """The binaries' shared exit contract: SIGTERM -> ``SystemExit(143)``
    (so the ``finally`` runs instead of the default immediate kill),
    heartbeat on, and the run report written on the way out — a
    timed-out/killed run still leaves the per-level accounting it
    accumulated plus a heartbeat trail naming the phase it died in."""
    from .heartbeat import start_heartbeat

    signal.signal(signal.SIGTERM, _sigterm)
    start_heartbeat(heartbeat_default_s)
    try:
        yield
    finally:
        maybe_write_run_report()
        tracemod.flush()  # the trace ring survives the exit too
