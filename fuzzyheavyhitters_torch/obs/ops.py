"""The ``ops top`` CLI: a one-screen live view over the /metrics plane (the
port of ``fuzzyheavyhitters_tpu/obs/ops.py``, which reads either package's
exposition).

``python -m fuzzyheavyhitters_torch.obs.ops top`` scrapes the leader and
both collector servers (``FHH_METRICS_PORT`` base, +1, +2, or ``--targets
host:port,...``), merges the per-collection rows across processes and
renders one screen: the alerts first, then a session table (last progress,
queue depth, levels and the level-latency p95 rebuilt from the shared
fixed buckets, device memory), then each registry's headline counters.
``--once`` prints one frame; the default loops, clearing between frames.

The exposition parser and the buckets-to-``Histogram`` rebuild are plain
functions here: a scrape carries exactly the bucket counts the run report
computes its quantiles from.
"""


from __future__ import annotations

import argparse
import math
import os
import re
import sys
import time
import urllib.request

from .hist import BUCKET_BOUNDS, Histogram

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Exposition text -> ``[(name, labels, value), ...]`` (comments and
    malformed lines skipped — a scrape parser must be forgiving)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        labels = {
            k: v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.append((m.group("name"), labels, value))
    return out


def buckets_to_hist(samples: list[tuple[dict, float]]) -> Histogram:
    """Rebuild an :class:`obs.hist.Histogram` from one series' scraped
    cumulative ``_bucket`` samples (``le`` label keyed).  The shared
    BUCKET_BOUNDS make this exact for counts; sum rides via
    :func:`hist_from_series` when the ``_sum``/``_count`` samples are
    supplied too."""
    by_le: dict[float, int] = {}
    inf_count = 0
    for labels, value in samples:
        le = labels.get("le")
        if le is None:
            continue
        if le == "+Inf":
            inf_count = int(value)
        else:
            by_le[float(le)] = int(value)
    h = Histogram()
    prev = 0
    for i, bound in enumerate(BUCKET_BOUNDS):
        cum = by_le.get(float(format(bound, ".10g")), prev)
        h.counts[i] = cum - prev
        prev = cum
    h.counts[len(BUCKET_BOUNDS)] = max(0, inf_count - prev)
    h.count = inf_count
    return h


def hist_from_series(
    buckets: list[tuple[dict, float]],
    sum_s: float | None = None,
    count: int | None = None,
) -> Histogram:
    """Buckets + optional ``_sum``/``_count`` -> a mergeable Histogram.
    min/max are not on the wire; they re-derive conservatively from the
    occupied bucket range so quantile clamping stays sane."""
    h = buckets_to_hist(buckets)
    if count is not None:
        h.count = int(count)
    if sum_s is not None:
        h.sum = float(sum_s)
    lo = hi = None
    for i, c in enumerate(h.counts):
        if c:
            if lo is None:
                lo = i
            hi = i
    if lo is not None:
        h.min = 0.0 if lo == 0 else BUCKET_BOUNDS[lo - 1]
        h.max = h.sum if hi >= len(BUCKET_BOUNDS) else BUCKET_BOUNDS[hi]
    else:
        h.min, h.max = math.inf, 0.0
    return h


# -- scraping --------------------------------------------------------------


def default_targets() -> list[str]:
    base = int(os.environ.get("FHH_METRICS_PORT", "0") or 0)
    if not base:
        return []
    host = os.environ.get("FHH_METRICS_HOST", "127.0.0.1")
    return [f"{host}:{base + off}" for off in (0, 1, 2)]


def scrape(target: str, timeout_s: float = 2.0) -> list[tuple[str, dict, float]]:
    """One target's parsed samples; [] when unreachable (a dead process
    is a row gap in ``top``, not a crash)."""
    try:
        with urllib.request.urlopen(
            f"http://{target}/metrics", timeout=timeout_s
        ) as resp:
            return parse_prometheus(resp.read().decode("utf-8", "replace"))
    except OSError:
        return []


def _fmt_bytes(v: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return f"{v:.1f}TiB"


def render_top(samples_by_target: dict) -> str:
    """Merge every target's samples into the one-screen frame."""
    lines = [
        "fhh-ops top  "
        + time.strftime("%H:%M:%S")
        + "  targets: "
        + " ".join(
            f"{t}({'up' if s else 'down'})"
            for t, s in samples_by_target.items()
        )
    ]
    allsamp = [
        (t, n, lb, v)
        for t, samp in samples_by_target.items()
        for (n, lb, v) in samp
    ]
    alerts = [
        (lb.get("rule", "?"), lb.get("subject", "?"))
        for (_t, n, lb, _v) in allsamp
        if n == "fhh_alert_active"
    ]
    if alerts:
        lines.append("ALERTS:")
        for rule, subject in sorted(set(alerts)):
            lines.append(f"  !! {rule:<24} {subject}")
    else:
        lines.append("alerts: none")
    # per-(registry, collection) session rows, merged across targets
    rows: dict[tuple, dict] = {}

    def row(lb):
        key = (lb.get("registry", "?"), lb.get("collection", "default"))
        return rows.setdefault(key, {})

    hist_parts: dict[tuple, dict] = {}
    for _t, name, lb, v in allsamp:
        if name == "fhh_session_last_progress_seconds":
            row(lb)["last_progress_s"] = v
        elif name == "fhh_session_queue_depth_keys":
            row(lb)["queue_depth"] = v
        elif name == "fhh_key_plane_bytes":
            row(lb)["key_plane"] = v
        elif name == "fhh_level_latency_seconds_bucket":
            key = (lb.get("registry", "?"), lb.get("collection", "default"))
            hist_parts.setdefault(key, {"b": [], "s": None, "c": None})[
                "b"
            ].append((lb, v))
        elif name == "fhh_level_latency_seconds_sum":
            key = (lb.get("registry", "?"), lb.get("collection", "default"))
            hist_parts.setdefault(key, {"b": [], "s": None, "c": None})[
                "s"
            ] = v
        elif name == "fhh_level_latency_seconds_count":
            key = (lb.get("registry", "?"), lb.get("collection", "default"))
            hist_parts.setdefault(key, {"b": [], "s": None, "c": None})[
                "c"
            ] = v
        elif name == "fhh_hbm_in_use_bytes":
            row(lb)["hbm"] = v
    for key, parts in hist_parts.items():
        h = hist_from_series(parts["b"], parts["s"], parts["c"])
        if h.count:
            rows.setdefault(key, {})["p95_s"] = h.quantile(0.95)
            rows.setdefault(key, {})["levels"] = h.count
    if rows:
        lines.append(
            f"{'registry':<12} {'collection':<16} {'progress':>9} "
            f"{'queue':>8} {'levels':>7} {'lvl p95':>9} {'hbm':>10}"
        )
        for (reg, coll), r in sorted(rows.items()):
            gap = r.get("last_progress_s")
            p95 = r.get("p95_s")
            lines.append(
                f"{reg:<12} {coll:<16} "
                f"{(f'{gap:.1f}s' if gap is not None else '-'):>9} "
                f"{int(r.get('queue_depth', 0)):>8} "
                f"{int(r.get('levels', 0)):>7} "
                f"{(f'{p95:.3f}s' if p95 is not None else '-'):>9} "
                f"{(_fmt_bytes(r['hbm']) if 'hbm' in r else '-'):>10}"
            )
    # headline counters per registry (totals only, merged by max per
    # target — each process reports its own registries exactly once)
    heads: dict[tuple, float] = {}
    for _t, name, lb, v in allsamp:
        if name in (
            "fhh_fresh_compiles_total",
            "fhh_fresh_compiles_post_warmup_total",
            "fhh_data_bytes_sent_total",
            "fhh_ingest_admitted_total",
        ):
            heads[(lb.get("registry", "?"), name)] = max(
                heads.get((lb.get("registry", "?"), name), 0.0), v
            )
    for (reg, name), v in sorted(heads.items()):
        lines.append(f"  {reg:<12} {name} {int(v)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fuzzyheavyhitters_torch.obs.ops")
    sub = ap.add_subparsers(dest="cmd", required=True)
    top = sub.add_parser("top", help="live one-screen view over /metrics")
    top.add_argument(
        "--targets",
        help="comma list of host:port (default: FHH_METRICS_PORT base,+1,+2)",
    )
    top.add_argument("--once", action="store_true", help="print one frame")
    top.add_argument("--interval", type=float, default=2.0)
    args = ap.parse_args(argv)
    targets = (
        args.targets.split(",") if args.targets else default_targets()
    )
    if not targets:
        sys.stderr.write("no targets: set FHH_METRICS_PORT or pass --targets\n")
        return 2
    while True:
        frame = render_top({t: scrape(t) for t in targets})
        if args.once:
            sys.stdout.write(frame + "\n")
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
