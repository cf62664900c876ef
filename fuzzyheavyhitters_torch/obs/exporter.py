"""Live /metrics exporter: Prometheus text format over stdlib HTTP (the port
of ``fuzzyheavyhitters_tpu/obs/exporter.py``: the same switch, port layout,
series names and labels, so one scraper reads either package's processes).

The run report and the trace rings say what happened; this module says what
is happening: every live :class:`obs.metrics.Registry` counter, gauge,
phase timer and fixed-bucket histogram, served as Prometheus exposition
text from a daemon thread, so a crawl can be watched while it runs.

One switch: the exporter exists only when ``FHH_METRICS_PORT`` is set.
Unset, a run pays one ``getenv`` at start-up: no socket, no thread, no cost
per metric (the registries are scraped, never instrumented).

Port layout: each process claims ``base + offset`` by its telemetry tag
(``leader`` +0, ``s0`` +1, ``s1`` +2, anything else +0), the tags of the
run-report path and the trace ring.  A base of ``0`` binds an ephemeral
port (tests; read it back with :func:`port`).  ``FHH_METRICS_HOST`` binds
another interface than the loopback.  A bind failure degrades to a
structured ``metrics.disabled`` warning: a telemetry setting never takes
down a collector.

Naming: every series is ``fhh_<name>[_seconds][_total]`` with a
``registry`` label and, for a collection's registry named
``server0:tenant``, a ``collection`` label.  A colon in a metric name
(``fresh_compiles:level``) is an internal sub-name and becomes a ``key``
label, because ``:`` is reserved in exposition names.

Beyond the registries, a process registers *producers*: callables that
return extra exposition lines (a collector server publishes its live
session rows so, and the alert engine is evaluated at each scrape).  A
producer that returns ``None`` is pruned.  The scrape runs in the HTTP
thread: the registries lock their own state, and a producer that reads an
object's guarded state opens its ``guards.unguarded`` window there.
"""


from __future__ import annotations

import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import logs
from ..utils import taint_guard
from .hist import BUCKET_BOUNDS
from .metrics import all_registries

ENV_PORT = "FHH_METRICS_PORT"
ENV_HOST = "FHH_METRICS_HOST"  # default loopback: telemetry, not a service

# tag -> port offset from the FHH_METRICS_PORT base (one process family
# per machine; ops.top scrapes base, base+1, base+2)
PORT_OFFSETS = {"leader": 0, "s0": 1, "s1": 2}

_lock = threading.Lock()
# fhh-guard: _state=_lock
_state: dict = {"server": None, "thread": None, "port": None, "tag": None}
_producers: list = []  # fhh-guard: _producers=_lock

_SANE_RE = re.compile(r"[^a-z0-9_]")


def _sane(name: str) -> str:
    """Coerce an internal metric name into a Prometheus identifier
    chunk: lowercase, every illegal char to ``_``, never digit-led."""
    out = _SANE_RE.sub("_", str(name).lower())
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _esc(value) -> str:
    """Escape a label value per the exposition format."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels(registry_name: str, extra: dict | None = None) -> str:
    """Render the label block for one registry.  Per-session registries
    are named ``server0:tenant`` (protocol/sessions.SessionTable); the
    colon splits into ``registry`` + ``collection`` so one family holds
    every tenant's series side by side."""
    reg, _, coll = registry_name.partition(":")
    parts = [f'registry="{_esc(reg)}"']
    if coll:
        parts.append(f'collection="{_esc(coll)}"')
    for k, v in (extra or {}).items():
        parts.append(f'{k}="{_esc(v)}"')
    return "{" + ",".join(parts) + "}"


def _split_key(name: str) -> tuple[str, dict]:
    """``fresh_compiles:level`` -> (``fresh_compiles``, {key: level})."""
    base, _, sub = name.partition(":")
    return _sane(base), ({"key": sub} if sub else {})


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return repr(float(v)) if isinstance(v, float) else str(v)
    return "NaN"  # non-numeric gauge (defensive: exporter never raises)


class _Families:
    """Accumulates series grouped by family so each family emits one
    HELP/TYPE header no matter how many registries contribute."""

    def __init__(self):
        self._fam: dict[str, tuple[str, list[str]]] = {}

    def add(self, family: str, typ: str, line: str) -> None:
        ent = self._fam.get(family)
        if ent is None:
            ent = self._fam[family] = (typ, [])
        ent[1].append(line)

    def render(self) -> list[str]:
        out = []
        for family in sorted(self._fam):
            typ, lines = self._fam[family]
            out.append(f"# TYPE {family} {typ}")
            out.extend(lines)
        return out


def _hist_lines(fam: _Families, family: str, labels_base: str, snap: dict) -> None:
    """One histogram snapshot (obs.hist sparse-bucket form) as a
    Prometheus histogram: cumulative ``_bucket`` over the shared
    BUCKET_BOUNDS plus ``+Inf``, then ``_sum`` / ``_count``."""
    counts = [0] * (len(BUCKET_BOUNDS) + 1)
    for k, c in (snap.get("buckets") or {}).items():
        i = int(k)
        if 0 <= i < len(counts):
            counts[i] = int(c)
    strip = labels_base[1:-1]  # inner "k=v,k=v" of the rendered block
    cum = 0
    for i, bound in enumerate(BUCKET_BOUNDS):
        cum += counts[i]
        le = format(bound, ".10g")
        fam.add(
            family, "histogram",
            f'{family}_bucket{{{strip},le="{le}"}} {cum}',
        )
    total = int(snap.get("count", cum + counts[-1]))
    fam.add(
        family, "histogram",
        f'{family}_bucket{{{strip},le="+Inf"}} {total}',
    )
    fam.add(family, "histogram", f"{family}_sum{labels_base} {_fmt(float(snap.get('sum_s', 0.0)))}")
    fam.add(family, "histogram", f"{family}_count{labels_base} {total}")


def render() -> str:
    """The full exposition document: every live registry's snapshot plus
    every producer's extra lines.  Pure read — safe from the HTTP thread
    (``Registry.report`` snapshots under the registry lock)."""
    fam = _Families()
    for reg in all_registries():
        rep = reg.report()
        for name, ent in rep["counters"].items():
            base, extra = _split_key(name)
            family = f"fhh_{base}_total"
            fam.add(family, "counter",
                    f"{family}{_labels(reg.name, extra)} {_fmt(ent['total'])}")
        for name, ent in rep["gauges"].items():
            base, extra = _split_key(name)
            family = f"fhh_{base}"
            fam.add(family, "gauge",
                    f"{family}{_labels(reg.name, extra)} {_fmt(ent['last'])}")
        for name, ent in rep["phases"].items():
            base, extra = _split_key(name)
            lbl = _labels(reg.name, extra)
            fams = f"fhh_{base}_seconds_total"
            famc = f"fhh_{base}_runs_total"
            fam.add(fams, "counter", f"{fams}{lbl} {_fmt(ent['seconds'])}")
            fam.add(famc, "counter", f"{famc}{lbl} {_fmt(ent['count'])}")
        for name, snap in rep.get("hists", {}).items():
            base, extra = _split_key(name)
            family = f"fhh_{base}_seconds"
            _hist_lines(fam, family, _labels(reg.name, extra), snap)
    lines = fam.render()
    # the scrape IS the registry-rule evaluation tick for the alert
    # engine (no thread, no timer): slo burn / post-warmup recompiles /
    # HBM high water are checked against exactly what was just rendered
    from . import alerts  # late: alerts renders via this module too

    alerts.evaluate_registries()
    lines.extend(alerts.metrics_lines())
    with _lock:
        producers = list(_producers)
    dead = []
    for prod in producers:
        try:
            extra_lines = prod()
        # fhh-lint: disable=broad-except (scrape path: a racy producer
        # snapshot may never 500 the exporter or kill its thread)
        except Exception:
            continue
        if extra_lines is None:
            dead.append(prod)
            continue
        lines.extend(extra_lines)
    if dead:
        with _lock:
            for prod in dead:
                if prod in _producers:
                    _producers.remove(prod)
    text = "\n".join(lines) + "\n"
    # the full exposition document is what an outward-facing scrape
    # sees: the shadow-taint sanitizer's most important boundary
    taint_guard.check(text, sink="metrics-render")
    return text


def add_producer(fn) -> None:
    """Register a callable returning extra exposition lines (or ``None``
    once its owner is gone, which prunes it)."""
    with _lock:
        _producers.append(fn)


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] != "/metrics":
            self.send_response(404)
            self.end_headers()
            return
        body = render().encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_args):  # scrapes are not log events
        pass


def maybe_start(tag: str):
    """Start the exporter iff ``FHH_METRICS_PORT`` is set; returns the
    bound port or ``None``.  Idempotent per process; bind/parse failures
    degrade with a structured warn and return ``None`` (a telemetry knob
    may never crash a collector)."""
    raw = os.environ.get(ENV_PORT)
    if not raw:
        return None  # the entire disabled-path cost: one getenv
    with _lock:
        if _state["server"] is not None:
            return _state["port"]
    try:
        base = int(raw)
    except ValueError:
        logs.emit("metrics.disabled", severity="warn", tag=tag,
                  reason=f"bad {ENV_PORT}={raw!r}")
        return None
    port = 0 if base == 0 else base + PORT_OFFSETS.get(tag, 0)
    host = os.environ.get(ENV_HOST, "127.0.0.1")
    try:
        srv = ThreadingHTTPServer((host, port), _Handler)
    except OSError as e:
        logs.emit("metrics.disabled", severity="warn", tag=tag,
                  port=port, reason=repr(e))
        return None
    srv.daemon_threads = True
    th = threading.Thread(
        target=srv.serve_forever, name=f"fhh-metrics-{tag}", daemon=True
    )
    bound = srv.server_address[1]
    with _lock:
        if _state["server"] is not None:  # lost a start race: first wins
            bound = _state["port"]
            srv.server_close()
            return bound
        _state.update(server=srv, thread=th, port=bound, tag=tag)
    th.start()
    logs.emit("metrics.listening", tag=tag, port=bound, host=host)
    return bound


def running() -> bool:
    with _lock:
        return _state["server"] is not None


def port() -> int | None:
    with _lock:
        return _state["port"]


def stop() -> None:
    """Tear the exporter down (tests; binaries just exit)."""
    with _lock:
        srv, th = _state["server"], _state["thread"]
        _state.update(server=None, thread=None, port=None, tag=None)
        _producers.clear()
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if th is not None:
        th.join(timeout=5)
