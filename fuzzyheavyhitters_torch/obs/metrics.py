"""Metrics registry: counters, gauges, phase timers, and timing spans (the
port of ``fuzzyheavyhitters_tpu/obs/metrics.py``: the same names, report
shape and span semantics, so a run report of either package reads alike).

A :class:`Registry` is a named bag of metrics owned by one component —
each collector server owns one (``server0`` / ``server1``), the
in-process driver, the RPC leader, and the mesh leader own theirs, and
everything else (binaries, bench) shares :func:`default_registry`.
Per-component ownership is load-bearing: the bench and the test suite
run both servers in ONE process, and their phase seconds and data-plane
byte counts must stay separable (the run report asserts them consistent
*between* the two servers, which a process-global bag cannot express).

Every metric takes an optional ``level`` label and keeps both a total
and a per-level breakdown — the per-level phase taxonomy the reference
reports as its headline server cost (collect.rs:412-503) is
``timer_add("fss"/"gc_ot"/"field", dt, level=...)`` here.

Spans (:meth:`Registry.span`) are timing contexts that feed the timers
AND mark the registry's "currently running" stack, which the heartbeat
thread reads to name the active phase and level of a wedged run.  While
a ``torch.profiler`` runs, a span named ``x`` is also the profiler range
``fhh.x``, so the program's spans lie on the device trace's clock.  A
counter incremented inside a span inherits the span's ``level`` when the
call site doesn't know it (the data-plane byte accounting in
``protocol/rpc.py`` attributes bytes to the level whose exchange sent
them this way).

Thread-safety: one lock per registry guards every mutation and the
report snapshot; the heartbeat thread reads span stacks concurrently
with the owning event loop.  Registration is WEAK with bounded
final-snapshot retention: live registries are discoverable via
:func:`all_registries`, and when an owner (a leader that finished its
crawl, a drained server) is dropped, the registry's final snapshot is
retained (bounded — oldest beyond :data:`_MAX_FINAL` are discarded and
counted) so the end-of-run report still carries its accounting without
a long-lived process that constructs one leader per collection growing
the registry set, the heartbeat sweep, and every report without bound.
"""

from __future__ import annotations

import threading
import time
import weakref

from . import trace as _trace
from .hist import Histogram


class Span:
    """One active timing context (a stack frame of Registry.span).
    After the context exits, ``seconds`` holds the pass's duration —
    callers that need THIS pass's time (not the registry's accumulated
    total, which a re-crawled level would inflate) read it there."""

    __slots__ = ("name", "level", "t0", "seconds")

    def __init__(self, name: str, level: int | None):
        self.name = name
        # numpy level indices coerced here so every keyed breakdown
        # downstream (span inheritance included) uses plain ints
        self.level = None if level is None else _num(level)
        self.t0 = time.perf_counter()
        self.seconds: float | None = None

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


_REGISTRIES: "weakref.WeakSet[Registry]" = weakref.WeakSet()
# RLock: _retain_final runs from weakref/GC callbacks, which can fire
# synchronously inside an allocation made WHILE this lock is held (e.g.
# list(_REGISTRIES) in all_registries) — a plain Lock would deadlock that
# thread against itself
_GLOBAL_LOCK = threading.RLock()
_DEFAULT: "Registry | None" = None  # fhh-guard: _DEFAULT=_GLOBAL_LOCK
_NEXT_SEQ = 0  # fhh-guard: _NEXT_SEQ=_GLOBAL_LOCK
# final snapshots of dropped registries, as (name, seq, report) — bounded
_MAX_FINAL = 128
_FINAL: "list[tuple[str, int, dict]]" = []  # fhh-guard: _FINAL=_GLOBAL_LOCK
_FINAL_DROPPED = 0  # fhh-guard: _FINAL_DROPPED=_GLOBAL_LOCK


def _retain_final(name: str, seq: int, counters, gauges, timers, hists) -> None:
    """weakref.finalize callback: the owner dropped its registry — keep
    the final snapshot so the end-of-run report still carries this
    component's accounting.  Receives the metric dicts (NOT the registry,
    which the finalizer must not pin); nothing mutates them once the
    owner is gone."""
    global _FINAL_DROPPED
    snap = Registry._snapshot(counters, gauges, timers, hists)
    with _GLOBAL_LOCK:
        _FINAL.append((name, seq, snap))
        if len(_FINAL) > _MAX_FINAL:
            del _FINAL[0]
            _FINAL_DROPPED += 1


def final_snapshots() -> "list[tuple[str, int, dict]]":
    with _GLOBAL_LOCK:
        return list(_FINAL)


def final_dropped() -> int:
    """How many dropped-registry snapshots fell off the retention bound
    (surfaced in the run report so the cap is never silent)."""
    with _GLOBAL_LOCK:
        return _FINAL_DROPPED


def _num(v):
    """Coerce numpy scalars to plain Python numbers at the metric
    boundary, so ``report()`` is always json.dump-able (counter values
    come straight from shape math and ``compact_survivors`` outputs)."""
    return v.item() if hasattr(v, "item") else v


class Registry:
    def __init__(self, name: str = "main"):
        global _NEXT_SEQ
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, dict] = {}
        self._gauges: dict[str, dict] = {}
        self._timers: dict[str, dict] = {}
        self._hists: dict[str, Histogram] = {}
        self._spans: list[Span] = []
        with _GLOBAL_LOCK:
            # registration order breaks name ties deterministically (a
            # process can own two same-named registries, e.g. a second
            # driver.Leader after a checkpoint restore)
            self.seq = _NEXT_SEQ
            _NEXT_SEQ += 1
            _REGISTRIES.add(self)
        weakref.finalize(
            self, _retain_final, self.name, self.seq,
            self._counters, self._gauges, self._timers, self._hists,
        )

    # -- counters / gauges / timers --------------------------------------

    def count(self, name: str, n: float = 1, level: int | None = None) -> None:
        """Add ``n`` to counter ``name``.  ``level=None`` inherits the
        innermost active span's level (if any) — so byte/fetch accounting
        deep in the wire helpers lands on the level whose exchange it
        served without threading the level through every call."""
        n = _num(n)
        with self._lock:
            if level is None:
                level = self._span_level_locked()
            else:
                level = _num(level)
            ent = self._counters.setdefault(name, {"total": 0, "levels": {}})
            ent["total"] += n
            if level is not None:
                ent["levels"][level] = ent["levels"].get(level, 0) + n

    def gauge(self, name: str, value: float, level: int | None = None) -> None:
        """Set gauge ``name`` (last-write-wins, per level and overall)."""
        value = _num(value)
        with self._lock:
            if level is None:
                level = self._span_level_locked()
            else:
                level = _num(level)
            ent = self._gauges.setdefault(name, {"last": value, "levels": {}})
            ent["last"] = value
            if level is not None:
                ent["levels"][level] = value

    def observe(self, name: str, seconds: float) -> None:
        """Record one latency sample into histogram ``name`` (fixed
        log-spaced buckets, obs.hist.Histogram — mergeable across
        registries and processes).  The SLO shape counters/gauges
        cannot express: p50/p95/p99 of per-level crawl latency,
        per-verb RPC latency, seal-to-hitters."""
        seconds = _num(seconds)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(seconds)

    def hist(self, name: str) -> Histogram | None:
        """A merged COPY of histogram ``name`` (callers may merge it
        onward without racing live observes)."""
        with self._lock:
            h = self._hists.get(name)
            return None if h is None else Histogram.merged([h])

    def hists_summary(self) -> dict:
        """{name: quantile summary} for every histogram — the ``status``
        verb's live SLO section (no buckets: bounded response size)."""
        with self._lock:
            return {k: h.summary() for k, h in sorted(self._hists.items())}

    def timer_add(self, name: str, seconds: float, level: int | None = None) -> None:
        seconds = _num(seconds)
        with self._lock:
            ent = self._timers.setdefault(
                name, {"seconds": 0.0, "count": 0, "levels": {}}
            )
            ent["seconds"] += seconds
            ent["count"] += 1
            if level is not None:
                level = _num(level)
                ent["levels"][level] = ent["levels"].get(level, 0.0) + seconds

    # -- spans ------------------------------------------------------------

    def span(self, name: str, level: int | None = None):
        """Timing context: on exit, adds the elapsed seconds to timer
        ``name`` (under ``level``); while active, tops this registry's
        span stack for the heartbeat and for label inheritance."""
        return _SpanCtx(self, name, level)

    def current_span(self) -> Span | None:
        with self._lock:
            return self._spans[-1] if self._spans else None

    def _span_level_locked(self) -> int | None:
        for sp in reversed(self._spans):
            if sp.level is not None:
                return sp.level
        return None

    # -- lifecycle / snapshot ---------------------------------------------

    def reset(self) -> None:
        """Clear accumulated metrics (active spans survive — a reset verb
        can arrive while an outer span is open)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._hists.clear()

    def counter_value(self, name: str, level: int | None = None) -> float:
        with self._lock:
            ent = self._counters.get(name)
            if ent is None:
                return 0
            return ent["total"] if level is None else ent["levels"].get(level, 0)

    def gauge_value(self, name: str, level: int | None = None):
        """Last-written gauge value (None when never set) — the status
        verb's read side of per-level layout gauges like
        ``kernel_shards``."""
        with self._lock:
            ent = self._gauges.get(name)
            if ent is None:
                return None
            return ent["last"] if level is None else ent["levels"].get(level)

    def gauge_max(self, name: str):
        """Maximum over every per-level write of gauge ``name`` (None
        when never set) — how the status verb reports the DEEPEST
        layout a crawl engaged (the last-written value alone hides a
        mid-crawl peak, e.g. a leaf level that degraded to fewer kernel
        shards than the widest inner level)."""
        with self._lock:
            ent = self._gauges.get(name)
            if ent is None:
                return None
            vals = list(ent["levels"].values()) + [ent["last"]]
            return max(vals)

    def timer_seconds(self, name: str, level: int | None = None) -> float:
        with self._lock:
            ent = self._timers.get(name)
            if ent is None:
                return 0.0
            return ent["seconds"] if level is None else ent["levels"].get(level, 0.0)

    def report(self) -> dict:
        """JSON-serializable snapshot.  Level keys become strings (JSON
        objects can't carry int keys); totals stay numbers."""
        with self._lock:
            return self._snapshot(
                self._counters, self._gauges, self._timers, self._hists
            )

    @staticmethod
    def _snapshot(counters, gauges, timers, hists=None) -> dict:
        str_levels = lambda d: {str(k): v for k, v in sorted(d.items())}
        out = {
            "counters": {
                k: {"total": v["total"], "by_level": str_levels(v["levels"])}
                for k, v in sorted(counters.items())
            },
            "gauges": {
                k: {"last": v["last"], "by_level": str_levels(v["levels"])}
                for k, v in sorted(gauges.items())
            },
            "phases": {
                k: {
                    "seconds": v["seconds"],
                    "count": v["count"],
                    "by_level": str_levels(v["levels"]),
                }
                for k, v in sorted(timers.items())
            },
        }
        if hists:
            # key present only when histograms exist: pre-SLO consumers
            # (and the reset-to-empty contract) see the exact old shape
            out["hists"] = {
                k: h.snapshot() for k, h in sorted(hists.items())
            }
        return out


def _profiler_range(name: str):
    """An entered profiler range ``fhh.<name>`` while a ``torch.profiler``
    runs in this process, else None: with no profiler the span costs one
    flag read, not a range's enter and exit.  The range is torch's
    ``RecordFunctionFast`` where it has one (a tenth of
    ``record_function``'s host cost under a profiler, which a crawl's
    thousands of spans would otherwise add to the device's idle time),
    else ``torch.profiler.record_function``."""
    import torch

    if not torch.autograd._profiler_enabled():
        return None
    make = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
        or torch.profiler.record_function
    rf = make(f"fhh.{name}")
    rf.__enter__()
    return rf


class _SpanCtx:
    __slots__ = ("_reg", "_name", "_level", "_span", "_trace", "_range")

    def __init__(self, reg: Registry, name: str, level: int | None):
        self._reg, self._name, self._level = reg, name, level

    def __enter__(self) -> Span:
        # under a profiler the span is also a range on the profiler's clock
        # (the benchmark's traced collection, FHH_PROFILE captures), opened
        # first and closed last, so the span's own bookkeeping lies in it
        self._range = _profiler_range(self._name)
        self._span = Span(self._name, self._level)
        # distributed tracing (obs.trace): under an active trace context
        # this span records as a child event in the per-process ring —
        # one enabled() flag read when tracing is off (the pinned
        # zero-overhead contract, like FHH_DEBUG_GUARDS)
        self._trace = _trace.span_begin() if _trace.enabled() else None
        with self._reg._lock:
            self._reg._spans.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = self._span.seconds = self._span.elapsed()
        with self._reg._lock:
            # remove THIS span (not blindly the top): an exception may
            # unwind contexts out of order across await points
            try:
                self._reg._spans.remove(self._span)
            except ValueError:
                pass
        if self._trace is not None:
            # a span unwound by an exception (a severed data plane
            # failing a mid-exchange verb) records error=true instead of
            # dangling open in the merged trace
            _trace.span_end(
                self._trace, self._name, self._reg.name,
                level=self._span.level, error=exc_type is not None,
            )
        self._reg.timer_add(self._name, dt, self._level)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)


def default_registry() -> Registry:
    """The process-wide registry for components without their own."""
    global _DEFAULT
    with _GLOBAL_LOCK:
        if _DEFAULT is not None:
            return _DEFAULT
    reg = Registry("main")  # registers itself; construct outside the
    # global lock (Registry.__init__ takes that same lock)
    with _GLOBAL_LOCK:
        if _DEFAULT is None:  # lost the construction race: first one wins
            _DEFAULT = reg
        return _DEFAULT


def all_registries() -> list[Registry]:
    """Every registry created in this process, sorted by name then by
    registration order (so same-named registries keep a stable order)."""
    with _GLOBAL_LOCK:
        regs = list(_REGISTRIES)
    return sorted(regs, key=lambda r: (r.name, r.seq))
