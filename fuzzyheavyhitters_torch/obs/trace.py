"""fhh-trace: cross-process distributed tracing for the crawl stack (the port
of ``fuzzyheavyhitters_tpu/obs/trace.py``: the same context, JSONL event
format, ring files and merge, so rings written by either package merge
into one timeline).

One crawl (or one ingest window) involves a leader and two collector
servers exchanging dozens of verbs per level; each process's registries
time their own spans, but nothing ties "server0 spent 300 ms in gc_ot at
level 7" to THE verb the leader issued — which is exactly what
diagnosing a missed clients/sec target needs.  This module adds that
tie, at zero cost when disabled (one flag read):

- **Trace context** — the leader mints a ``trace_id`` per crawl/window
  (:func:`root`); every :meth:`CollectorClient.call` allocates a
  ``span_id`` for the verb and carries ``{"t", "s", "p"}`` in the
  request dict; the server activates that context around the verb's
  execution (:func:`activate`), so every existing ``Registry.span`` in
  the verb's dynamic extent records as a child of the leader's call.
  Replays resend the SAME span id with the same req_id, and the
  server's dedup cache answers them without re-executing — so a span is
  recorded exactly once per execution, never per delivery.
- **Per-process JSONL ring** — events append to
  ``$FHH_TRACE_DIR/fhh_trace_<tag>_<pid>.jsonl``; at
  ``FHH_TRACE_RING`` events (default 200k) the file rotates once to a
  ``.1`` sibling, so a long-lived server is bounded at two segments.
- **Clock correction** — every ``__hello__`` and ``status`` response
  carries the server's wall clock; the client records the NTP-style
  midpoint offset (server_clock - leader_clock) as a ``C`` record.
  :func:`merge` subtracts each component's offset so the merged
  timeline is in LEADER time.
- **Perfetto export** — ``python -m fuzzyheavyhitters_torch.obs.trace
  merge -d $FHH_TRACE_DIR -o trace.json`` emits one Chrome-trace JSON:
  one "process" track per component (leader / server0 / server1 /
  per-session registries), one thread per collection.
  :func:`validate` is the structural gate tests and CI assert on:
  every parented event's parent exists, durations are non-negative,
  and clock offsets are finite.
- **Device profiler hooks** — ``FHH_PROFILE=<dir>`` wraps each crawl
  (or only levels named by ``FHH_PROFILE_LEVELS=2,3``) in a
  ``torch.profiler`` capture (CPU and CUDA activities; the kernels
  launched through ``ctypes`` show under their ``fhh_`` names), written
  as one Chrome trace per capture and recorded alongside the active
  trace id, so the device timeline is joinable to the Perfetto view.
  Each capture opens with a zero-length profiler range ``fhh.clock``;
  with tracing on, the ring records the wall clock at it beside the
  range's profiler timestamp, and :func:`merge` shifts the capture onto
  the ring's timeline.  (While a profiler runs, every ``Registry.span``
  ``x`` is also the range ``fhh.x`` in the capture.)

Events are small dicts, one JSON object per line::

    {"ph": "X", "name": "gc_ot", "comp": "server0", "ts": ..., "dur": ...,
     "trace": "crawl-ab12-1", "span": "ab12-7", "parent": "ab12-3",
     "level": 5, "error": false}

``ph``: "X" complete span, "i" instant, "C" clock offset.  ``ts``/"dur"
are SECONDS (epoch / elapsed); merge converts to Chrome-trace µs.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import math
import os
import sys
import threading
import time

from ..utils import taint_guard

ENV_DIR = "FHH_TRACE_DIR"
ENV_RING = "FHH_TRACE_RING"
ENV_PROFILE = "FHH_PROFILE"
ENV_PROFILE_LEVELS = "FHH_PROFILE_LEVELS"

_DEFAULT_RING = 200_000
CLOCK_RANGE = "fhh.clock"  # a capture's zero-length range, shared with the ring

# (trace_id, current_span_id) for the running task; None = no trace
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    # fhh-lint: disable=metric-naming (contextvar name, not a series)
    "fhh_trace_ctx", default=None
)

_LOCK = threading.Lock()
# set-once enabled flag: resolved from the env on first use; the
# lock-free read in enabled() is a benign race on an immutable value
# (writers hold _LOCK; _refresh() is the test hook)
_ENABLED: "bool | None" = None
# _WRITER/_TAG/_ENABLED: written only under _LOCK; the lock-free reads
# on the event fast path are benign races on set-once values (a stale
# None just means one more trip through the locked slow path).  NOT
# fhh-guard-bound for exactly that reason — binding them would outlaw
# the deliberate fast-path read.
_WRITER = None
_TAG: "str | None" = None
_CAPTURES: list = []  # fhh-guard: _CAPTURES=_LOCK
_PROF_ACTIVE = [False]  # one profiler session at a time (one per process)
_PROF_SEQ = itertools.count(1)

# process-unique span-id prefix + counter: ids stay unique across the
# leader and both servers without coordination
_PROC_ID = f"{os.getpid():x}{int(time.time() * 1e3) & 0xFFF:03x}"
_SEQ = itertools.count(1)


def enabled() -> bool:
    global _ENABLED
    e = _ENABLED
    if e is None:
        with _LOCK:
            if _ENABLED is None:
                _ENABLED = bool(os.environ.get(ENV_DIR))
            e = _ENABLED
    return e


def _refresh() -> None:
    """Test hook: re-resolve the env knobs and drop the writer."""
    global _ENABLED, _WRITER, _TAG
    with _LOCK:
        if _WRITER is not None:
            _WRITER.close()
        _ENABLED = None
        _WRITER = None
        _TAG = None
        del _CAPTURES[:]


def claim_tag(tag: str) -> None:
    """Name this process's trace file (``leader`` / ``s0`` / ``s1``);
    called by the binaries before the first event.  Purely cosmetic —
    the pid keeps file names unique either way."""
    global _TAG
    with _LOCK:
        if _WRITER is None:  # too late once the file is open
            _TAG = tag


class _Writer:
    """Append-only JSONL ring: one live segment plus one rotated
    ``.1`` sibling — bounded disk for a long-lived server."""

    def __init__(self, trace_dir: str, tag: str, ring: int):
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(trace_dir, f"fhh_trace_{tag}.jsonl")
        self.ring = max(1024, ring)
        self._lock = threading.Lock()
        # line-buffered: a SIGKILLed process loses at most the torn tail
        # line (which load_events skips), not a whole buffer of spans
        self._f = open(self.path, "w", encoding="utf-8", buffering=1)
        self._n = 0

    def write(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            if self._f is None:
                return
            if self._n >= self.ring:
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self._f = open(self.path, "w", encoding="utf-8", buffering=1)
                self._n = 0
            self._f.write(line + "\n")
            self._n += 1

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def _writer() -> "_Writer | None":
    global _WRITER
    if not enabled():
        return None
    w = _WRITER
    if w is None:
        with _LOCK:
            if _WRITER is None:
                trace_dir = os.environ.get(ENV_DIR)
                if not trace_dir:
                    return None
                try:
                    ring = int(os.environ.get(ENV_RING, _DEFAULT_RING))
                except ValueError:
                    ring = _DEFAULT_RING
                tag = _TAG or "p"
                try:
                    _WRITER = _Writer(
                        trace_dir, f"{tag}_{os.getpid()}", ring
                    )
                except OSError as e:
                    # a bad trace dir must degrade, never take down the
                    # crawl telemetry exists to observe
                    from . import logs

                    logs.emit(
                        "trace.disabled", severity="warn",
                        dir=trace_dir, error=str(e),
                    )
                    global _ENABLED
                    _ENABLED = False
                    return None
            w = _WRITER
    return w


def _event(rec: dict) -> None:
    # every span, instant and call record passes here: the taint
    # sanitizer watches the whole trace plane at this one place
    taint_guard.check(rec, sink="trace-event")
    w = _writer()
    if w is not None:
        w.write(rec)


def flush() -> None:
    with _LOCK:
        w = _WRITER
    if w is not None:
        w.flush()


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------


def _new_id() -> str:
    return f"{_PROC_ID}-{next(_SEQ)}"


def current_ids() -> "tuple | None":
    """(trace_id, span_id) of the running task, or None."""
    return _CTX.get()


def current_trace_id() -> "str | None":
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]


@contextlib.contextmanager
def root(kind: str):
    """Mint a trace id for one crawl/window — the leader-side entry
    point.  Reuses an already-active trace (a windowed crawl nested
    inside its window's trace stays ONE trace) and is a no-op when
    tracing is disabled.  Yields the active trace id (or None)."""
    if not enabled():
        yield None
        return
    ctx = _CTX.get()
    if ctx is not None:
        yield ctx[0]  # nested: one trace per outermost root
        return
    tid = f"{kind}-{_new_id()}"
    tok = _CTX.set((tid, None))
    try:
        yield tid
    finally:
        try:
            _CTX.reset(tok)
        except ValueError:
            pass  # exited from a different task/context: drop the reset


def wire_ctx() -> "tuple[dict, list] | None":
    """Allocate the span a CollectorClient.call carries on the wire:
    returns ``({"t", "s", "p"}, state-for-call_event)`` or None when no
    trace is active.  The span id is minted ONCE per call and replayed
    verbatim with the req_id, so replays dedup by (trace_id, span_id)
    exactly like req_ids."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    tid, parent = ctx
    sid = _new_id()
    return {"t": tid, "s": sid, "p": parent}, [tid, sid, parent, time.time()]


def call_event(verb: str, comp: str, state: list, error: bool = False) -> None:
    """Record the client-side verb call as one complete span (the span
    id the wire carried — the server's verb span parents under it)."""
    tid, sid, parent, t0 = state
    rec = {
        "ph": "X",
        "name": f"call:{verb}",
        "comp": comp,
        "ts": round(t0, 6),
        "dur": round(time.time() - t0, 6),
        "trace": tid,
        "span": sid,
    }
    if parent is not None:
        rec["parent"] = parent
    if error:
        rec["error"] = True
    _event(rec)


def activate(tctx) -> "contextvars.Token | None":
    """Server side: enter the trace context a request carried (the verb
    span and everything nested record as children of the wire span)."""
    if not isinstance(tctx, dict):
        return None
    tid, sid = tctx.get("t"), tctx.get("s")
    if not tid:
        return None
    return _CTX.set((tid, sid))


def deactivate(token) -> None:
    if token is None:
        return
    try:
        _CTX.reset(token)
    except ValueError:
        pass  # reset from another task/context: the ctx dies with it


# -- span recording (driven by obs.metrics._SpanCtx) ------------------------


def span_begin() -> "list | None":
    """Open a trace span under the active context; returns opaque state
    for :func:`span_end`, or None when no trace is active.  Callers
    check :func:`enabled` first — this is the slow path."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    tid, parent = ctx
    sid = _new_id()
    tok = _CTX.set((tid, sid))
    return [tid, sid, parent, tok, time.time()]


def span_end(
    state: list, name: str, comp: str,
    level=None, error: bool = False,
) -> None:
    tid, sid, parent, tok, t0 = state
    try:
        _CTX.reset(tok)
    except ValueError:
        pass  # entered/exited across tasks (manually managed span ctx)
    rec = {
        "ph": "X",
        "name": name,
        "comp": comp,
        "ts": round(t0, 6),
        "dur": round(time.time() - t0, 6),
        "trace": tid,
        "span": sid,
    }
    if parent is not None:
        rec["parent"] = parent
    if level is not None:
        rec["level"] = level
    if error:
        rec["error"] = True
    _event(rec)


def instant(name: str, comp: str, trace_id=None, parent=None, **args) -> None:
    """One instant event (chaos faults, plane-frame arrivals,
    heartbeat wedge markers).  ``trace_id``/``parent`` tie it to a span
    when known; otherwise it lands on the component's track only."""
    if not enabled():
        return
    rec = {
        "ph": "i",
        "name": name,
        "comp": comp,
        "ts": round(time.time(), 6),
    }
    if trace_id is not None:
        rec["trace"] = trace_id
    if parent is not None:
        rec["parent"] = parent
    if args:
        rec["args"] = args
    _event(rec)


def wire_tag() -> "tuple | None":
    """(trace_id, span_id) to stamp onto a data-plane frame's session
    header, or None outside any trace."""
    ctx = _CTX.get()
    if ctx is None or ctx[1] is None:
        return None
    return ctx


def note_clock(comp: str, offset_s: float, rtt_s: float) -> None:
    """Record a clock-offset measurement for ``comp`` (NTP-style
    midpoint: server_clock - leader_clock); :func:`merge` applies the
    median per component."""
    if not enabled():
        return
    _event({
        "ph": "C",
        "comp": comp,
        "ts": round(time.time(), 6),
        "off": round(float(offset_s), 6),
        "rtt": round(float(rtt_s), 6),
    })


# ---------------------------------------------------------------------------
# device profiler hooks
# ---------------------------------------------------------------------------


def _profile_path(prof_dir: str, kind: str, level) -> str:
    """One Chrome trace per capture: the process tag, the kind, the level
    and the trace id name it (a sequence number keeps a re-captured level
    apart)."""
    with _LOCK:
        tag = _TAG or "p"
    lvl = "all" if level is None else f"l{int(level)}"
    tid = current_trace_id() or "untraced"
    return os.path.join(
        prof_dir,
        f"fhh_profile_{tag}_{os.getpid()}_{kind}_{lvl}_{tid}_{next(_PROF_SEQ)}.json",
    )


def _clock_mark() -> float:
    """Open and close the zero-length profiler range :data:`CLOCK_RANGE`;
    returns the wall clock (``time.time()``) at it."""
    from torch.profiler import record_function

    wall = time.time()
    with record_function(CLOCK_RANGE):
        pass
    return wall


def _clock_event(prof, wall: float, path: str) -> None:
    """The ring's record of a capture's start: ``ts`` the wall clock at
    its ``fhh.clock`` range, ``prof_ns`` the range's start on the
    profiler's clock (kineto's ns, which the Chrome trace gives less its
    ``baseTimeNanoseconds``), and the capture's path."""
    if wall is None or not enabled():
        return
    prof_ns = next((e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == CLOCK_RANGE), None)
    if prof_ns is not None:
        _event({"ph": "i", "name": CLOCK_RANGE, "comp": "profile",
                "ts": round(wall, 6), "args": {"prof_ns": int(prof_ns), "path": path}})


def _sync_device() -> None:
    """Wait for the device's queued work, so the capture holds it."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_capture(kind: str, level=None):
    """Wrap one crawl (``level=None``) or one crawl level in a
    ``torch.profiler`` capture when ``FHH_PROFILE=<dir>`` is set.  With
    ``FHH_PROFILE_LEVELS=2,5`` only those levels capture (and the
    whole-crawl hook stands down); without it the whole-crawl hook
    captures and the per-level hooks stand down.  The capture records the
    CPU and, with a card, the CUDA activity, synchronises the device
    before it stops, and is written as a Chrome trace recorded with the
    ACTIVE trace id, so the device timeline joins the Perfetto view.  A
    profiler that fails to start degrades the capture, never the crawl.
    Yields True only while a capture is live."""
    prof_dir = os.environ.get(ENV_PROFILE)
    if not prof_dir:
        yield False
        return
    level_spec = os.environ.get(ENV_PROFILE_LEVELS)
    if level_spec:
        try:
            want = {int(x) for x in level_spec.split(",") if x.strip()}
        except ValueError:
            want = set()
        if level is None or int(level) not in want:
            yield False
            return
    elif level is not None:
        yield False  # whole-crawl mode: the per-level hooks stand down
        return
    with _LOCK:
        if _PROF_ACTIVE[0]:  # one profiler session at a time
            yield False
            return
        _PROF_ACTIVE[0] = True
    prof = wall = None
    try:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(prof_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            _sync_device()
            p = profile(activities=acts)
            p.start()
            prof = p
            wall = _clock_mark()
        except Exception as e:  # fhh-lint: disable=broad-except (profiler availability boundary: a missing/busy profiler degrades the capture, never the crawl)
            from . import logs

            logs.emit(
                "profile.unavailable", severity="warn",
                dir=prof_dir, error=f"{type(e).__name__}: {e}",
            )
        yield prof is not None
    finally:
        if prof is not None:
            path = None
            try:
                _sync_device()
                prof.stop()
                path = _profile_path(prof_dir, kind, level)
                prof.export_chrome_trace(path)
                _clock_event(prof, wall, path)
            except Exception as e:  # fhh-lint: disable=broad-except (teardown of a best-effort capture)
                from . import logs

                logs.emit(
                    "profile.export_failed", severity="warn",
                    dir=prof_dir, error=f"{type(e).__name__}: {e}",
                )
                path = None
            cap = {
                "dir": prof_dir,
                "kind": kind,
                "level": None if level is None else int(level),
                "trace": current_trace_id(),
                "ts": round(time.time(), 3),
                "path": path,
            }
            with _LOCK:
                _CAPTURES.append(cap)
            from . import logs

            logs.emit("profile.captured", **cap)
        with _LOCK:
            _PROF_ACTIVE[0] = False


def profile_captures() -> list:
    """Every profiler capture this process recorded (run-report input)."""
    with _LOCK:
        return list(_CAPTURES)


# ---------------------------------------------------------------------------
# merge / validate / CLI
# ---------------------------------------------------------------------------


def load_events(trace_dir: str) -> list:
    """Every event in every ring segment under ``trace_dir`` (rotated
    ``.1`` siblings included), ts-sorted.  Torn tail lines (a process
    killed mid-write) are skipped, not fatal."""
    events = []
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return events
    for name in names:
        # fhh-lint: disable=metric-naming (ring-file prefix, not a series)
        if not (name.startswith("fhh_trace_") and ".jsonl" in name):
            continue
        try:
            with open(os.path.join(trace_dir, name), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail of a killed process
        except OSError:
            continue
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def clock_offsets(events: list) -> dict:
    """component -> best measured offset (seconds): the sample with the
    SMALLEST rtt wins (standard NTP practice — the midpoint error is
    bounded by half the rtt, so the tightest round trip is the most
    trustworthy; a chaos-era sample taken across a reconnect carries a
    huge rtt and loses automatically).  Ties/missing rtt fall back to
    the median.  A component prefix match applies the offset to
    per-session registries too (``server0:tenant`` corrects by
    ``server0``'s)."""
    by_comp: dict = {}
    for e in events:
        if e.get("ph") == "C":
            by_comp.setdefault(e.get("comp", ""), []).append(
                (float(e.get("rtt", math.inf)), float(e.get("off", 0.0)))
            )
    out = {}
    for comp, samples in by_comp.items():
        best_rtt, best_off = min(samples)
        if math.isfinite(best_rtt):
            out[comp] = best_off
        else:  # no rtt recorded anywhere: median of the offsets
            offs = sorted(off for _rtt, off in samples)
            out[comp] = offs[len(offs) // 2]
    return out


def _offset_for(comp: str, offsets: dict) -> float:
    if comp in offsets:
        return offsets[comp]
    base = comp.split(":", 1)[0]
    return offsets.get(base, 0.0)


def to_chrome(events: list) -> dict:
    """Chrome-trace JSON: one pid per component, one tid per
    (component, collection), clock-corrected to leader time."""
    offsets = clock_offsets(events)
    pids: dict = {}
    tids: dict = {}
    out = []

    def pid_of(comp: str) -> int:
        if comp not in pids:
            pids[comp] = len(pids) + 1
            out.append({
                "ph": "M", "name": "process_name", "pid": pids[comp],
                "tid": 0, "args": {"name": comp},
            })
        return pids[comp]

    def tid_of(comp: str, coll: str) -> int:
        key = (comp, coll)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == comp]) + 1
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid_of(comp),
                "tid": tids[key], "args": {"name": coll},
            })
        return tids[key]

    for e in events:
        ph = e.get("ph")
        if ph == "C":
            continue
        comp = e.get("comp", "?")
        coll = comp.split(":", 1)[1] if ":" in comp else "main"
        ts_us = (e.get("ts", 0.0) - _offset_for(comp, offsets)) * 1e6
        args = {
            k: e[k]
            for k in ("trace", "span", "parent", "level", "error")
            if k in e
        }
        args.update(e.get("args") or {})
        rec = {
            "ph": "X" if ph == "X" else "i",
            "name": e.get("name", "?"),
            "pid": pid_of(comp),
            "tid": tid_of(comp, coll),
            "ts": round(ts_us, 1),
            "args": args,
        }
        if ph == "X":
            rec["dur"] = round(max(0.0, e.get("dur", 0.0)) * 1e6, 1)
        else:
            rec["s"] = "t"
        out.append(rec)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"clock_offsets": offsets},
    }


def validate(events: list) -> dict:
    """Structural gate over raw events (pre-merge form): every parented
    event's parent span exists within its trace, no negative durations,
    finite clock offsets.  Returns {ok, errors, spans, traces, ...}."""
    errors = []
    spans_by_trace: dict = {}
    comps = set()
    for e in events:
        comps.add(e.get("comp", "?"))
        if e.get("ph") == "X" and e.get("trace"):
            spans_by_trace.setdefault(e["trace"], set()).add(e.get("span"))
    n_spans = 0
    for e in events:
        ph = e.get("ph")
        if ph == "C":
            off = e.get("off")
            if off is None or abs(float(off)) > 86400:
                errors.append(f"implausible clock offset: {e}")
            continue
        tid = e.get("trace")
        if ph == "X":
            n_spans += 1
            if float(e.get("dur", 0.0)) < 0:
                errors.append(f"negative duration: {e}")
        if tid is None:
            continue  # untraced instants (heartbeat/chaos markers)
        parent = e.get("parent")
        if parent is not None and parent not in spans_by_trace.get(tid, ()):
            errors.append(
                f"orphan {ph} event {e.get('name')!r} (comp "
                f"{e.get('comp')!r}): parent {parent!r} not found in "
                f"trace {tid!r}"
            )
    return {
        "ok": not errors,
        "errors": errors[:50],
        "spans": n_spans,
        "traces": sorted(spans_by_trace),
        "components": sorted(comps),
    }


def captures_on_timeline(events: list, next_pid: int) -> list:
    """The Chrome events of every profiler capture whose ``fhh.clock``
    record is in ``events``, shifted onto the ring's timeline (µs of the
    wall clock), one process each from ``next_pid`` on.  A capture file
    that is gone or unreadable is skipped."""
    out = []
    for e in events:
        args = e.get("args") or {}
        if e.get("name") != CLOCK_RANGE or "prof_ns" not in args:
            continue
        try:
            with open(args["path"], encoding="utf-8") as f:
                cap = json.load(f)
        except (OSError, ValueError):
            continue
        # the range's profiler time is the ring's wall time at it
        base = int(cap.get("baseTimeNanoseconds", 0))
        shift = e["ts"] * 1e6 - (args["prof_ns"] - base) / 1e3
        pids: dict = {}
        for ce in cap.get("traceEvents", []):
            if ce.get("ph") == "M" and ce.get("name") == "process_name":
                continue
            ce = dict(ce)
            if ce.get("pid") not in pids:
                pids[ce.get("pid")] = next_pid
                out.append({"ph": "M", "name": "process_name", "pid": next_pid, "tid": 0,
                            "args": {"name": f"{os.path.basename(args['path'])}:"
                                             f"{ce.get('pid')}"}})
                next_pid += 1
            ce["pid"] = pids[ce.get("pid")]
            if isinstance(ce.get("ts"), (int, float)):
                ce["ts"] = round(ce["ts"] + shift, 3)
            out.append(ce)
    return out


def merge(trace_dir: str, out_path: str) -> dict:
    """Load every ring under ``trace_dir``, validate, and write the
    merged Perfetto/Chrome trace to ``out_path``, with the profiler
    captures the rings name shifted onto its timeline
    (:func:`captures_on_timeline`).  Returns the validation verdict (plus
    event counts)."""
    events = load_events(trace_dir)
    verdict = validate(events)
    doc = to_chrome(events)
    pids = [ev["pid"] for ev in doc["traceEvents"]]
    doc["traceEvents"] += captures_on_timeline(events, max(pids, default=0) + 1)
    tmp = f"{out_path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    verdict["events"] = len(events)
    verdict["out"] = out_path
    return verdict


def _main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="fuzzyheavyhitters_torch.obs.trace",
        description="merge/validate fhh-trace rings",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("merge", "validate"):
        sp = sub.add_parser(name)
        sp.add_argument(
            "-d", "--dir", default=os.environ.get(ENV_DIR),
            help="trace dir (default: $FHH_TRACE_DIR)",
        )
        if name == "merge":
            sp.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)
    if not args.dir:
        sys.stderr.write("no trace dir (pass -d or set FHH_TRACE_DIR)\n")
        return 2
    if args.cmd == "merge":
        out = args.out or os.path.join(args.dir, "trace.json")
        verdict = merge(args.dir, out)
    else:
        verdict = validate(load_events(args.dir))
    sys.stdout.write(json.dumps(verdict, indent=1) + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
