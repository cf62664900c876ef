"""Structured log emission: human-readable lines or JSON-lines (the port of
``fuzzyheavyhitters_tpu/obs/logs.py``: the same knobs, defaults and record
keys).

One function, :func:`emit`, replaces every crawl-path ``print``:

    emit("crawl.done", seconds=3.21)
    emit("level.phases", severity="debug", level=5, fss=0.12, ...)

Human mode (default) renders one aligned line per event::

    [fhh 12:33:02 info] crawl.done seconds=3.21

JSON-lines mode (``FHH_LOG_FORMAT=json`` or ``configure(fmt="json")``)
renders the same event as one JSON object per line with an epoch ``ts``
— machine-parseable without scraping free-text (numpy scalars are
coerced to plain Python numbers so the lines round-trip through
``json.loads``).

The stream defaults to stderr so stdout stays a clean program-output
channel; ``FHH_LOG_STREAM`` accepts ``stdout`` / ``stderr`` / a file
path.  Severity gating (``FHH_LOG_LEVEL``, default ``info``) is what
lets the per-level phase breakdown ride at ``debug`` without spamming a
512-level crawl's console.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from ..utils import taint_guard

_SEVERITIES = {"debug": 10, "info": 20, "warn": 30, "error": 40}

# RLock: emit() holds it across _resolve_stream, which takes it again
# around the _opened mutations so it is ALSO safe called standalone
_lock = threading.RLock()
_cfg = {
    "fmt": os.environ.get("FHH_LOG_FORMAT", "human"),
    "stream": os.environ.get("FHH_LOG_STREAM", "stderr"),
    "min_severity": _SEVERITIES.get(
        os.environ.get("FHH_LOG_LEVEL", "info"), 20
    ),
}
_opened: dict = {"path": None, "file": None}  # fhh-guard: _opened=_lock


def configure(fmt: str | None = None, stream=None, min_severity: str | None = None):
    """Override the env-derived config (tests pass a StringIO ``stream``)."""
    with _lock:
        if fmt is not None:
            if fmt not in ("human", "json"):
                raise ValueError(f"unknown log format {fmt!r}")
            _cfg["fmt"] = fmt
        if stream is not None:
            _cfg["stream"] = stream
        if min_severity is not None:
            _cfg["min_severity"] = _SEVERITIES[min_severity]


def _resolve_stream():
    s = _cfg["stream"]
    if s == "stderr":
        return sys.stderr
    if s == "stdout":
        return sys.stdout
    if isinstance(s, str):  # file path: open once, append, keep open
        with _lock:  # reentrant from emit(); guards _opened standalone too
            if _opened["path"] != s:
                if _opened["file"] is not None:
                    try:
                        _opened["file"].close()
                    except OSError:
                        pass
                # record the attempt BEFORE opening: a bad path must degrade
                # to stderr once, not re-raise out of every emit — a telemetry
                # knob misconfiguration may never take down the crawl
                _opened["path"] = s
                try:
                    _opened["file"] = open(s, "a", buffering=1)
                except OSError as e:
                    _opened["file"] = None
                    sys.stderr.write(
                        f"[fhh] cannot open log stream {s!r} ({e}); "
                        "falling back to stderr\n"
                    )
            return _opened["file"] if _opened["file"] is not None else sys.stderr
    return s  # a file-like object (tests)


def _plain(v):
    """Coerce numpy scalars/0-d arrays so JSON lines round-trip; dicts,
    lists and tuples keep their structure (the port's binaries put whole
    sections, such as ``server.exit``'s ``sessions``, on one line)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if getattr(v, "ndim", 0) > 0 and hasattr(v, "tolist"):
        return _plain(v.tolist())
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    try:
        return v.item()  # numpy scalar types
    except (AttributeError, ValueError):
        return str(v)


def emit(event: str, severity: str = "info", **fields) -> None:
    sev = _SEVERITIES.get(severity, 20)
    with _lock:
        if sev < _cfg["min_severity"]:
            return
        stream = _resolve_stream()
        if _cfg["fmt"] == "json":
            rec = {"ts": round(time.time(), 3), "sev": severity, "event": event}
            rec.update({k: _plain(v) for k, v in fields.items()})
            # correlate log lines with the distributed trace: when
            # fhh-trace is on and this task runs under a trace context,
            # the line carries the trace id (grep the JSONL for it to
            # jump from a log event to the Perfetto timeline)
            if "trace" not in rec:
                from . import trace as _trace  # lazy: avoid import cycle

                if _trace.enabled():
                    tid = _trace.current_trace_id()
                    if tid is not None:
                        rec["trace"] = tid
            line = json.dumps(rec)
        else:
            kv = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={_plain(v)}"
                for k, v in fields.items()
            )
            ts = time.strftime("%H:%M:%S")
            line = f"[fhh {ts} {severity}] {event}" + (f" {kv}" if kv else "")
        # the rendered line (either format) is the sink: the taint
        # sanitizer checks it once, here
        taint_guard.check(line, sink="log-emit")
        try:
            stream.write(line + "\n")
            stream.flush()
        except (ValueError, OSError):
            pass  # stream closed (interpreter teardown / redirected tests)
