"""Heartbeat: a daemon thread that names the phase a wedged run died in (the
port of ``fuzzyheavyhitters_tpu/obs/heartbeat.py``).

Every ``interval`` seconds it walks the live registries and emits one
``heartbeat`` event per ACTIVE span (registry name, span name, level,
elapsed seconds), or a single idle heartbeat when nothing is running —
so an rc=124 postmortem reads the log tail and sees, e.g.::

    [fhh 04:12:07 info] heartbeat registry=server0 span=gc_ot level=311 elapsed_s=412.0312

instead of silence.

``start_heartbeat`` is a module-level singleton: binaries call it
unconditionally with their default period and ``FHH_HEARTBEAT_S``
overrides (``0`` disables).  The thread is a daemon AND stops cleanly
via :func:`stop_heartbeat` (tests assert both: it fires, and it stops).
"""

from __future__ import annotations

import os
import threading

from . import logs, metrics
from . import trace as tracemod


class Heartbeat(threading.Thread):
    def __init__(self, interval: float):
        super().__init__(name="fhh-heartbeat", daemon=True)
        self.interval = interval
        self._stop_evt = threading.Event()

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval):
            self.beat()

    def beat(self) -> None:
        """One heartbeat sweep (factored out so tests can fire it
        synchronously)."""
        active = False
        for reg in metrics.all_registries():
            sp = reg.current_span()
            if sp is None:
                continue
            active = True
            logs.emit(
                "heartbeat",
                registry=reg.name,
                span=sp.name,
                level=sp.level,
                elapsed_s=sp.elapsed(),
            )
            # wedge markers in the merged trace: a heartbeat instant per
            # active span puts "what was running" on the Perfetto
            # timeline even when the process never exits cleanly
            if tracemod.enabled():
                tracemod.instant(
                    "heartbeat", comp=reg.name,
                    span=sp.name, level=sp.level,
                    elapsed_s=round(sp.elapsed(), 3),
                )
        if not active:
            logs.emit("heartbeat", idle=True)

    def stop(self) -> None:
        self._stop_evt.set()


_hb_lock = threading.Lock()
_hb: Heartbeat | None = None  # fhh-guard: _hb=_hb_lock


def start_heartbeat(default_s: float = 30.0) -> Heartbeat | None:
    """Start (or return) the process heartbeat.  ``FHH_HEARTBEAT_S``
    overrides ``default_s``; a period <= 0 disables and returns None."""
    global _hb
    try:
        interval = float(os.environ.get("FHH_HEARTBEAT_S", default_s))
    except ValueError:
        interval = default_s
    if interval <= 0:
        return None
    with _hb_lock:
        if _hb is None or not _hb.is_alive():
            _hb = Heartbeat(interval)
            _hb.start()
        return _hb


def stop_heartbeat() -> None:
    global _hb
    with _hb_lock:
        if _hb is not None:
            _hb.stop()
            _hb = None
