"""Entry points: ``mesh`` (one process, or two on the device mesh),
``server`` and ``leader`` (the socket deployment).

The JAX binaries read observability and sanitizer switches that the port
does not have yet.  Each binary here refuses them by name at start-up
(:func:`refuse_unported_switches`) rather than ignore them, so a user who
asks for a report, an exporter, a trace or a sanitizer is told it is not
there: every ``FHH_*`` variable of :data:`UNPORTED_SWITCHES` set to a
non-empty value, every ``FHH_ALERT_*``, ``FHH_LOG_FORMAT`` unless it is
``json`` (the port prints JSON lines), and, for a server and a leader, the
config's ``debug_guards: true``.
"""

from __future__ import annotations

import os

from ..utils import config as configmod

OBSERVABILITY = "observability (queued as slice 14)"
SANITIZERS = configmod.SANITIZERS

# the JAX binaries' switches, each with the layer that reads it there and the
# part of the port that will bring it
UNPORTED_SWITCHES = {
    "FHH_RUN_REPORT": ("the run report, obs/report.py", OBSERVABILITY),
    "FHH_METRICS_PORT": ("the metrics exporter, obs/ops.py", OBSERVABILITY),
    "FHH_TRACE_DIR": ("distributed tracing, obs/trace.py", OBSERVABILITY),
    "FHH_PROFILE": ("the profiler hooks, obs/trace.py", OBSERVABILITY),
    "FHH_LOG_STREAM": ("the log sinks, obs/logs.py", OBSERVABILITY),
    "FHH_LOG_LEVEL": ("log severity filtering, obs/logs.py", OBSERVABILITY),
    "FHH_LOG_FORMAT": ("log formats other than json, obs/logs.py", OBSERVABILITY),
    "FHH_HEARTBEAT_S": ("the heartbeat, obs/heartbeat.py", OBSERVABILITY),
    "FHH_ALERT_*": ("alerting, obs/alerts.py", OBSERVABILITY),
    "FHH_DEBUG_GUARDS": ("the lock-discipline sanitizer, utils/guards.py", SANITIZERS),
    "FHH_DEBUG_TAINT": ("the taint sanitizer, utils/taint_guard.py", SANITIZERS),
}


def refuse_unported_switches() -> None:
    """Raise ``NotImplementedError`` naming the first unported switch the
    environment sets (the config's ``debug_guards`` is
    ``utils.config.refuse_debug_guards``')."""
    for var, (layer, part) in UNPORTED_SWITCHES.items():
        names = ([k for k in sorted(os.environ) if k.startswith(var[:-1])]
                 if var.endswith("*") else [var])
        for name in names:
            val = os.environ.get(name)
            if not val or (name == "FHH_LOG_FORMAT" and val == "json"):
                continue
            raise NotImplementedError(f"{name}={val}: {layer} is not ported to PyTorch yet; "
                                      f"it belongs to {part}")
