"""Entry points: ``mesh`` (one process, or two on the device mesh),
``server`` and ``leader`` (the socket deployment).

Their events go through ``obs.emit`` (``obs/logs.py``: human lines on
standard error by default; ``FHH_LOG_FORMAT=json`` and
``FHH_LOG_STREAM=stdout`` give one JSON object a line, keys ``ts``, ``sev``,
``event``), and each runs under ``obs.exit_report`` (``FHH_RUN_REPORT``,
``FHH_TRACE_DIR``, ``FHH_PROFILE``, ``FHH_HEARTBEAT_S``, as the JAX
binaries read them).  The JAX binaries' switches of the layers the port
does not have yet are refused by name at start-up
(:func:`refuse_unported_switches`) rather than ignored, so a user who asks
for an exporter, an alert or a sanitizer is told it is not there: every
``FHH_*`` variable of :data:`UNPORTED_SWITCHES` set to a non-empty value,
every ``FHH_ALERT_*``, and, for a server and a leader, the config's
``debug_guards: true``.
"""

from __future__ import annotations

import os

from ..utils import config as configmod

LIVE_PLANE = "the live plane (queued as slice 15)"
SANITIZERS = configmod.SANITIZERS

# the JAX binaries' switches, each with the layer that reads it there and the
# part of the port that will bring it
UNPORTED_SWITCHES = {
    "FHH_METRICS_PORT": ("the metrics exporter, obs/exporter.py", LIVE_PLANE),
    "FHH_ALERT_*": ("alerting, obs/alerts.py", LIVE_PLANE),
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
            if not val:
                continue
            raise NotImplementedError(f"{name}={val}: {layer} is not ported to PyTorch yet; "
                                      f"it belongs to {part}")
