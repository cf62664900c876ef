"""Entry points: ``mesh`` (one process, or two on the device mesh),
``server`` and ``leader`` (the socket deployment).

Their events go through ``obs.emit`` (``obs/logs.py``: human lines on
standard error by default; ``FHH_LOG_FORMAT=json`` and
``FHH_LOG_STREAM=stdout`` give one JSON object a line, keys ``ts``, ``sev``,
``event``), and each runs under ``obs.exit_report`` (``FHH_RUN_REPORT``,
``FHH_TRACE_DIR``, ``FHH_PROFILE``, ``FHH_HEARTBEAT_S``, as the JAX
binaries read them).  The switches of the live plane and the sanitizers act
as in the JAX binaries: ``server`` and ``leader`` serve ``/metrics`` on
``FHH_METRICS_PORT`` (base + 1 / 2 for server 0 / 1, + 0 for the leader,
started before the arguments are checked; ``FHH_METRICS_HOST``), the
``FHH_ALERT_*`` thresholds tune the alert rules, ``FHH_DEBUG_GUARDS=1``
(or the config's ``debug_guards: true``) arms the lock-discipline
sanitizer and ``FHH_DEBUG_TAINT=1`` the taint sanitizer.  ``mesh`` starts
no exporter, as the JAX ``bin/mesh`` starts none.
"""
