"""Telemetry for the port (``fuzzyheavyhitters_tpu/obs/`` ported): the same
metric, span and report names, ``FHH_*`` knobs, file layouts, trace event
format and exposition series, so a run report, trace or scrape of either
package reads alike and their traces merge into one timeline.

- :mod:`.metrics` — named counters, gauges and phase timers with
  level-indexed breakdowns, grouped into per-component ``Registry``
  objects (each collector server and collection, the drivers, the RPC
  leader, the windowed ingest, the mesh leader and the fleet placer own
  theirs), plus spans that mark "what is running now" for the heartbeat.
- :mod:`.hist` — fixed-bucket latency histograms (the JAX package's
  bounds, so snapshots merge across packages) behind the ``slo``
  sections of ``status`` and the run report.
- :mod:`.logs` — structured log lines: human by default, JSON-lines with
  ``FHH_LOG_FORMAT=json``; ``FHH_LOG_STREAM`` and ``FHH_LOG_LEVEL``.
- :mod:`.heartbeat` — a daemon thread logging every live registry's
  active span every ``FHH_HEARTBEAT_S`` seconds.
- :mod:`.trace` — cross-process tracing: a trace id per crawl or window,
  a span id per verb, a JSONL ring per process under ``FHH_TRACE_DIR``,
  ``python -m fuzzyheavyhitters_torch.obs.trace merge``; ``FHH_PROFILE``
  (``FHH_PROFILE_LEVELS``) adds ``torch.profiler`` captures keyed to the
  same trace ids.
- :mod:`.devmem` — device memory from ``torch.cuda`` (in use, watermark,
  delta, capacity), key-plane bytes, and the fresh ``nvcc`` build counter.
- :mod:`.report` — the end-of-run report (``FHH_RUN_REPORT``), schema
  ``fhh-run-report/1``, with the fired alerts in its ``alerts`` section.
- :mod:`.exporter` — the live plane: a Prometheus ``/metrics`` endpoint
  (``FHH_METRICS_PORT``: base + 0 / 1 / 2 for ``leader`` / ``s0`` / ``s1``,
  ``0`` an ephemeral port; ``FHH_METRICS_HOST``, loopback by default; one
  ``getenv`` when unset) serving every live registry's counters, gauges,
  timers and histograms, plus producers' lines (a server's session rows).
- :mod:`.alerts` — threshold rules (tenant stall, SLO burn, ingest backlog,
  a kernel build after the warmup, device memory high water, a stuck fleet
  migration; ``FHH_ALERT_*``) fired once a subject into the logs, the trace
  ring, ``status.alerts`` and the run report.
- :mod:`.ops` — ``python -m fuzzyheavyhitters_torch.obs.ops top [--once]
  [--targets host:port,...]``: one screen over the three processes'
  scrapes.

Every sink here (log line, trace record, run report, exposition document,
alert) is checked by the taint sanitizer (``utils/taint_guard.py``,
``FHH_DEBUG_TAINT=1``).
"""

from . import alerts, devmem, exporter, trace
from .heartbeat import start_heartbeat, stop_heartbeat
from .hist import Histogram
from .logs import configure as configure_logs, emit
from .metrics import Registry, all_registries, default_registry
from .report import (
    claim_report_path,
    exit_report,
    maybe_write_run_report,
    per_process_report_path,
    run_report,
    write_run_report,
)

__all__ = [
    "Histogram",
    "Registry",
    "alerts",
    "all_registries",
    "claim_report_path",
    "devmem",
    "exporter",
    "configure_logs",
    "default_registry",
    "emit",
    "exit_report",
    "maybe_write_run_report",
    "per_process_report_path",
    "run_report",
    "start_heartbeat",
    "stop_heartbeat",
    "trace",
    "write_run_report",
]
