"""Declarative alert rules over the live telemetry plane (the port of
``fuzzyheavyhitters_tpu/obs/alerts.py``: the same rules, thresholds, subjects
and surfaces).

Each failure mode known in advance — a wedged tenant, an SLO burn, an
ingest front door backing up, a kernel build past the warmup, device memory
near capacity, a stuck fleet migration — is a named, threshold-gated rule
over the data the exporter and the ``status`` verb already read, so its
first occurrence is a structured event in the logs and the trace ring (and
the ``status.alerts`` and run-report ``alerts`` rollups).

======================  ==============================  =====================
rule                    threshold env (default)         fires when
======================  ==============================  =====================
``tenant_stall``        ``FHH_ALERT_STALL_S`` (120)     a session's
                                                        ``last_progress_s``
                                                        exceeds the gap
``slo_burn``            ``FHH_ALERT_LEVEL_P95_S`` (2)   ``level_latency`` p95
                                                        over budget
``ingest_backlog``      ``FHH_ALERT_BACKLOG_KEYS``      a session's unsealed
                        (100000)                        queue depth exceeds
                                                        the bound
``recompile_after_      (none: any)                     ``fresh_compiles_post_
warmup``                                                warmup`` > 0: an
                                                        ``nvcc`` build after
                                                        the warmup (devmem)
``hbm_high_water``      ``FHH_ALERT_HBM_FRAC`` (0.9)    the larger of in-use
                                                        and the watermark (the
                                                        allocator's peak) over
                                                        capacity, over the
                                                        fraction (skipped
                                                        where no capacity is
                                                        known: the CPU)
``migration_stuck``     ``FHH_ALERT_MIGRATION_STUCK_S`` the fleet placer's
                        (120)                           ``migration_inflight_
                                                        since`` gauge older
                                                        than the budget
======================  ==============================  =====================

Fire once: an alert is keyed ``(rule, subject)`` and fires once a process;
the log line, the trace instant and the rollup entry mark the transition.
The fired list (bounded at 256, the oldest dropped and counted) stays
readable by ``status`` and the run report for the life of the process.
Thresholds are read at each evaluation.

Evaluation is pulled: the exporter runs the registry rules at each scrape,
the collector's ``status`` verb and its /metrics producer run the session
rules over the rows they build.  No thread, no timer.
"""


from __future__ import annotations

import os
import threading
import time

from . import logs
from . import trace as _trace
from ..utils import taint_guard
from .metrics import all_registries

# env knob -> default threshold; read per evaluation so tests (and a
# live operator) can retune without a process restart
ENV_STALL_S = ("FHH_ALERT_STALL_S", 120.0)
ENV_LEVEL_P95_S = ("FHH_ALERT_LEVEL_P95_S", 2.0)
ENV_BACKLOG_KEYS = ("FHH_ALERT_BACKLOG_KEYS", 100000.0)
ENV_HBM_FRAC = ("FHH_ALERT_HBM_FRAC", 0.9)
ENV_MIGRATION_STUCK_S = ("FHH_ALERT_MIGRATION_STUCK_S", 120.0)

_MAX_FIRED = 256  # rollup bound: alerts are transitions, not a log

_lock = threading.Lock()
_fired: list = []  # fhh-guard: _fired=_lock
_seen: set = set()  # fhh-guard: _seen=_lock
_dropped = 0  # fhh-guard: _dropped=_lock


def _threshold(knob: tuple[str, float]) -> float:
    env, default = knob
    raw = os.environ.get(env)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _fire(rule: str, subject: str, **ctx) -> None:
    global _dropped
    # alert subjects/context cross to logs + trace + the /metrics
    # exposition: assert no registered secret buffer rides along
    taint_guard.check((subject, ctx), sink="alert-fire")
    with _lock:
        if (rule, subject) in _seen:
            return
        _seen.add((rule, subject))
        rec = {"rule": rule, "subject": subject, "ts": round(time.time(), 3)}
        rec.update(ctx)
        _fired.append(rec)
        if len(_fired) > _MAX_FIRED:
            del _fired[0]
            _dropped += 1
    logs.emit(f"alert.{rule}", severity="warn", subject=subject, **ctx)
    if _trace.enabled():
        _trace.instant(f"alert:{rule}", "alerts", subject=subject, **ctx)


# -- rule evaluation -------------------------------------------------------


def evaluate_registries(regs=None) -> None:
    """The registry-walk rules: SLO burn, post-warmup recompiles, HBM
    high water.  Reads only thread-safe registry accessors."""
    p95_budget = _threshold(ENV_LEVEL_P95_S)
    hbm_frac = _threshold(ENV_HBM_FRAC)
    for reg in (regs if regs is not None else all_registries()):
        h = reg.hist("level_latency")
        if h is not None and h.count > 0:
            p95 = h.quantile(0.95)
            if p95 is not None and p95 > p95_budget:
                _fire(
                    "slo_burn", reg.name,
                    p95_s=round(p95, 4), budget_s=p95_budget,
                    samples=h.count,
                )
        post = reg.counter_value("fresh_compiles_post_warmup")
        if post:
            _fire("recompile_after_warmup", reg.name, compiles=int(post))
        in_use = max(reg.gauge_value("hbm_in_use_bytes") or 0,
                     reg.gauge_value("hbm_watermark_bytes") or 0)
        limit = reg.gauge_value("hbm_limit_bytes")
        if in_use and limit and in_use / limit > hbm_frac:
            _fire(
                "hbm_high_water", reg.name,
                in_use_bytes=int(in_use), limit_bytes=int(limit),
                frac=round(in_use / limit, 4), budget_frac=hbm_frac,
            )
        # stuck migration: the fleet placer sets this gauge to the
        # attempt's start instant and clears it to 0 on ANY outcome
        # (protocol/fleet.py) — a nonzero value older than the budget
        # means a transfer wedged mid-flight (source still authoritative,
        # destination half-imported: operator attention, not silence)
        since = reg.gauge_value("migration_inflight_since")
        if since:
            stuck_s = _threshold(ENV_MIGRATION_STUCK_S)
            age = time.time() - float(since)
            if age > stuck_s:
                _fire(
                    "migration_stuck", reg.name,
                    inflight_s=round(age, 3), budget_s=stuck_s,
                )


def evaluate_sessions(rows: dict, source: str) -> None:
    """The session-row rules over ``status.sessions.per_session`` rows
    (the collector builds them; ``source`` names the server so the
    fire-once key stays per-process-per-tenant)."""
    stall_s = _threshold(ENV_STALL_S)
    backlog = _threshold(ENV_BACKLOG_KEYS)
    for key, row in rows.items():
        subject = f"{source}/{key}"
        gap = row.get("last_progress_s")
        if gap is not None and gap > stall_s:
            _fire(
                "tenant_stall", subject,
                last_progress_s=gap, budget_s=stall_s,
                phase=row.get("phase"), level=row.get("level"),
            )
        depth = row.get("queue_depth")
        if depth is not None and depth > backlog:
            _fire(
                "ingest_backlog", subject,
                queue_depth=int(depth), budget_keys=int(backlog),
            )


# -- read sides ------------------------------------------------------------


def fired() -> list:
    """Every alert fired so far in this process (bounded; oldest beyond
    the cap are dropped and counted)."""
    with _lock:
        return list(_fired)


def status_section() -> dict:
    """The ``status.alerts`` rollup: bounded, newest last."""
    with _lock:
        return {
            "count": len(_seen),
            "dropped": _dropped,
            "fired": list(_fired),
        }


def report_section() -> dict | None:
    """The run-report ``alerts`` section — None when nothing ever fired
    (pre-alert reports keep their exact old shape)."""
    with _lock:
        if not _seen:
            return None
        return {
            "count": len(_seen),
            "dropped": _dropped,
            "fired": list(_fired),
        }


def metrics_lines() -> list[str]:
    """Alert state as exposition lines for the /metrics exporter (which
    also calls :func:`evaluate_registries` per scrape)."""
    from . import exporter  # late: exporter imports hist/metrics only

    with _lock:
        recs = list(_fired)
    by_rule: dict[str, int] = {}
    for rec in recs:
        by_rule[rec["rule"]] = by_rule.get(rec["rule"], 0) + 1
    lines = ["# TYPE fhh_alerts_fired_total counter"]
    for rule in sorted(by_rule):
        lines.append(
            f'fhh_alerts_fired_total{{rule="{exporter._esc(rule)}"}}'
            f" {by_rule[rule]}"
        )
    lines.append("# TYPE fhh_alert_active gauge")
    for rec in recs:
        lines.append(
            f'fhh_alert_active{{rule="{exporter._esc(rec["rule"])}",'
            f'subject="{exporter._esc(rec["subject"])}"}} 1'
        )
    return lines


def _reset_for_tests() -> None:
    global _dropped
    with _lock:
        _fired.clear()
        _seen.clear()
        _dropped = 0
