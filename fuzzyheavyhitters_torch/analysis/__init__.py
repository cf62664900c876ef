"""fhh-lint: AST-based static analysis for this codebase's invariants.

A dependency-free lint framework (``ast`` + ``tokenize`` only — it never
imports torch or the modules under lint) enforcing the invariant
families that are easiest to miss by eye:

- **trace-safety / performance** — no host synchronization on the
  per-level crawl path, no per-call torch.compile wrapper churn
  (``host-sync-in-hot-loop``, ``recompile-churn``);
- **secret hygiene** — seeds, correction words, GC labels, and MAC keys
  never flow into logs, metrics, stdout, or exception messages
  (``secret-to-sink``);
- **thread safety + failure honesty** — module-level shared state only
  written under its registered lock; no silent catch-alls; no bare
  print telemetry (``unguarded-shared-state``, ``broad-except``,
  ``bare-print``);
- **asyncio lock discipline** — the interprocedural fhh-race pair
  (:mod:`.concurrency`): guard-mapped shared attributes accessed only
  with their owning lock provably held, and no guarded snapshot used
  across a suspension point the lock did not cover
  (``guarded-state-unlocked``, ``stale-read-across-await``), validated
  at runtime by the ``FHH_DEBUG_GUARDS`` sanitizer
  (:mod:`fuzzyheavyhitters_torch.utils.guards`).

Usage::

    python -m fuzzyheavyhitters_torch.analysis [paths] \
        [--format human|json] [--strict] [--update-baseline]

Inline suppression: ``# fhh-lint: disable=<rule>[,<rule>]`` on the
offending line (or alone on the line above).  Grandfathered findings
live in ``lint_baseline_torch.json`` as per-(rule, file) counts that must not
grow; see :mod:`.baseline`.  Config: ``[tool.fhh-lint]`` in
lint_torch.toml (:mod:`.config`).
"""

from .baseline import apply_baseline, load_baseline, write_baseline
from .config import LintConfig, find_repo_root, load_config
from .engine import Finding, Rule, SourceModule, lint_paths, lint_source
from .rules import ALL_RULES, RULES_BY_NAME

__all__ = [
    "ALL_RULES",
    "Finding",
    "LintConfig",
    "Rule",
    "RULES_BY_NAME",
    "SourceModule",
    "apply_baseline",
    "find_repo_root",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "load_config",
    "write_baseline",
]
