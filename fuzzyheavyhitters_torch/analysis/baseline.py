"""Baseline machinery: grandfathered findings, count-bounded per file.

The baseline is a checked-in JSON document keyed by (rule, path) with a
COUNT, not line numbers — line-keyed baselines rot on every unrelated
edit, while a count expresses exactly the contract the repo wants:
*"this file carries N known findings of this rule; the number must not
grow."*  Shrinking is celebrated (``stale`` entries in the report tell
you to run ``--update-baseline`` and bank the win); growing fails the
lint.

Schema::

    {
      "schema": "fhh-lint-baseline/1",
      "counts": {"<rule>": {"<relpath>": <count>, ...}, ...}
    }

Matching: findings are grouped by (rule, path); the first ``count`` (in
line order) are absorbed, the rest are NEW.  When the group has fewer
findings than its baseline entry, the surplus is reported as stale.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

SCHEMA = "fhh-lint-baseline/1"


@dataclass
class BaselineResult:
    new: list = field(default_factory=list)  # findings not absorbed
    absorbed: int = 0
    stale: list = field(default_factory=list)  # (rule, path, extra) entries


def load_baseline(path: str) -> dict:
    """-> counts dict {rule: {path: count}}; empty when absent."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"unrecognized baseline schema {doc.get('schema')!r} in {path}"
        )
    counts = doc.get("counts", {})
    return {
        rule: {p: int(n) for p, n in paths.items()}
        for rule, paths in counts.items()
    }


def write_baseline(path: str, findings, keep: dict | None = None) -> dict:
    """Rewrite the baseline to the current findings' counts.  ``keep``
    merges in existing entries that must survive the rewrite (the CLI
    passes the counts of files OUTSIDE the scanned path set, so a partial
    ``--update-baseline`` run cannot erase another subtree's grandfathered
    findings)."""
    counts: dict = {}
    for rule, paths in (keep or {}).items():
        for p, n in paths.items():
            if n:
                counts.setdefault(rule, {})[p] = int(n)
    for f in findings:
        counts.setdefault(f.rule, {})
        counts[f.rule][f.path] = counts[f.rule].get(f.path, 0) + 1
    doc = {
        "schema": SCHEMA,
        "counts": {
            rule: dict(sorted(paths.items()))
            for rule, paths in sorted(counts.items())
        },
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def removed_rules(counts: dict, known_rules) -> list:
    """``(rule, files, findings)`` for baseline entries whose rule id no
    longer names a registered rule.  A rule RENAME used to read as a
    silent shrink at ``--update-baseline`` time — the old id's entries
    just vanished from the rewritten file, indistinguishable from a
    genuine burn-down — so the CLI now names every dropped id loudly and
    tells the operator to check the successor id carries its own
    entries."""
    return [
        (rule, len(paths), sum(paths.values()))
        for rule, paths in sorted(counts.items())
        if rule not in known_rules and paths
    ]


def apply_baseline(findings, counts: dict, scanned=None) -> BaselineResult:
    """Split findings into absorbed-vs-new under the baseline counts.

    ``scanned`` (a set of relpaths, when given) bounds the STALE check to
    files this run actually linted — a partial-scope run must not report
    an unscanned subtree's grandfathered entries as burn-down wins."""
    res = BaselineResult()
    groups: dict = {}
    for f in findings:
        groups.setdefault((f.rule, f.path), []).append(f)
    for (rule, path), group in sorted(groups.items()):
        allowed = counts.get(rule, {}).get(path, 0)
        group.sort(key=lambda f: f.line)
        res.absorbed += min(allowed, len(group))
        res.new.extend(group[allowed:])
    for rule, paths in counts.items():
        for path, allowed in paths.items():
            if scanned is not None and path not in scanned:
                continue  # outside this run's scope: no verdict either way
            have = len(groups.get((rule, path), ()))
            if have < allowed:
                res.stale.append((rule, path, allowed - have))
    res.new.sort(key=lambda f: (f.path, f.line, f.rule))
    res.stale.sort()
    return res
