"""fhh-lint CLI: ``python -m fuzzyheavyhitters_torch.analysis [paths ...]``.

Exit codes: 0 clean (every finding suppressed or baselined), 1 new
findings at/above the failure threshold (``error`` by default; any
severity under ``--strict``), 2 usage or internal error.

``--format json`` emits one machine-readable document on stdout (the
artifact scripts/lint_torch.sh archives); human mode prints one line per
finding plus a summary.  ``--update-baseline`` rewrites the baseline to
the current tree's findings and exits 0 — the burn-down workflow is:
fix findings, run ``--update-baseline``, commit the shrunken file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .baseline import (
    apply_baseline,
    load_baseline,
    removed_rules,
    write_baseline,
)
from .config import find_repo_root, load_config
from .engine import expand_paths, iter_python_files, lint_paths
from .rules import RULES_BY_NAME


def _out(line: str, err: bool = False) -> None:
    """One line of the CLI's program output to stdout (stderr with
    ``err``); the port's package keeps no bare ``print``."""
    (sys.stderr if err else sys.stdout).write(f"{line}\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fuzzyheavyhitters_torch.analysis",
        description="fhh-lint: AST static analysis for trace-safety, "
        "secret hygiene, and thread safety",
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: from config)",
    )
    p.add_argument(
        "--format",
        choices=("human", "json"),
        default="human",
        help="output format (default: human)",
    )
    p.add_argument(
        "--strict",
        action="store_true",
        help="fail on ANY new finding, warnings included",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help="baseline JSON path (default: from config, repo-relative)",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline: every finding is new",
    )
    p.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to the current findings and exit 0",
    )
    p.add_argument(
        "--root",
        default=None,
        help="repo root (default: nearest ancestor with lint_torch.toml)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = os.path.abspath(args.root) if args.root else find_repo_root()
    cfg = load_config(root)
    paths = args.paths or list(cfg.default_paths)
    missing, nonpy = [], []
    for p in expand_paths(paths, root):
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(ap):
            missing.append(p)
        elif os.path.isfile(ap) and not ap.endswith(".py"):
            nonpy.append(p)
    if missing:
        _out(f"fhh-lint: no such path: {', '.join(missing)}", err=True)
        return 2
    if nonpy:
        _out(
            f"fhh-lint: not a Python file: {', '.join(nonpy)}",
            err=True,
        )
        return 2
    # enumerate ONCE: the file list feeds the lint pass, and its relpath
    # set scopes both the stale-baseline check and --update-baseline's
    # keep logic to what this run actually linted
    files = list(iter_python_files(paths, root))
    scanned = {rel for _, rel in files}
    if not files:
        _out(
            "fhh-lint: no Python files found under the given paths",
            err=True,
        )
        return 2

    findings, errors = lint_paths(paths, cfg, root, files=files)

    baseline_path = args.baseline or os.path.join(root, cfg.baseline)
    if args.update_baseline:
        if errors:
            # an unparseable file would silently drop its counts from the
            # rewritten baseline — refuse instead
            for e in errors:
                _out(f"fhh-lint: PARSE ERROR {e}", err=True)
            _out(
                "fhh-lint: refusing --update-baseline with parse errors",
                err=True,
            )
            return 2
        # entries for files OUTSIDE this run's path set survive the
        # rewrite (a partial-tree update must not erase another subtree's
        # grandfathered findings) — but only while the file still exists:
        # deleted/renamed files' entries must be removable
        try:
            old = load_baseline(baseline_path)
        except (ValueError, OSError, json.JSONDecodeError):
            old = {}
        # a rule RENAME must not read as a silent burn-down: entries
        # under ids no rule carries anymore are named explicitly (the
        # operator verifies the successor id has its own entries — or
        # celebrates an actually-deleted rule)
        for rule, nfiles, n in removed_rules(old, RULES_BY_NAME):
            _out(
                f"fhh-lint: dropping baseline entries for UNKNOWN rule "
                f"id '{rule}' ({n} finding(s) across {nfiles} file(s)) — "
                "renamed or removed rule; if renamed, confirm the new "
                "id's entries below",
                err=True,
            )
        keep = {
            rule: {
                p: n
                for p, n in per_path.items()
                if p not in scanned and os.path.exists(os.path.join(root, p))
            }
            for rule, per_path in old.items()
            if rule in RULES_BY_NAME
        }
        write_baseline(baseline_path, findings, keep=keep)
        kept = sum(len(v) for v in keep.values() if v)
        _out(
            f"fhh-lint: baseline rewritten with {len(findings)} finding(s)"
            + (f" (+{kept} unscanned entr{'y' if kept == 1 else 'ies'} kept)"
               if kept else "")
            + f" -> {os.path.relpath(baseline_path, root)}"
        )
        return 0

    counts = {}
    if not args.no_baseline:
        try:
            counts = load_baseline(baseline_path)
        except (ValueError, OSError, json.JSONDecodeError) as e:
            _out(f"fhh-lint: bad baseline: {e}", err=True)
            return 2
    res = apply_baseline(findings, counts, scanned=scanned)

    threshold = ("warning", "error") if args.strict else ("error",)
    failing = [f for f in res.new if f.severity in threshold]

    if args.format == "json":
        doc = {
            "schema": "fhh-lint-report/1",
            "root": root,
            "paths": paths,
            "strict": bool(args.strict),
            # the active rule ids: the artifact proves which passes ran
            # (CI asserts the fhh-race pair is among them)
            "rules": sorted(RULES_BY_NAME),
            "findings": [f.to_json() for f in res.new],
            "baselined": res.absorbed,
            "stale_baseline": [
                {"rule": r, "path": p, "extra": n} for r, p, n in res.stale
            ],
            "parse_errors": errors,
            "failing": len(failing),
        }
        _out(json.dumps(doc, indent=1))
    else:
        for f in res.new:
            _out(f.render())
        for e in errors:
            _out(f"PARSE ERROR {e}")
        bits = [f"{len(res.new)} new finding(s)"]
        if res.absorbed:
            bits.append(f"{res.absorbed} baselined")
        if res.stale:
            bits.append(
                f"{len(res.stale)} stale baseline entr"
                f"{'y' if len(res.stale) == 1 else 'ies'} "
                "(run --update-baseline to bank the burn-down)"
            )
        if errors:
            bits.append(f"{len(errors)} parse error(s)")
        _out("fhh-lint: " + ", ".join(bits))

    if errors:
        return 2
    return 1 if failing else 0
