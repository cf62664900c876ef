"""fhh-lint engine: parse, suppressions, rule dispatch, severity.

Dependency-free by design (``ast`` + ``tokenize`` only): the linter must
run in CI images, pre-commit hooks, and the tier-1 test host without
importing torch — importing the package under lint would both slow every
lint run by seconds and make the linter crash on any tree the rules
exist to catch (a module that host-syncs at import time still parses).

The pieces:

- :class:`SourceModule` — one parsed file: AST with parent links,
  inline-suppression table (``# fhh-lint: disable=<rule>[,<rule>...]``
  on the offending line, or standing alone on the line above), and the
  repo-relative path every rule and baseline entry keys on.
- :class:`Rule` — a named check over a :class:`SourceModule` yielding
  ``(lineno, end_lineno, message)`` triples; the engine attaches
  severity (rule default, overridable per rule in config) and drops
  suppressed findings.
- :func:`lint_paths` / :func:`lint_source` — the two entry points
  (files/trees for the CLI and the self-lint test; raw source for the
  rule-fixture tests).

Baseline semantics live in :mod:`.baseline`; the config schema and its
``lint_torch.toml`` loader in :mod:`.config`.
"""

from __future__ import annotations

import ast
import glob
import io
import os
import re
import tokenize
from dataclasses import dataclass

SEVERITIES = ("warning", "error")

# rule names, comma-separated; anything after (e.g. a parenthesized
# justification — encouraged) is ignored
_SUPPRESS_RE = re.compile(
    r"#\s*fhh-lint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


@dataclass(frozen=True)
class Finding:
    """One lint finding.  ``path`` is repo-relative with forward slashes
    (the form baseline entries and suppression workflows key on)."""

    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.severity}] {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "severity": self.severity,
            "message": self.message,
        }


class Rule:
    """Base class: subclasses set ``name``/``default_severity`` and yield
    ``(lineno, end_lineno, message)`` from :meth:`check`."""

    name: str = ""
    default_severity: str = "error"

    def check(self, mod: "SourceModule", cfg):
        raise NotImplementedError
        yield  # pragma: no cover


def _parse_suppressions(text: str) -> dict[int, set[str]]:
    """line -> set of rule names disabled there.  A comment sharing a line
    with code applies to that line; a comment alone on its line applies to
    the next CODE line — blank and comment-only lines between are skipped,
    so a multi-line justification can carry the marker anywhere in it."""
    out: dict[int, set[str]] = {}
    lines = text.splitlines()

    def next_code_line(after: int) -> int:
        for i in range(after, len(lines)):
            stripped = lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i + 1  # 1-indexed
        return after + 1

    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            line = tok.start[0]
            out.setdefault(line, set()).update(rules)
            # standalone comment: nothing but whitespace before it
            if tok.line[: tok.start[1]].strip() == "":
                out.setdefault(next_code_line(line), set()).update(rules)
    except tokenize.TokenError:
        pass  # findings still apply; suppressions in the torn tail are lost
    return out


class SourceModule:
    """One parsed source file with parent links and suppression table."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.tree = ast.parse(text, filename=relpath)
        self.suppressions = _parse_suppressions(text)
        self._parents: dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST):
        """node's enclosing chain, innermost first (node excluded)."""
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_functions(self, node: ast.AST):
        return [
            a
            for a in self.ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]

    def in_loop_within_function(self, node: ast.AST) -> bool:
        """True when a ``for``/``while`` sits between ``node`` and its
        nearest enclosing function (or module) boundary."""
        for a in self.ancestors(node):
            if isinstance(a, (ast.For, ast.AsyncFor, ast.While)):
                return True
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
        return False

    def is_suppressed(self, rule: str, lineno: int, end_lineno: int | None) -> bool:
        for line in range(lineno, (end_lineno or lineno) + 1):
            if rule in self.suppressions.get(line, ()):
                return True
        return False


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains; None when the base is dynamic
    (a call result, subscript, ...) — rules then match on the final
    attribute alone."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("?")
    else:
        return None
    return ".".join(reversed(parts))


def last_segment(dotted: str | None) -> str | None:
    return None if dotted is None else dotted.rsplit(".", 1)[-1]


def _rule_severity(rule: Rule, cfg) -> str:
    sev = cfg.severity_overrides.get(rule.name, rule.default_severity)
    return sev if sev in SEVERITIES else rule.default_severity


def lint_module(mod: SourceModule, cfg, rules=None) -> list[Finding]:
    from .rules import ALL_RULES

    findings: list[Finding] = []
    for rule in rules if rules is not None else ALL_RULES:
        sev = _rule_severity(rule, cfg)
        for lineno, end_lineno, message in rule.check(mod, cfg):
            if mod.is_suppressed(rule.name, lineno, end_lineno):
                continue
            findings.append(
                Finding(rule.name, mod.relpath, lineno, message, sev)
            )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_source(text: str, relpath: str, cfg, rules=None) -> list[Finding]:
    """Lint raw source text (the fixture-test entry point)."""
    return lint_module(SourceModule(relpath, text), cfg, rules)


def expand_paths(paths, root: str) -> list[str]:
    """``paths`` with each glob pattern (``tests/test_torch_*.py``)
    replaced by its sorted matches under ``root``; a pattern that matches
    nothing stays as it is, so the caller reports it as missing."""
    out = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        hits = sorted(glob.glob(ap)) if glob.has_magic(p) else []
        out.extend(hits or [p])
    return out


def iter_python_files(paths, root: str):
    """Yield (abspath, relpath) for every .py under ``paths`` (files,
    directories or glob patterns), sorted, skipping hidden dirs and
    __pycache__."""
    seen = set()
    for p in expand_paths(paths, root):
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap):
            candidates = [ap]
        else:
            candidates = []
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(
                    d
                    for d in dirnames
                    if not d.startswith(".") and d != "__pycache__"
                )
                candidates.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames)
                    if f.endswith(".py")
                )
        for c in candidates:
            c = os.path.abspath(c)
            if c in seen or not c.endswith(".py"):
                continue
            seen.add(c)
            yield c, os.path.relpath(c, root).replace(os.sep, "/")


def lint_paths(
    paths, cfg, root: str, rules=None, files=None
) -> tuple[list[Finding], list[str]]:
    """Lint every .py file under ``paths``.  Returns (findings, errors) —
    a file that fails to parse is an error entry, not a crash (the linter
    must survive any tree it is pointed at).  ``files`` (pre-enumerated
    (abspath, relpath) pairs) skips the walk — the CLI enumerates once for
    its scan-scope set and passes the list through."""
    findings: list[Finding] = []
    errors: list[str] = []
    for abspath, relpath in (
        files if files is not None else iter_python_files(paths, root)
    ):
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
            mod = SourceModule(relpath, text)
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{relpath}: {type(e).__name__}: {e}")
            continue
        findings.extend(lint_module(mod, cfg, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, errors
