"""Fixture parity between the JAX package's linter and the port's.

The JAX package's lint tests (``tests/test_analysis.py``,
``tests/test_concurrency.py``, ``tests/test_taint.py``) hold each rule to
small fixture sources through a ``lint_source`` call.  :func:`run_fixture`
runs one of those tests unchanged with the test module's ``lint_source``
replaced by a recorder: every fixture it lints goes through both packages'
``lint_source`` under the same config (the JAX ``LintConfig`` copied field
by field into the port's) and the same rules (by name), and the recorder
hands the JAX findings back, so the JAX test's own asserts still run.  The
caller compares the two finding lists.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import inspect
import os

import torch_ref

from fuzzyheavyhitters_torch import analysis as port_analysis
from fuzzyheavyhitters_torch.analysis.rules import RULES_BY_NAME as PORT_RULES

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# the JAX tests' fixture helpers (each ends in a lint_source call)
_FIXTURE_CALLS = {"_lint", "_race", "lint_source"}


def fixture_tests(filename: str) -> list[str]:
    """The test functions of a JAX lint test file that lint a fixture
    source, in file order."""
    with open(os.path.join(TESTS, filename), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return [
        node.name
        for node in tree.body
        if isinstance(node, ast.FunctionDef)
        and node.name.startswith("test_")
        and any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)
            and n.func.id in _FIXTURE_CALLS
            for n in ast.walk(node)
        )
    ]


@functools.lru_cache(maxsize=None)
def jax_test_module(filename: str):
    """The JAX lint test file, imported under a name of its own through
    :func:`torch_ref.reference_file` (its fixtures and tests are not
    collected from here)."""
    return torch_ref.reference_file(os.path.join(TESTS, filename),
                                    f"_jax_lint_{os.path.splitext(filename)[0]}")


def port_config(cfg):
    """The port's LintConfig with every field of a JAX LintConfig."""
    return port_analysis.LintConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
    })


def key(findings) -> list[tuple]:
    """What parity compares: (rule, line, severity) in report order."""
    return [(f.rule, f.line, f.severity) for f in findings]


def run_fixture(filename: str, name: str, tmp_path, monkeypatch) -> list:
    """Run one JAX fixture test; -> [(source, jax findings, port findings)]
    for every fixture it linted."""
    mod = jax_test_module(filename)
    jax_lint_source = mod.lint_source
    calls = []

    def recorder(text, relpath, cfg, rules=None):
        got = jax_lint_source(text, relpath, cfg, rules)
        port_rules = None if rules is None else [PORT_RULES[r.name] for r in rules]
        port = port_analysis.lint_source(text, relpath, port_config(cfg), port_rules)
        calls.append((text, got, port))
        return got

    monkeypatch.setattr(mod, "lint_source", recorder)
    fn = getattr(mod, name)
    params = inspect.signature(fn).parameters
    fn(**({"tmp_path": tmp_path} if "tmp_path" in params else {}))
    return calls
