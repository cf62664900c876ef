"""fhh-taint in the port (``fuzzyheavyhitters_torch.analysis.taint``):
fixture parity with the JAX package's pass, the source table against the
JAX table and the runtime sanitizer's, and the port's tree clean.

Every fixture of ``tests/test_taint.py`` goes through both packages'
``lint_source`` and must give the same (rule, line, severity) list; the
taint rules name no JAX API, so no fixture moves.  The port's source table
is the JAX package's under the port's names (``last_shares``; no
``mask_seed``, which the port inlines into its PRG) and covers every
source the runtime twin ``utils/taint_guard`` registers.
"""

from __future__ import annotations

import ast
import os

import pytest

import torch_lint_parity as parity
from fuzzyheavyhitters_torch.analysis import LintConfig, lint_paths, lint_source, load_config
from fuzzyheavyhitters_torch.analysis.config import _DEFAULT_TAINT
from fuzzyheavyhitters_torch.analysis.rules import RULES_BY_NAME
from fuzzyheavyhitters_torch.utils import taint_guard

REPO = parity.REPO
TAINT_RULE_NAMES = ("secret-to-sink-flow", "secret-branch", "unmasked-wire")
_TAINT = [RULES_BY_NAME[r] for r in TAINT_RULE_NAMES]

_FIXTURES = parity.fixture_tests("test_taint.py")


def test_fixture_list_covers_the_taint_tests():
    assert len(_FIXTURES) >= 15


@pytest.mark.parametrize("name", _FIXTURES)
def test_fixture_parity_with_jax_taint_pass(name, tmp_path, monkeypatch):
    calls = parity.run_fixture("test_taint.py", name, tmp_path, monkeypatch)
    assert calls, f"{name} linted no fixture"
    for src, jax_fs, port_fs in calls:
        assert parity.key(port_fs) == parity.key(jax_fs), src


# ---------------------------------------------------------------------------
# the source table: lint_torch.toml, the defaults, the JAX table, runtime
# ---------------------------------------------------------------------------


def test_taint_config_three_way_drift():
    cfg = load_config(REPO)
    assert cfg.taint == _DEFAULT_TAINT
    runtime = set(taint_guard._DEFAULT_SOURCES)
    declared_attrs = {k for k in cfg.taint if "." in k}
    assert runtime <= declared_attrs, runtime - declared_attrs
    defaults = LintConfig()
    for knob in ("taint_modules", "taint_sinks", "taint_wire_calls", "taint_declassifiers"):
        assert getattr(cfg, knob) == getattr(defaults, knob), knob


def test_taint_table_is_the_jax_table_under_port_names():
    from fuzzyheavyhitters_tpu import analysis as jax_analysis

    renames = {"CollectionSession._last_shares": "CollectionSession.last_shares",
               "mask_seed": None}
    want = {}
    for key, what in jax_analysis.load_config(REPO).taint.items():
        key = renames.get(key, key)
        if key is not None:
            want[key] = what
    assert load_config(REPO).taint == want
    jcfg = jax_analysis.load_config(REPO)
    for knob in ("taint_sinks", "taint_wire_calls", "taint_declassifiers", "secret_lexicon"):
        assert getattr(LintConfig(), knob) == getattr(jcfg, knob), knob


def _port_names():
    """(classes, attribute names read or written, function names, labels
    passed to ``taint_guard.register``) of the port package."""
    classes, attrs, funcs, labels = set(), set(), set(), set()
    for dirpath, _, files in os.walk(os.path.join(REPO, "fuzzyheavyhitters_torch")):
        for fn in files:
            if not fn.endswith(".py") or "analysis" in dirpath:
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                for n in ast.walk(ast.parse(f.read())):
                    if isinstance(n, ast.ClassDef):
                        classes.add(n.name)
                    elif isinstance(n, ast.Attribute):
                        attrs.add(n.attr)
                    elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        funcs.add(n.name)
                    if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                            and n.func.attr == "register" and n.args
                            and isinstance(n.args[0], ast.Constant)):
                        labels.add(n.args[0].value)
    return classes, attrs, funcs, labels


_NAMES = _port_names()


@pytest.mark.parametrize("key", sorted(LintConfig().taint))
def test_taint_source_names_port_code(key):
    """Name by name: an attr source is an attribute of a port class the
    port really reads, or (the migrated pool shares, as in the JAX
    package) a label the port registers with the runtime sanitizer; a
    function source is a port function (a rename would drop the source
    silently)."""
    classes, attrs, funcs, labels = _NAMES
    if "." in key:
        cls, attr = key.split(".")
        assert cls in classes and (attr in attrs or key in labels), key
    else:
        assert key in funcs, key


def test_port_keeps_no_mask_seed_function():
    """Why the JAX table's mask_seed row is absent: the port masks the
    seed inline in its PRG, so no call returns a masked seed."""
    assert "mask_seed" not in _NAMES[2]


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------


def test_port_self_taint_analysis_zero():
    cfg = load_config(REPO)
    findings, errors = lint_paths(["fuzzyheavyhitters_torch"], cfg, REPO, _TAINT)
    assert errors == []
    assert findings == [], "\n".join(f.render() for f in findings)


def test_lexical_subset_of_flow_in_port_taint_modules():
    cfg = load_config(REPO)
    scope = list(cfg.taint_modules)
    lex, _ = lint_paths(scope, cfg, REPO, [RULES_BY_NAME["secret-to-sink"]])
    flow, _ = lint_paths(scope, cfg, REPO, [RULES_BY_NAME["secret-to-sink-flow"]])
    assert {(f.path, f.line) for f in lex} <= {(f.path, f.line) for f in flow}


@pytest.mark.parametrize("leak, rule", [
    ('obs.emit("verb.debug", seed=str(cs._sec_seed))', "secret-to-sink-flow"),
    ('cs.obs.count("sketch_seeds", int(cs._sketch_seed[0]))', "secret-to-sink-flow"),
    ('await self._dp_send(cs, cs._sec_seed)', "unmasked-wire"),
])
def test_a_leak_in_the_port_is_found(leak, rule):
    """A secret sent to a sink or the wire from the real server module is
    a finding (the pass sees the port's sources through its own code)."""
    rel = "fuzzyheavyhitters_torch/protocol/rpc.py"
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        text = f.read()
    anchor = "    async def final_shares(self, _req, cs=None) -> dict:"
    i = text.index(anchor)
    body = text.index("\n", text.index('"""', text.index('"""', i) + 3)) + 1
    leaked = text[:body] + f"        {leak}\n" + text[body:]
    assert lint_source(text, rel, load_config(REPO), _TAINT) == []
    found = lint_source(leaked, rel, load_config(REPO), _TAINT)
    assert found and {f.rule for f in found} == {rule}
