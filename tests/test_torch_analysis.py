"""The port's fhh-lint (``fuzzyheavyhitters_torch.analysis``) against the
JAX package's, and the port linting itself clean.

- Fixture parity: every fixture of ``tests/test_analysis.py`` goes through
  both packages' ``lint_source`` under the same config and must give the
  same (rule, line, severity) list (:mod:`torch_lint_parity`).  The port's
  rules speak torch where the JAX rules speak JAX (``.cpu()``/``.numpy()``/
  ``.tolist()``/``torch.cuda.synchronize()`` for ``jax.device_get``/
  ``.block_until_ready()``; ``torch.compile``/``torch.jit`` for
  ``jax.jit``/``pmap``; ``cuda_build.load`` in a loop for ``pallas_call``
  in a loop; ``_fetch_words`` for ``_fetch``), so the fixtures built on
  JAX forms are listed in ``_MOVED`` with the findings the port drops, and
  the torch forms have fixtures of their own below.
- Tree parity: under the JAX ``pyproject.toml`` config the port's linter
  reports over ``fuzzyheavyhitters_tpu`` exactly what the JAX linter does.
- Drift: ``lint_torch.toml`` against the ``LintConfig`` defaults.
- Self-lint: the port's scope is clean under ``lint_baseline_torch.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import textwrap

import pytest

import torch_lint_parity as parity
from fuzzyheavyhitters_torch.analysis import (
    ALL_RULES,
    LintConfig,
    apply_baseline,
    lint_paths,
    lint_source,
    load_baseline,
    load_config,
)
from fuzzyheavyhitters_torch.analysis import cli
from fuzzyheavyhitters_torch.analysis.rules import RULES_BY_NAME

REPO = parity.REPO

# JAX fixtures whose findings move with the torch vocabulary: the
# (rule, line) findings the JAX linter reports and the port's does not
_MOVED = {
    # .block_until_ready() is JAX's; the port flags .item() on line 3 only
    "test_host_sync_item_and_block_until_ready": {("host-sync-in-hot-loop", 4)},
    # @jax.jit is not a compiled function to the port (@torch.compile is)
    "test_host_sync_cast_inside_jit": {("host-sync-in-hot-loop", 5)},
    "test_jit_wrapper_in_function_detected": {("recompile-churn", 4)},
    "test_span_discipline_flags_telemetry_in_jit_bodies": {
        ("span-discipline", 6), ("span-discipline", 7)},
    # jit static_argnames/static_argnums: torch.compile has no static args
    "test_static_arg_unhashable_literal_detected": {("recompile-churn", 8)},
    "test_static_arg_loop_variable_detected": {("recompile-churn", 9)},
    # _fetch, jax.device_get and .copy_to_host_async() are JAX's readbacks;
    # the port keeps np.asarray (line 10) and adds _fetch_words, .cpu(), ...
    "test_chunked_readback_loop_fetches_detected": {
        ("chunked-device-readback", 8), ("chunked-device-readback", 12),
        ("chunked-device-readback", 14)},
    "test_chunked_readback_scoped_to_readback_modules": {
        ("chunked-device-readback", 3)},
}

_FIXTURES = parity.fixture_tests("test_analysis.py")


def test_fixture_list_and_moved_names_agree():
    """Every moved name is a fixture test of test_analysis.py, and the
    file still has the fixture tests this parity was written against."""
    assert set(_MOVED) <= set(_FIXTURES), set(_MOVED) - set(_FIXTURES)
    assert len(_FIXTURES) >= 46


@pytest.mark.parametrize("name", _FIXTURES)
def test_fixture_parity_with_jax_linter(name, tmp_path, monkeypatch):
    calls = parity.run_fixture("test_analysis.py", name, tmp_path, monkeypatch)
    assert calls, f"{name} linted no fixture"
    drops = _MOVED.get(name, set())
    for src, jax_fs, port_fs in calls:
        want = [k for k in parity.key(jax_fs) if (k[0], k[1]) not in drops]
        assert parity.key(port_fs) == want, src


# ---------------------------------------------------------------------------
# the torch vocabulary's own fixtures
# ---------------------------------------------------------------------------

_HOT = "fuzzyheavyhitters_torch/protocol/fake.py"


def _lint(src, relpath=_HOT, cfg=None, rule=None):
    cfg = cfg or LintConfig()
    rules = [RULES_BY_NAME[rule]] if rule else None
    return lint_source(textwrap.dedent(src), relpath, cfg, rules)


@pytest.mark.parametrize("form, label", [
    ("y = x.item()", ".item()"),
    ("y = x.cpu()", ".cpu()"),
    ("y = x.numpy()", ".numpy()"),
    ("y = x.tolist()", ".tolist()"),
    ("y = np.asarray(x)", "np.asarray"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("torch.cuda.synchronize(x.device)", "torch.cuda.synchronize()"),
    ("stream.synchronize()", ".synchronize()"),
    ("ev.synchronize()", ".synchronize()"),
])
def test_torch_sync_form_in_hot_loop_detected(form, label):
    src = f"""
    import numpy as np
    import torch
    def run(levels, x, stream, ev):
        for level in levels:
            {form}
    """
    fs = _lint(src, rule="host-sync-in-hot-loop")
    assert [(f.rule, f.line) for f in fs] == [("host-sync-in-hot-loop", 6)]
    assert fs[0].message.startswith(label)


def test_torch_sync_on_hot_root_path_and_clean_forms():
    src = """
    import torch
    def helper(x):
        return x.cpu()
    def tree_crawl(x):
        return helper(x)
    def setup(x):
        return x.numpy()  # not hot: no loop, not a hot root
    def run(xs):
        for x in xs:
            x.to("cuda", non_blocking=True)  # a device move, not a readback
            x.cpu(memory_format=None)  # .cpu with arguments: not a bare sync form
    """
    fs = _lint(src, rule="host-sync-in-hot-loop")
    assert len(fs) == 1 and fs[0].line == 4 and "helper" in fs[0].message


def test_torch_compile_wrapper_in_function_detected_module_level_clean():
    src = """
    import re
    import torch
    canon_c = torch.compile(canon)
    @torch.compile
    def g(x):
        return x
    def f(v):
        pat = re.compile("x")  # a regex, not a graph
        return torch.compile(canon)(v) + torch.jit.script(canon)(v)
    """
    fs = _lint(src, rule="recompile-churn")
    assert [(f.line, "'torch." in f.message) for f in fs] == [(10, True), (10, True)]


def test_compiled_body_cast_and_telemetry_detected():
    src = """
    import torch
    from .. import obs
    @torch.compile
    def f(x):
        obs.emit("x")
        return bool(x.sum())
    @torch.jit.script
    def g(x):
        return float(x.max())
    """
    hs = _lint(src, "some/other/module.py", rule="host-sync-in-hot-loop")
    assert [f.line for f in hs] == [7, 10]
    assert all("compiled function" in f.message for f in hs)
    sd = _lint(src, rule="span-discipline")
    assert [f.line for f in sd] == [6]


def test_kernel_loader_in_loop_detected():
    src = """
    from . import cuda_build
    from . import cuda_build as cb
    def run(names):
        for n in names:
            lib = cuda_build.load(n)
        cuda_build.build()  # once, outside any loop
        return lib
    def once():
        return cb.load("gc"), cuda_build.load("gc")
    """
    fs = _lint(src, "fuzzyheavyhitters_torch/ops/fake.py", rule="recompile-churn")
    assert [f.line for f in fs] == [6]
    assert "cuda_build.load" in fs[0].message


def test_fetch_words_and_torch_readbacks_in_chunk_loop_detected():
    src = """
    import numpy as np
    async def stage(chunks):
        out = []
        for c in chunks:
            out.append(await _fetch_words(c))
            out.append(c.cpu())
            out.append(c.numpy())
            out.append(c.tolist())
        rows = [c.item() for c in chunks]
        whole = await _fetch_words(stack(chunks))  # one fetch per level
        return out, rows, whole
    """
    fs = _lint(src, "fuzzyheavyhitters_torch/protocol/secure.py",
               rule="chunked-device-readback")
    assert [f.line for f in fs] == [6, 7, 8, 9, 10]
    assert fs[0].message.startswith("_fetch_words")


def test_port_tree_has_no_compiled_functions():
    """torch.compile/torch.jit: the port uses none, so their branches of
    recompile-churn, host-sync and span-discipline find nothing."""
    cfg = load_config(REPO)
    rules = [RULES_BY_NAME["recompile-churn"]]
    findings, errors = lint_paths(["fuzzyheavyhitters_torch"], cfg, REPO, rules)
    assert errors == [] and findings == []


# ---------------------------------------------------------------------------
# tree parity: the JAX config over the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tree_findings():
    """Both linters over fuzzyheavyhitters_tpu under pyproject.toml."""
    from fuzzyheavyhitters_tpu import analysis as jax_analysis

    jcfg = jax_analysis.load_config(REPO)
    pcfg = load_config(path=os.path.join(REPO, "pyproject.toml"))
    jax_fs, jax_err = jax_analysis.lint_paths(["fuzzyheavyhitters_tpu"], jcfg, REPO)
    port_fs, port_err = lint_paths(["fuzzyheavyhitters_tpu"], pcfg, REPO)
    assert jax_err == port_err == []
    return jax_fs, port_fs


def test_pyproject_loads_to_the_jax_config():
    """The port's reader (tomllib) loads pyproject.toml's table to the
    JAX reader's values, field by field."""
    from fuzzyheavyhitters_tpu import analysis as jax_analysis

    jcfg = jax_analysis.load_config(REPO)
    pcfg = load_config(path=os.path.join(REPO, "pyproject.toml"))
    assert parity.port_config(jcfg) == pcfg


@pytest.mark.parametrize("rule", sorted(RULES_BY_NAME))
def test_tree_parity_with_jax_linter(rule, jax_tree_findings):
    jax_fs, port_fs = jax_tree_findings

    def sites(fs):
        return [(f.path, f.line, f.severity) for f in fs if f.rule == rule]

    assert sites(port_fs) == sites(jax_fs)


# ---------------------------------------------------------------------------
# config: lint_torch.toml is the operative copy, the defaults mirror it
# ---------------------------------------------------------------------------


def test_lint_torch_toml_and_dataclass_defaults_do_not_drift():
    operative = load_config(REPO)
    defaults = LintConfig()
    for f in operative.__dataclass_fields__:
        if f == "severity_overrides":
            continue
        assert getattr(operative, f) == getattr(defaults, f), f
    # the severity table restates each rule's default severity
    assert operative.severity_overrides == {
        r.name: r.default_severity for r in ALL_RULES}


def test_config_aims_at_the_port():
    cfg = LintConfig()
    for f in ("hot_modules", "print_scope", "print_allowed", "shared_state_modules",
              "await_modules", "readback_modules", "queue_modules", "span_modules",
              "race_modules", "taint_modules"):
        for p in getattr(cfg, f):
            assert p.startswith("fuzzyheavyhitters_torch"), (f, p)
            assert os.path.exists(os.path.join(REPO, p)), (f, p)
    assert "fuzzyheavyhitters_torch/ops/cuda_build.py" in cfg.race_modules
    assert cfg.baseline == "lint_baseline_torch.json"


def test_hot_roots_name_port_functions():
    """Every hot root is a function the port defines (the JAX names)."""
    import ast

    defined = set()
    for dirpath, _, files in os.walk(os.path.join(REPO, "fuzzyheavyhitters_torch")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    defined |= {n.name for n in ast.walk(ast.parse(f.read()))
                                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert set(LintConfig().hot_roots) <= defined, set(LintConfig().hot_roots) - defined


def test_default_paths_expand_globs_and_exist():
    from fuzzyheavyhitters_torch.analysis.engine import expand_paths

    paths = expand_paths(LintConfig().default_paths, REPO)
    assert not any("*" in p for p in paths)
    assert all(os.path.exists(p if os.path.isabs(p) else os.path.join(REPO, p))
               for p in paths)
    assert any(p.endswith("tests/test_torch_analysis.py") for p in paths)


# ---------------------------------------------------------------------------
# self-lint: the port's scope is clean under its baseline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_findings():
    cfg = load_config(REPO)
    findings, errors = lint_paths(list(cfg.default_paths), cfg, REPO)
    assert errors == []
    return cfg, findings


def test_self_lint_port_clean_under_baseline(port_findings):
    cfg, findings = port_findings
    counts = load_baseline(os.path.join(REPO, cfg.baseline))
    res = apply_baseline(findings, counts)
    assert res.new == [], "new lint findings:\n" + "\n".join(f.render() for f in res.new)
    assert res.stale == [], res.stale


def test_port_baseline_is_empty():
    with open(os.path.join(REPO, "lint_baseline_torch.json"), encoding="utf-8") as f:
        doc = json.load(f)
    assert doc == {"schema": "fhh-lint-baseline/1", "counts": {}}


def test_cli_json_strict_on_port(capsys):
    rc = cli.main(["--strict", "--format", "json", "--root", REPO])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0, doc["findings"]
    assert doc["schema"] == "fhh-lint-report/1"
    assert doc["rules"] == sorted(RULES_BY_NAME) and len(doc["rules"]) == 16
    assert doc["findings"] == [] and doc["stale_baseline"] == [] and doc["failing"] == 0


def test_cli_exit_codes(tmp_path):
    (tmp_path / "lint_torch.toml").write_text('[tool.fhh-lint]\nprint_scope = ["pkg"]\n')
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text("def f(x):\n    print(x)\n")
    assert cli.main(["pkg", "--root", str(tmp_path)]) == 1
    assert cli.main(["pkg", "--root", str(tmp_path), "--update-baseline"]) == 0
    assert cli.main(["pkg", "--root", str(tmp_path)]) == 0
    assert cli.main(["missing", "--root", str(tmp_path)]) == 2
    assert cli.main(["pkg/*.txt", "--root", str(tmp_path)]) == 2


def test_lint_torch_script_strict_and_lists_interprocedural_rules(tmp_path):
    artifact = tmp_path / "report.json"
    out = subprocess.run(["bash", os.path.join(REPO, "scripts", "lint_torch.sh"),
                          str(artifact)], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(artifact.read_text())
    assert {"guarded-state-unlocked", "stale-read-across-await", "secret-to-sink-flow",
            "secret-branch", "unmasked-wire"} <= set(doc["rules"])
    assert doc["strict"] and doc["findings"] == []
