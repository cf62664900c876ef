"""fhh-race in the port (``fuzzyheavyhitters_torch.analysis.concurrency``):
fixture parity with the JAX package's pass, the guard map against its
runtime twins, and the port's restored lock contracts.

Every fixture of ``tests/test_concurrency.py`` goes through both packages'
``lint_source`` and must give the same (rule, line, severity) list; the
race rules name no JAX API, so no fixture moves.  The port's guard map is
the JAX package's under the port's attribute names
(``sessions._SESSION_RENAMES``) and equals the four runtime tables the
``FHH_DEBUG_GUARDS`` sanitizer arms.  Each ``# fhh-race:`` contract and
``stale-read-across-await`` suppression restored in the port is a case:
deleting a load-bearing one from a copy of its file brings a finding
back, deleting one of the documenting ones (``_DOCUMENTING``) changes
nothing.
"""

from __future__ import annotations

import ast
import os
import re

import pytest

import torch_lint_parity as parity
from fuzzyheavyhitters_torch.analysis import LintConfig, lint_paths, load_config
from fuzzyheavyhitters_torch.analysis.rules import RULES_BY_NAME

REPO = parity.REPO
RACE_RULE_NAMES = ("guarded-state-unlocked", "stale-read-across-await")
_RACE = [RULES_BY_NAME[r] for r in RACE_RULE_NAMES]

_FIXTURES = parity.fixture_tests("test_concurrency.py")


def test_fixture_list_covers_the_race_tests():
    assert len(_FIXTURES) >= 16


@pytest.mark.parametrize("name", _FIXTURES)
def test_fixture_parity_with_jax_race_pass(name, tmp_path, monkeypatch):
    calls = parity.run_fixture("test_concurrency.py", name, tmp_path, monkeypatch)
    assert calls, f"{name} linted no fixture"
    for src, jax_fs, port_fs in calls:
        assert parity.key(port_fs) == parity.key(jax_fs), src


# ---------------------------------------------------------------------------
# the guard map: lint_torch.toml, the JAX table, the runtime twins
# ---------------------------------------------------------------------------


def test_guard_map_drift_lint_torch_toml_vs_runtime_twins():
    from fuzzyheavyhitters_torch.protocol import fleet, leader_rpc, rpc, sessions

    want = {f"CollectorServer.{a}": lk for a, lk in rpc._SERVER_GUARDS.items()}
    want.update({f"CollectionSession.{a}": lk for a, lk in sessions._SESSION_GUARDS.items()})
    want.update({f"WindowedIngest.{a}": lk for a, lk in leader_rpc._INGEST_GUARDS.items()})
    want.update({f"FleetDirectory.{a}": lk for a, lk in fleet._FLEET_GUARDS.items()})
    assert load_config(REPO).guards == want
    assert LintConfig().guards == want


def test_guard_map_is_the_jax_table_under_port_names():
    """The JAX package's [tool.fhh-lint.guards], each CollectionSession
    row renamed by sessions._SESSION_RENAMES (dropped where the port keeps
    no such state)."""
    from fuzzyheavyhitters_torch.protocol import sessions
    from fuzzyheavyhitters_tpu import analysis as jax_analysis

    want = {}
    for key, lock in jax_analysis.load_config(REPO).guards.items():
        cls, attr = key.split(".")
        if cls == "CollectionSession" and attr in sessions._SESSION_RENAMES:
            attr = sessions._SESSION_RENAMES[attr]
            if attr is None:
                continue
        want[f"{cls}.{attr}"] = lock
    assert load_config(REPO).guards == want


_GUARD_HOMES = {
    "CollectionSession": "protocol/sessions.py",
    "CollectorServer": "protocol/rpc.py",
    "WindowedIngest": "protocol/leader_rpc.py",
    "FleetDirectory": "protocol/fleet.py",
}


def _class_self_attrs(relpath: str, cls: str) -> set:
    with open(os.path.join(REPO, "fuzzyheavyhitters_torch", relpath), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "self" and isinstance(n.ctx, ast.Store)}


@pytest.mark.parametrize("key", sorted(LintConfig().guards))
def test_guard_names_a_port_attribute_and_its_lock(key):
    """Name by name: the class exists in the port and assigns both the
    guarded attribute and its lock (a rename would unguard it silently)."""
    cls, attr = key.split(".")
    attrs = _class_self_attrs(_GUARD_HOMES[cls], cls)
    assert attr in attrs, key
    assert LintConfig().guards[key] in attrs, key


# ---------------------------------------------------------------------------
# the port's race pass, and its restored contracts
# ---------------------------------------------------------------------------


def test_port_race_self_analysis_at_zero():
    cfg = load_config(REPO)
    findings, errors = lint_paths(list(cfg.race_modules), cfg, REPO, rules=_RACE)
    assert errors == []
    assert findings == [], "\n".join(f.render() for f in findings)


def _contract_sites():
    """(relpath, line index, function) of every restored contract: an
    fhh-race holds=/atomic on a def (on its line or alone above it), and
    the stale-read suppressions (function: the one they sit in)."""
    sites = []
    for rel in ("protocol/sessions.py", "protocol/rpc.py", "protocol/leader_rpc.py"):
        with open(os.path.join(REPO, "fuzzyheavyhitters_torch", rel), encoding="utf-8") as f:
            text = f.read()
        lines = text.splitlines()
        defs = sorted((n.lineno, n.name) for n in ast.walk(ast.parse(text))
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
        for i, line in enumerate(lines):
            if "# fhh-race:" in line or "disable=stale-read-across-await" in line:
                fname = [name for lineno, name in defs if lineno <= i + 2][-1]
                sites.append((rel, i, fname))
    return sites


def _delete(lines, i):
    """The file with the contract at line index ``i`` taken out."""
    out = list(lines)
    if out[i].lstrip().startswith("#"):
        del out[i]
    else:
        out[i] = re.sub(r"\s*# fhh-race:.*$", "", out[i])
    return out


def _lint_copy(tmp_path, rel, lines):
    path = tmp_path / "fuzzyheavyhitters_torch" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    findings, errors = lint_paths([str(path)], load_config(REPO), str(tmp_path), rules=_RACE)
    assert errors == []
    return findings


_SITES = _contract_sites()

# contracts the pass cannot hold to account on their own, as in the JAX
# package: the rpc verbs reach a collection's state through ``cs``, not
# ``self``; these session helpers read no guarded attribute themselves, or
# inherit the lock from their only callers in the module
_DOCUMENTING = {
    ("protocol/sessions.py", "advance_sketch"),  # reads no guarded attribute
    ("protocol/sessions.py", "_mask_rows"),  # reads no guarded attribute
    ("protocol/sessions.py", "get"),  # SessionTable: no guard map entry
    ("protocol/sessions.py", "clear_spans"),  # inherits clear's lock
    ("protocol/sessions.py", "_f_bucket"),  # its module callers hold the lock
    ("protocol/sessions.py", "_concat_sketch"),  # inherits _restore_sketch's
    ("protocol/rpc.py", "sessions_status"),  # inherits the status verb's
    *(("protocol/rpc.py", v) for v in (
        "reset", "add_keys", "tree_init", "sketch_verify", "tree_crawl",
        "tree_crawl_last", "tree_prune", "tree_prune_last", "final_shares",
        "window_seal", "window_load", "session_export", "session_import", "status",
        "tree_checkpoint", "tree_restore", "plane_reset", "warmup", "_do_expand",
        "_maybe_pre_expand")),
}


def test_restored_contract_counts():
    """The contracts the port carries again: 24 on sessions.py, 22 on
    rpc.py, and leader_rpc.py's atomic _ensure_span plus its three
    deliberate-snapshot suppressions."""
    by_file = {}
    for rel, _, _ in _SITES:
        by_file[rel] = by_file.get(rel, 0) + 1
    assert by_file == {"protocol/sessions.py": 24, "protocol/rpc.py": 22,
                       "protocol/leader_rpc.py": 4}
    assert _DOCUMENTING <= {(rel, fname) for rel, _, fname in _SITES}


@pytest.mark.parametrize("rel, i, fname", _SITES,
                         ids=[f"{rel}:{i + 1}:{fname}" for rel, i, fname in _SITES])
def test_deleting_a_restored_contract(rel, i, fname, tmp_path):
    """Deleting a load-bearing contract from a copy of its file brings a
    race finding back; deleting a documenting one changes nothing."""
    with open(os.path.join(REPO, "fuzzyheavyhitters_torch", rel), encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert _lint_copy(tmp_path, rel, lines) == []
    found = _lint_copy(tmp_path, rel, _delete(lines, i))
    if (rel, fname) in _DOCUMENTING:
        assert found == []
    else:
        assert found, f"{rel}:{i + 1} carries no load: {lines[i].strip()[:80]}"
        assert {f.rule for f in found} <= set(RACE_RULE_NAMES)


def test_atomic_contract_is_verified_on_the_port(tmp_path):
    """An `atomic` contract is checked, not trusted: an await added to the
    session table's bind breaks it."""
    rel = "protocol/rpc.py"
    with open(os.path.join(REPO, "fuzzyheavyhitters_torch", rel), encoding="utf-8") as f:
        text = f.read()
    i = text.index("    def _bind_session(self, req)")
    broken = text[:i] + text[i:].replace("    def _bind_session(", "    async def _bind_session(", 1)
    j = broken.index('sid = (req or {}).get("session")', i)
    broken = broken[:j] + "await asyncio.sleep(0)\n        " + broken[j:]
    found = _lint_copy(tmp_path, rel, broken.splitlines())
    assert any("atomic" in f.message for f in found), [f.render() for f in found]
