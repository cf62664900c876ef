"""The harness: every cell resolves to its files, a cell added as files
and entries is found, the result line has the contract's keys, and a run
without a card fails."""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, add_cells, copy_benchmark
from fhhbench import harness
from fhhbench.spec import Spec

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_cell(root: Path, cell: str, trace: int, seed: int = 2**33 + 5):
    """One run of ``cell`` on the CPU: (exit code, last stdout line or None)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                           "--trace", str(trace)], 0.0, root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_every_cell_resolves():
    spec = Spec(REPO)
    doc = spec.doc
    e2e = {m["name"] for m in doc["end_to_end"]}
    cells = [w["name"] for w in doc["workloads"]]
    for group in ("end_to_end", "per_layer"):
        for m in doc[group]:
            assert spec.reader(m["name"]).read is not None
            assert set(m.get("workloads", cells)) <= set(cells)
            if group == "per_layer":
                assert m["moves"] in e2e
    for w in doc["workloads"]:
        cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
        assert (REPO / "fhhbench" / "traffic" / f"{cfg['distribution']}.py").exists()
        assert mix["clients"] <= cfg["clients"]
        untraced = [m["name"] for m in spec.metrics(w["name"], False)]
        assert "setup_s" in untraced and len(untraced) >= 2
        assert spec.metrics(w["name"], True)
    assert set(spec.kernels()) == {"keygen", "expand", "ot2s_encrypt", "ot2s_decrypt",
                                   "gc_garble", "gc_eval"}


def digest(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts
            and "fuzzyheavyhitters_torch" not in p.parts}


def test_an_added_cell_is_found_without_editing_a_file(tmp_path):
    root = copy_benchmark(tmp_path)
    before = digest(root)
    add_cells(root)
    after = digest(root)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {Path("BENCHMARK.json")}  # an entry added there, and new files
    doc = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads((REPO / "BENCHMARK.json").read_text())
    assert all(doc[k][:len(old[k])] == old[k] for k in old if isinstance(old[k], list))
    rc, line = run_cell(root, "tinyz.trusted", 0)
    assert rc == 0 and line["correct"] is True and line["attempted"] >= 2


@pytest.mark.parametrize("cell,trace", [("tinyz.trusted", 0), ("tinyz.trusted", 1),
                                        ("tinyr.secure", 1)])
def test_result_line_has_the_contract_keys(tiny_root, cell, trace):
    rc, line = run_cell(tiny_root, cell, trace)
    want = LINE_KEYS[:-1] + (["breakdown"] if trace else []) + LINE_KEYS[-1:]
    assert rc == 0 and list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"clients_per_s", "setup_s"} <= set(line["metrics"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "fhhbench/run.py", "--workload", "zipf4.trusted",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_a_directory_of_the_benchmark_alone_fails(tmp_path):
    """BENCHMARK.json and fhhbench/ without the program: no result."""
    root = copy_benchmark(tmp_path)
    (root / "fuzzyheavyhitters_torch").unlink()
    add_cells(root)
    drive = ("import sys; from fhhbench import harness; sys.exit(harness.main(['--workload', "
             "'tinyz.trusted', '--seed', '1', '--seconds', '1', '--trace', '0'], 0.0, "
             "device='cpu'))")
    p = subprocess.run([sys.executable, "-c", drive], cwd=root, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "fuzzyheavyhitters_torch" in p.stderr


def test_a_run_that_imported_jax_fails(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    rc, line = run_cell(tiny_root, "tinyz.trusted", 0)
    assert rc != 0 and line is None


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "fhhbench/run.py", "--workload", "rides.secure",
                        "--seed", "7", "--seconds", "5", "--trace", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
