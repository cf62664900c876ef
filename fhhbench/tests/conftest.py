"""A temporary checkout of the benchmark with small cells added, as a
later change would add them: files and entries, nothing existing edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# small cells on the CPU: the zipf4 shape at a short data_len, and the rides
# shape as it is, with few clients
TINY_CONFIGS = {
    "tinyz": ("zipf4", {"num_sites": 5, "data_len": 24, "threshold": 0.01, "clients": 300}),
    "tinyr": ("rides", {"clients": 200}),
}
TINY_CELLS = {  # cell: (config, traffic, mix)
    "tinyz.trusted": ("tinyz", "tiny.trusted", {"clients": 300, "point_sets": 2,
                                                "secure_exchange": False, "ot_path": "auto"}),
    "tinyr.secure": ("tinyr", "tiny.secure", {"clients": 200, "point_sets": 2,
                                              "secure_exchange": True, "ot_path": "auto"}),
}


def add_cells(root: Path) -> None:
    """Add the tiny configurations, traffic mixes and cells to the
    benchmark at ``root``."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for name, (base, changes) in TINY_CONFIGS.items():
        cfg = json.loads((root / f"fhhbench/configs/{base}.json").read_text())
        cfg.update(changes, name=name)
        (root / f"fhhbench/configs/{name}.json").write_text(json.dumps(cfg))
        doc["configs"].append({"name": name, "source": "a test", "reduced": [],
                               "file": f"fhhbench/configs/{name}.json", "why": "a test"})
    for cell, (config, traffic, mix) in TINY_CELLS.items():
        (root / f"fhhbench/traffic/{traffic}.json").write_text(json.dumps(mix))
        doc["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                 "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))


def copy_benchmark(dest: Path) -> Path:
    """The committed benchmark under ``dest``, the program linked beside it."""
    shutil.copytree(REPO / "fhhbench", dest / "fhhbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "fuzzyheavyhitters_torch").symlink_to(REPO / "fuzzyheavyhitters_torch")
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    add_cells(root)
    return root
