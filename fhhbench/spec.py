"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.pkg = self.root / "fhhbench"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def sampler(self, distribution: str):
        """The module of ``traffic/<distribution>.py`` (its ``sample``)."""
        return _load(self.pkg / "traffic" / f"{distribution}.py",
                     f"fhhbench.traffic.{distribution}")

    def metrics(self, cell: str, traced: bool) -> list:
        """The metric entries a run of ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced; those with a ``workloads`` key
        only in the cells it lists."""
        group = self.doc["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The module of ``metrics/<metric>.py`` (its ``read(run)``)."""
        return _load(self.pkg / "metrics" / f"{metric}.py", f"fhhbench.metrics.{metric}")

    def kernels(self) -> dict:
        """Kernel name -> its ``roofline/<kernel>.py`` module."""
        return {p.stem: _load(p, f"fhhbench.roofline.{p.stem}")
                for p in sorted((self.pkg / "roofline").glob("*.py")) if p.stem != "__init__"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
