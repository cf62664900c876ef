"""The benchmark's readers of the program's spans (``fhhbench/metrics/``:
``leader.*_share`` over ``Leader.timings``, ``keygen.host_s`` over the
``fhh.keygen.host`` profiler ranges), loaded by path as the harness loads
them, against hand-built runs and traces."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from fhhbench.trace import Trace

METRICS = Path(__file__).resolve().parents[1] / "fhhbench" / "metrics"
MS = 1_000_000  # ns
SHARES = ("expand", "advance", "count", "prune")


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"fhhbench.metrics.{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(collections=(), trace=None):
    return SimpleNamespace(collections=list(collections), trace=trace, window_s=10.0)


def coll(seconds: float, **phases):
    return SimpleNamespace(seconds=seconds, phases=phases, error=None)


@pytest.mark.parametrize("phase", SHARES)
def test_leader_share(phase):
    read = reader(f"leader.{phase}_share")
    timed = {p: 0.5 for p in SHARES}
    c = [coll(2.0, **dict(timed, **{phase: 0.6})), coll(3.0, **dict(timed, **{phase: 1.0}))]
    # the profiled collection alone (the window's first): its leader phases
    # are on the stream clock, the others' on the host's
    assert read(run(c, Trace())) == pytest.approx(100 * 0.6 / 2.0)
    # untraced, the parent's timings (no prune: host enqueue seconds under
    # the same names), a failed collection, an empty window: nothing to read
    assert read(run(c)) is None
    assert read(run([coll(2.0, expand=0.5, count=0.5, advance=0.5)], Trace())) is None
    assert read(run([SimpleNamespace(seconds=0.0, phases={}, error="x")], Trace())) is None
    assert read(run(trace=Trace())) is None


def test_keygen_host_s():
    read = reader("keygen.host_s")
    t = Trace(span=(0, 10 * MS),
              host=[("fhh.keygen.host", 1 * MS, 3 * MS), ("aten::copy_", 2 * MS, 3 * MS),
                    ("fhh.keygen.host", 4 * MS, 5 * MS), ("fhhbench.keygen", 1 * MS, 6 * MS),
                    ("fhh.keygen.host", 12 * MS, 13 * MS)])  # the last outside the span
    assert read(run(trace=t)) == pytest.approx(3e-3)
    assert read(run(trace=Trace(span=(0, 10 * MS), host=[("fhhbench.keygen", 0, MS)]))) is None
    assert read(run()) is None
