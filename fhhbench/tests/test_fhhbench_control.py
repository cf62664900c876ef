"""The comparison that decides ``correct`` fails its control and every
fault a cell can have, and passes a sound run."""

from __future__ import annotations

import pytest

from conftest import REPO
from fhhbench.control import control_checks
from fhhbench.judge import passed
from fhhbench.spec import Spec
from test_fhhbench_harness import run_cell


@pytest.mark.parametrize("cell,clients", [("zipf4.trusted", 20000), ("rides.secure", 20000)])
def test_the_control_is_not_correct(cell, clients):
    spec = Spec(REPO)
    w = spec.cell(cell)
    cfg, mix = spec.config(w["config"]), dict(spec.traffic(w["traffic"]), clients=clients)
    if cfg["distribution"] == "zipf":  # a data_len the test holds, the widths of the rest
        cfg = dict(cfg, data_len=64, num_sites=100)
    for seed in (11, 12, 2**34 + 13):
        checks = control_checks(spec.sampler(cfg["distribution"]), cfg, mix, seed)
        assert not passed(checks)
        assert checks["count_gap"]["value"] > 0 and checks["empty_reference"]["value"] == 0


def stale(monkeypatch):
    """A step that returns its state unchanged: every collection answers
    with the first one's hitters."""
    from fuzzyheavyhitters_torch.protocol import driver

    real, first = driver.Leader.run, []

    def run(self, *a, **k):
        if not first:
            first.append(real(self, *a, **k))
        return first[0]
    monkeypatch.setattr(driver.Leader, "run", run)


def half_batch(monkeypatch):
    """Half of the clients left out, the counts of the rest doubled."""
    from fuzzyheavyhitters_torch.protocol import collect

    real = collect.counts_by_pattern

    def counts(p0, p1, masks, alive_keys, alive_nodes):
        half = alive_keys.clone()
        half[half.shape[0] // 2:] = False
        return 2 * real(p0, p1, masks, half, alive_nodes)
    monkeypatch.setattr(collect, "counts_by_pattern", counts)


def no_exchange(monkeypatch):
    """The exchange between the two servers left out: server 0 compares its
    share bits with none."""
    from fuzzyheavyhitters_torch.protocol import collect

    real = collect.counts_by_pattern
    monkeypatch.setattr(collect, "counts_by_pattern",
                        lambda p0, p1, *rest: real(p0, p0 & 0, *rest))


def altered_answer(monkeypatch):
    """One hitter's count altered where the leader produces it."""
    from fuzzyheavyhitters_torch.protocol import driver

    real = driver.Leader.run

    def run(self, *a, **k):
        res = real(self, *a, **k)
        res.counts = res.counts.copy()
        res.counts[:1] += 1
        return res
    monkeypatch.setattr(driver.Leader, "run", run)


@pytest.mark.parametrize("fault", [None, stale, half_batch, no_exchange, altered_answer],
                         ids=lambda f: "sound" if f is None else f.__name__)
def test_a_fault_in_the_timed_path_reads_not_correct(tiny_root, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    rc, line = run_cell(tiny_root, "tinyz.trusted", 0)
    assert rc == 0 and line["correct"] is (fault is None)
