"""The leader loop's phase clock and the program's spans on the profiler's
clock, on the CPU:

(a) under ``torch.profiler`` a trusted and a secure crawl show each phase of
    each round as an ``fhh.*`` range inside its round's ``fhh.level``, and
    keygen's host part and the sessions as ``fhh.keygen.host`` and
    ``fhh.sessions.*``; with no profiler no range is ever entered;
(b) ``Leader.timings`` holds one entry a round of every phase;
(c) ``driver.PhaseClock`` over stand-in events takes no events for the
    leader's phases with no profiler; under one it reads a round's phases
    only after a readback has waited for them, or at the crawl's end, and
    waits on an event only there; on the trace ring each phase span is a
    child of its round's ``level`` span, and no two sibling spans partly
    overlap;
(d) an ``FHH_PROFILE`` capture merged into the trace ring lands on the
    ring's timeline;
(e) ``obs.devmem``'s watermark is the allocator's own peak."""

import contextlib
import itertools
import json
import random
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fuzzyheavyhitters_torch.obs import alerts, devmem, metrics, trace
from fuzzyheavyhitters_torch.ops import ibdcf
from fuzzyheavyhitters_torch.protocol import driver
from fuzzyheavyhitters_torch.utils import bits

L, N = 6, 40
ROUND = ("expand", "count", "prune", "advance")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("FHH_TRACE_DIR", "FHH_PROFILE", "FHH_PROFILE_LEVELS"):
        monkeypatch.delenv(k, raising=False)
    trace._refresh()
    yield
    trace._refresh()


def _keys(seed: int = 3):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.full((N - 8, 1), 9), rng.integers(0, 1 << L, size=(8, 1))])
    pts_bits = np.array([[bits.int_to_bits(L, int(v)) for v in row] for row in pts])
    return ibdcf.gen_l_inf_ball(pts_bits, 1, rng, device="cpu")


def _leader(keys, secure: bool):
    sessions = None
    if secure:
        sessions = driver.make_sessions(driver.session_material(random.Random(5)), "cpu")
    return driver.Leader(*driver.make_servers(*keys), n_dims=1, data_len=L, f_max=16,
                         secure=sessions)


def _ranges(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("fhh.")]


# -- (a) profiler ranges --------------------------------------------------------


@pytest.mark.parametrize("secure", [False, True], ids=["trusted", "secure"])
def test_crawl_phases_are_profiler_ranges_inside_their_round(secure):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lead = _leader(_keys(), secure)
        res = lead.run(nreqs=N, threshold=0.1)
    assert res.paths.shape[0] > 0
    got = _ranges(prof)
    names = {n for n, _, _ in got}
    want = {f"fhh.{p}" for p in ("level", "keygen.host") + ROUND}
    if secure:
        want |= {"fhh.otext", "fhh.b2a", "fhh.field", "fhh.sessions.material",
                 "fhh.sessions.setup"}
    assert want <= names
    levels = sorted((s, e) for n, s, e in got if n == "fhh.level")
    assert len(levels) == L
    for n, s, e in got:
        if n == "fhh.level" or n.removeprefix("fhh.") not in ROUND + driver.SECURE_PHASES:
            continue
        assert any(a <= s and e <= b for a, b in levels), n  # inside its round
    for a, b in levels:  # one of each phase a round
        inside = [n for n, s, e in got if a <= s and e <= b and n != "fhh.level"]
        assert all(inside.count(f"fhh.{p}") == 1 for p in ROUND), inside
    # keygen's host part and the sessions lie outside every round
    for n, s, e in got:
        if n in ("fhh.keygen.host", "fhh.sessions.material", "fhh.sessions.setup"):
            assert not any(a <= s < b for a, b in levels), n


def test_no_range_without_a_profiler(monkeypatch):
    entered = []

    def counting(real):
        class Counting:
            def __init__(self, name, *args):
                self.name, self.inner = name, real(name, *args)

            def __enter__(self):
                entered.append(self.name)
                return self.inner.__enter__()

            def __exit__(self, *exc):
                return self.inner.__exit__(*exc)

        return Counting

    # either kind of range the spans may open
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    if getattr(torch._C._profiler, "_RecordFunctionFast", None) is not None:
        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                            counting(torch._C._profiler._RecordFunctionFast))
    _leader(_keys(), False).run(nreqs=N, threshold=0.1)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _leader(_keys(), False).run(nreqs=N, threshold=0.1)
    assert "fhh.level" in entered and "fhh.keygen.host" in entered


# -- (b) one entry a round ----------------------------------------------------------


@pytest.mark.parametrize("secure", [False, True], ids=["trusted", "secure"])
def test_timings_hold_one_entry_a_round(secure):
    lead = _leader(_keys(), secure)
    lead.run(nreqs=N, threshold=0.1)
    names = ROUND + (driver.SECURE_PHASES if secure else ())
    assert set(lead.timings) == set(names)
    for k in names:
        assert len(lead.timings[k]) == L and all(v >= 0 for v in lead.timings[k]), k
    rep = lead.obs.report()["phases"]
    for k in ("level", "fss", "field") + ROUND:  # the JAX names fed from the phase spans
        assert set(rep[k]["by_level"]) == {str(lv) for lv in range(L)}, k
    assert rep["expand"]["seconds"] == pytest.approx(rep["fss"]["seconds"])


# -- (c) the clock waits for nothing -------------------------------------------------


class FakeEvent:
    """A stand-in for a CUDA timing event that logs what the clock does."""

    ids = itertools.count()
    log: list = []

    def __init__(self, enable_timing=False):
        self.id, self.t = next(self.ids), None

    def record(self):
        self.t = time.perf_counter()
        self.log.append(("record", self.id))

    def elapsed_time(self, end):
        self.log.append(("read", end.id))
        return (end.t - self.t) * 1e3

    def query(self):  # never done by itself: every read waits, so each wait is logged
        return False

    def synchronize(self):
        self.log.append(("sync", self.id))


def test_phase_clock_reads_after_a_readback_or_at_the_crawl_end(monkeypatch):
    log = FakeEvent.log = []

    class OnCard(driver.PhaseClock):  # the card's clock, over stand-in events
        def __init__(self, *args):
            super().__init__(*args)
            self.cuda = True

        @contextlib.contextmanager
        def __call__(self, name, host=False):
            with super().__call__(name, host) as sp:
                yield sp
            if not host:
                log.append(("phase", self.level, name, self._marks[-1][2].id))
            if name == "count":  # its body held the round's readback
                log.append(("readback", self.level))

    monkeypatch.setattr(driver, "PhaseClock", OnCard)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    lead = _leader(_keys(), False)
    lead.run(nreqs=N, threshold=0.1)
    # with no profiler the leader's phases take no events: host seconds
    assert not [e for e in log if e[0] != "readback"]
    for k in ROUND:
        assert len(lead.timings[k]) == L and all(v >= 0 for v in lead.timings[k]), k
    log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        lead.run(nreqs=N, threshold=0.1)
    assert {k: len(v) for k, v in lead.timings.items()} == dict.fromkeys(ROUND, L)
    assert all(v > 0 for k in ("expand", "count", "advance") for v in lead.timings[k])
    readback = {e[1]: i for i, e in enumerate(log) if e[0] == "readback"}
    assert sorted(readback) == list(range(L))
    bounds = [readback[lv] for lv in range(L)] + [len(log)]
    phases = {e[3]: (e[1], e[2]) for e in log if e[0] == "phase"}
    assert sorted(n for _, n in phases.values()) == sorted(["expand", "count", "advance"] * L)
    waits = [(i, e[0], e[1]) for i, e in enumerate(log) if e[0] in ("read", "sync")]
    assert sorted(x for _, k, x in waits if k == "read") == sorted(phases)  # each read once
    for i, _, end in waits:
        level, name = phases[end]
        # expand and count, at their round's readback; the advance, which
        # the device runs after it, at the next round's, or at the crawl's
        # end; never before
        at = level if name != "advance" else min(level + 1, L - 1)
        assert bounds[at] < i < bounds[at + 1], (level, name)


def test_phase_spans_nest_in_their_round_on_the_ring(tmp_path, monkeypatch):
    monkeypatch.setenv("FHH_TRACE_DIR", str(tmp_path / "ring"))
    trace._refresh()
    leads = [_leader(_keys(), False), _leader(_keys(), True)]
    with trace.root("crawl"):
        for lead in leads:
            lead.run(nreqs=N, threshold=0.1)
    trace.flush()
    events = [e for e in trace.load_events(str(tmp_path / "ring")) if e.get("ph") == "X"]
    levels = {e["span"]: e for e in events if e["name"] == "level"}
    phases = [e for e in events if e["name"] in ROUND + driver.SECURE_PHASES]
    assert len(levels) == 2 * L
    assert {e["name"] for e in phases} >= set(ROUND) | {"otext", "b2a", "field"}
    for e in phases:  # each phase a child of its own round's span
        assert levels[e["parent"]]["level"] == e["level"], e
    siblings: dict = {}
    for e in events:
        siblings.setdefault(e.get("parent"), []).append(e)
    for group in siblings.values():  # slices of one parent never partly overlap
        group.sort(key=lambda e: e["ts"])
        for a, b in zip(group, group[1:]):
            assert b["ts"] >= a["ts"] + a["dur"] - 2e-6, (a["name"], b["name"])


# -- (d) a capture on the ring's timeline ----------------------------------------------


def test_merged_capture_lands_on_the_ring_timeline(tmp_path, monkeypatch):
    monkeypatch.setenv("FHH_TRACE_DIR", str(tmp_path / "ring"))
    monkeypatch.setenv("FHH_PROFILE", str(tmp_path / "prof"))
    trace._refresh()
    lead = _leader(_keys(), False)
    with trace.root("crawl"), trace.profile_capture("crawl") as live:
        assert live
        lead.run(nreqs=N, threshold=0.1)
    trace.flush()
    clocks = [e for e in trace.load_events(str(tmp_path / "ring"))
              if e.get("name") == trace.CLOCK_RANGE]
    assert len(clocks) == 1 and {"prof_ns", "path"} <= set(clocks[0]["args"])
    out = tmp_path / "merged.json"
    assert trace.merge(str(tmp_path / "ring"), str(out))["ok"]
    events = json.loads(out.read_text())["traceEvents"]
    span = lambda name: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                               if e.get("name") == name and e.get("ph") == "X")
    ring, cap = span("level"), span("fhh.level")
    assert len(ring) == len(cap) == L
    for (a, b), (c, d) in zip(ring, cap):
        assert a - 5000 <= c and d <= b + 5000  # µs: within 5 ms of the ring's span


# -- (e) the watermark ---------------------------------------------------------------


def test_devmem_watermark_is_the_allocator_peak(monkeypatch):
    stats = {"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 9_500}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda *a, **k: dict(stats))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a, **k: (0, 10_000))

    def refuse(*a, **k):
        raise AssertionError("the benchmark reads the peak over its window: never reset it")

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", refuse)
    reg = metrics.Registry("t-watermark")
    assert devmem.sample(reg, phase="level") == 100
    assert reg.gauge_value("hbm_in_use_bytes") == 100
    assert reg.gauge_value("hbm_watermark_bytes") == 9_500  # not the 100 at the sample
    assert reg.gauge_value("hbm_watermark_bytes:level") == 100
    stats.update({"allocated_bytes.all.current": 200, "allocated_bytes.all.peak": 9_000})
    devmem.sample(reg)
    assert reg.gauge_value("hbm_watermark_bytes") == 9_500  # monotone
    alerts._reset_for_tests()
    try:
        alerts.evaluate_registries([reg])  # 95% of the card at its high water
        assert [a["rule"] for a in alerts.fired()] == ["hbm_high_water"]
    finally:
        alerts._reset_for_tests()
