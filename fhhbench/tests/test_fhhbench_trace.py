"""The traced run's reductions on a made-up profile: busy time, idle
share, rooflines and the breakdown."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import REPO
from fhhbench import roofline
from fhhbench.spec import Spec
from fhhbench.trace import Trace

MS = 1_000_000  # ns


def made_up() -> Trace:
    # a 10 ms collection: expand 0-2 and 3-5 ms, a gather 4-6 ms, a copy 8-9 ms
    return Trace(
        span=(0, 10 * MS),
        kernels=[("fhh_expand_kernel(x)", 0, 2 * MS), ("fhh_expand_kernel(x)", 3 * MS, 5 * MS),
                 ("index_elementwise_kernel", 4 * MS, 6 * MS)],
        copies=[("Memcpy DtoH", 8 * MS, 9 * MS)],
        host=[("aten::item", 6 * MS, 8 * MS), ("fhhbench.crawl", 0, 10 * MS)],
        calls={"expand": [(3.35e9, 0.0), (3.35e9, 0.0)]},  # 1 ms of bytes each
        kernel_names={"expand": "fhh_expand_kernel", "keygen": "fhh_keygen_kernel"})


def read(metric: str, trace: Trace):
    run = SimpleNamespace(trace=trace, collections=[], window_s=1.0)
    return Spec(REPO).reader(metric).read(run)


def test_busy_and_idle():
    t = made_up()
    assert t.busy() == [[0, 2 * MS], [3 * MS, 6 * MS], [8 * MS, 9 * MS]]
    assert t.busy_s() == pytest.approx(6e-3)
    assert read("device.idle_share", t) == pytest.approx(40.0)
    assert read("crawl.torch_share", t) == pytest.approx(100 * 2 / 6)


def test_roofline_share():
    t = made_up()
    assert roofline.bound_s(3.35e9, 0) == pytest.approx(1e-3)
    assert read("expand_roofline", t) == pytest.approx(50.0)
    assert read("keygen_roofline", t) is None  # no call: no share, never 0
    t.calls["expand"].append((1.0, 1.0))  # calls and launches disagree
    assert read("expand_roofline", t) is None


def test_breakdown():
    b = made_up().breakdown()
    assert b["device_ops"][0] == ["fhh_expand_kernel(x)", pytest.approx(4e-3)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    # 2-3 ms and 9-10 ms under the crawl step alone, 6-8 ms inside aten::item
    assert gaps == {"fhhbench.crawl": pytest.approx(2e-3), "aten::item": pytest.approx(2e-3)}


def test_window_readers():
    c = [SimpleNamespace(phases={"otext": 0.5, "b2a": 0.25}, base_ot_s=2.0, clients=10,
                         seconds=2.0, error=None),
         SimpleNamespace(phases={"otext": 0.5, "b2a": 0.25}, base_ot_s=4.0, clients=10,
                         seconds=2.0, error=None)]
    run = SimpleNamespace(trace=None, collections=c, window_s=4.0, peak_bytes=2e9, setup_s=3.0)
    spec = Spec(REPO)
    assert spec.reader("secure.otext_share").read(run) == pytest.approx(25.0)
    assert spec.reader("secure.b2a_share").read(run) == pytest.approx(12.5)
    assert spec.reader("session.base_ot_s").read(run) == pytest.approx(3.0)
    assert spec.reader("clients_per_s").read(run) == pytest.approx(5.0)
    assert spec.reader("peak_device_gb").read(run) == pytest.approx(2.0)
