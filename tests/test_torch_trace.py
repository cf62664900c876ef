"""The port's distributed tracing and profiler hooks (``obs/trace.py``)
against the JAX package's on the same inputs, tolerance zero for counts and
key sets:

(a) the JSONL ring rotates at ``FHH_TRACE_RING`` events into one ``.1``
    sibling, as the JAX ring does; ``clock_offsets`` and ``to_chrome`` agree
    on the same events; ``merge`` and ``validate`` over segments written by
    both packages (a port leader's call with a JAX server's spans under it,
    and the reverse) give one timeline with no orphan;
(b) ``profile_capture``'s gating is the JAX package's (``FHH_PROFILE``,
    ``FHH_PROFILE_LEVELS``, one capture at a time, the active trace id), a
    capture on the CPU writes its Chrome trace, and a profiler that fails to
    start leaves a whole socket crawl running with its hitters unchanged;
(c) a traced crawl across a mixed pair (a JAX server 0, a port server 1)
    under the port leader, with ``FHH_PROFILE_LEVELS`` on: the rings of both
    packages merge into one timeline that validates, with one ``crawl``
    root, every server verb span under a leader call span, the data-plane
    arrivals under the sender's spans, and the port server's two level
    captures recorded with the crawl's trace id.

Both trace modules keep process state: every test refreshes both."""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.obs import metrics as tmetrics
from fuzzyheavyhitters_torch.obs import trace as ttrace
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jmetrics, jtrace, jrpc, jconfig) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.obs.metrics", "fuzzyheavyhitters_tpu.obs.trace",
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.utils.config")
assert jrpc.obstrace is jtrace  # one load: the server's trace module is this one

L, N = 5, 12
_ENV = ("FHH_TRACE_DIR", "FHH_TRACE_RING", "FHH_PROFILE", "FHH_PROFILE_LEVELS")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' trace state fresh, the JAX profiler a no-op (its
    gating is what is compared), the JAX modules installed."""
    import jax

    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda *a, **k: None)
    # span ids of the two modules must not collide inside one process
    monkeypatch.setattr(jtrace, "_PROC_ID", "jaxproc")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch_ref.installed(), torch_ref.attached(jrpc.obs, trace=jtrace):
        ttrace._refresh()
        jtrace._refresh()
        yield
        for k in _ENV:
            os.environ.pop(k, None)
        ttrace._refresh()
        jtrace._refresh()
    torch.set_num_threads(n)


def _enable(monkeypatch, trace_dir, **env):
    monkeypatch.setenv("FHH_TRACE_DIR", str(trace_dir))
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    ttrace._refresh()
    jtrace._refresh()


# -- (a) rings, clocks, merge -------------------------------------------------


def _ring(m, tag, n):
    m.claim_tag(tag)
    for i in range(n):
        m.instant("x", comp="c", i=i)
    m.flush()


def test_ring_rotation_matches_jax(tmp_path, monkeypatch):
    _enable(monkeypatch, tmp_path, FHH_TRACE_RING=1024)
    _ring(ttrace, "port", 1500)
    _ring(jtrace, "jax", 1500)
    pid = os.getpid()
    sizes = {}
    for tag in ("port", "jax"):
        base = tmp_path / f"fhh_trace_{tag}_{pid}.jsonl"
        sizes[tag] = (len(base.read_text().splitlines()),
                      len((tmp_path / f"{base.name}.1").read_text().splitlines()))
    assert sizes["port"] == sizes["jax"] == (1500 - 1024, 1024)
    events = ttrace.load_events(str(tmp_path))
    assert len(events) == len(jtrace.load_events(str(tmp_path))) == 3000
    # a torn tail line (a killed process) is skipped, not fatal
    with open(tmp_path / f"fhh_trace_port_{pid}.jsonl", "a") as f:
        f.write('{"ph": "i", "na')
    assert len(ttrace.load_events(str(tmp_path))) == 3000


def test_clock_offsets_and_chrome_match_jax():
    events = [
        {"ph": "C", "comp": "server0", "ts": 10.0, "off": 0.5, "rtt": 0.2},
        {"ph": "C", "comp": "server0", "ts": 11.0, "off": 0.25, "rtt": 0.01},
        {"ph": "C", "comp": "server1", "ts": 12.0, "off": -0.125},
        {"ph": "C", "comp": "server1", "ts": 13.0, "off": 0.375},
        {"ph": "X", "name": "call:tree_crawl", "comp": "leader", "ts": 20.0, "dur": 1.0,
         "trace": "crawl-a-1", "span": "a-2"},
        {"ph": "X", "name": "fss", "comp": "server0", "ts": 20.5, "dur": 0.25,
         "trace": "crawl-a-1", "span": "b-1", "parent": "a-2", "level": 3},
        {"ph": "X", "name": "gc_ot", "comp": "server1:t1", "ts": 20.5, "dur": -0.0,
         "trace": "crawl-a-1", "span": "c-1", "parent": "a-2", "error": True},
        {"ph": "i", "name": "heartbeat", "comp": "server1", "ts": 21.0,
         "args": {"span": "fss"}},
    ]
    assert ttrace.clock_offsets(events) == jtrace.clock_offsets(events) == {
        "server0": 0.25, "server1": 0.375}
    assert ttrace.to_chrome(events) == jtrace.to_chrome(events)
    assert ttrace.validate(events) == jtrace.validate(events)
    bad = events + [{"ph": "X", "name": "x", "comp": "s", "ts": 1, "dur": 1,
                     "trace": "crawl-a-1", "span": "z", "parent": "nope"}]
    assert not ttrace.validate(bad)["ok"] and ttrace.validate(bad) == jtrace.validate(bad)


def _cross(lead_trace, lead_name, srv_trace, srv_metrics, srv_name):
    """A leader call of one package with a server span of the other under
    it, an arrival instant under the server's span, and a clock sample."""
    with lead_trace.root("crawl") as tid:
        wire, state = lead_trace.wire_ctx()
        tok = srv_trace.activate(wire)
        reg = srv_metrics.Registry(srv_name)
        with reg.span("verb:tree_crawl"):
            with reg.span("fss", level=2):
                sid = srv_trace.current_ids()[1]
            srv_trace.instant("plane_recv", comp=srv_name, trace_id=tid, parent=sid, chan="c")
        srv_trace.deactivate(tok)
        lead_trace.call_event("tree_crawl", lead_name, state)
    lead_trace.note_clock(srv_name, 0.002, 0.001)
    return tid


def test_merge_validates_segments_of_both_packages(tmp_path, monkeypatch):
    _enable(monkeypatch, tmp_path)
    ttrace.claim_tag("leader")
    jtrace.claim_tag("s0")
    t1 = _cross(ttrace, "leader", jtrace, jmetrics, "server0")
    t2 = _cross(jtrace, "leader", ttrace, tmetrics, "server1")
    ttrace.flush()
    jtrace.flush()
    out = tmp_path / "merged.json"
    got = ttrace.merge(str(tmp_path), str(out))
    want = jtrace.validate(jtrace.load_events(str(tmp_path)))
    assert got["ok"] and got["errors"] == [] and want["ok"]
    assert got["traces"] == want["traces"] == sorted([t1, t2])
    assert got["spans"] == want["spans"] == 6
    doc = json.loads(out.read_text())
    assert doc["otherData"]["clock_offsets"] == {"server0": 0.002, "server1": 0.002}
    assert {e["args"]["name"] for e in doc["traceEvents"] if e.get("name") == "process_name"} \
        == {"leader", "server0", "server1"}
    assert ttrace._main(["validate", "-d", str(tmp_path)]) == 0


# -- (b) profiler hooks ---------------------------------------------------------


def _gate(m, level, nested=False):
    with m.profile_capture("level" if level is not None else "crawl", level=level) as on:
        if nested:
            with m.profile_capture("crawl") as inner:
                return on, inner
        return on


@pytest.mark.parametrize("levels,level,want", [
    (None, None, True), (None, 3, False), ("2,5", 2, True), ("2,5", None, False),
    ("2,5", 3, False), ("x", 2, False)])
def test_profile_gating_matches_jax(tmp_path, monkeypatch, levels, level, want):
    assert _gate(ttrace, level) is _gate(jtrace, level) is False  # FHH_PROFILE unset
    monkeypatch.setenv("FHH_PROFILE", str(tmp_path / "prof"))
    if levels is not None:
        monkeypatch.setenv("FHH_PROFILE_LEVELS", levels)
    assert _gate(ttrace, level) is _gate(jtrace, level) is want
    got, jgot = ttrace.profile_captures(), jtrace.profile_captures()
    assert len(got) == len(jgot) == int(want)
    if want:
        assert {k: v for k, v in got[0].items() if k not in ("ts", "path")} == {
            k: v for k, v in jgot[0].items() if k != "ts"}
        assert os.path.exists(got[0]["path"])


def test_one_capture_at_a_time_with_the_trace_id(tmp_path, monkeypatch):
    _enable(monkeypatch, tmp_path / "trace")
    monkeypatch.setenv("FHH_PROFILE", str(tmp_path / "prof"))
    ttrace.claim_tag("s1")
    for m in (ttrace, jtrace):
        with m.root("crawl") as tid:
            assert _gate(m, None, nested=True) == (True, False)
        (cap,) = m.profile_captures()
        assert cap["trace"] == tid and cap["kind"] == "crawl" and cap["level"] is None
    path = ttrace.profile_captures()[0]["path"]
    name = os.path.basename(path)
    assert name.startswith(f"fhh_profile_s1_{os.getpid()}_crawl_all_crawl-")
    assert "traceEvents" in json.loads(open(path).read())


# -- socket crawls ----------------------------------------------------------------


def _cfg_kw(mode):
    return dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=5, num_sites=4,
                threshold=0.3, zipf_exponent=1.03, server0="127.0.0.1:1",
                server1="127.0.0.1:2", distribution="zipf", f_max=64,
                **({"secure_exchange": True, "ot_path": "ot2s"} if mode == "ot2s" else {}))


def _keys():
    rng = np.random.default_rng(7)
    pts = np.concatenate([np.full((N - 4, 1), 11), rng.integers(0, 1 << L, size=(4, 1))])
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


async def _crawl(kinds, mode):
    """A pair of ``kinds`` under the port leader -> the hitters."""
    tcfg, jcfg = tconfig.Config(**_cfg_kw(mode)), jconfig.Config(**_cfg_kw(mode))
    make = {"port": lambda sid: trpc.CollectorServer(sid, tcfg, "cpu"),
            "jax": lambda sid: jrpc.CollectorServer(sid, jcfg)}
    s0, s1 = make[kinds[0]](0), make[kinds[1]](1)
    p0, p1 = chip_smoke.free_ports()
    t1 = asyncio.create_task(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    t0 = asyncio.create_task(s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1))
    await asyncio.wait_for(asyncio.gather(t0, t1), 60)
    clients = []
    try:
        for p in (p0, p1):
            clients.append(await trpc.CollectorClient.connect("127.0.0.1", p))
        lead = tleader.RpcLeader(tcfg, *clients)
        await asyncio.gather(*(c.call("reset") for c in clients))
        await lead.upload_keys(*_keys())
        res = await asyncio.wait_for(lead.run(N), 300)
        return {tuple(int(v) for v in row): int(c)
                for row, c in zip(res.decode_ints(), res.counts)}
    finally:
        for c in clients:
            await c.aclose()
        for s in (s0, s1):
            if s._peer_writer is not None:
                s._peer_writer.close()
        for s in (s0, s1):
            await asyncio.wait_for(s.aclose(), 30)


def test_profiler_failure_leaves_the_crawl_running(tmp_path, monkeypatch):
    """``FHH_PROFILE`` on the leader's whole crawl with a profiler that
    cannot start: the capture degrades (no capture recorded), the crawl
    runs on to the hitters of an unprofiled run."""
    want = asyncio.run(_crawl(("port", "port"), "trusted"))
    monkeypatch.setenv("FHH_PROFILE", str(tmp_path / "prof"))

    def refuse(*a, **k):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    seen = []
    monkeypatch.setattr("fuzzyheavyhitters_torch.obs.logs.emit",
                        lambda event, **kw: seen.append((event, kw)))
    assert asyncio.run(_crawl(("port", "port"), "trusted")) == want
    assert ttrace.profile_captures() == []
    assert [kw["error"] for e, kw in seen if e == "profile.unavailable"] == [
        "RuntimeError: profiler busy"]


@pytest.mark.parametrize("mode", ["trusted", "ot2s"])
def test_traced_mixed_pair_merges_into_one_timeline(tmp_path, monkeypatch, mode):
    trace_dir = tmp_path / "trace"
    _enable(monkeypatch, trace_dir, FHH_PROFILE=tmp_path / "prof", FHH_PROFILE_LEVELS="3,4")
    ttrace.claim_tag("port")
    jtrace.claim_tag("jax")
    hitters = asyncio.run(_crawl(("jax", "port"), mode))
    assert hitters
    ttrace.flush()
    jtrace.flush()
    verdict = ttrace.merge(str(trace_dir), str(tmp_path / "merged.json"))
    assert verdict["ok"], verdict["errors"]
    events = ttrace.load_events(str(trace_dir))
    (tid,) = verdict["traces"]  # one crawl root: every verb rode it
    assert tid.startswith("crawl-")
    spans = {e["span"]: e for e in events if e.get("ph") == "X"}
    verbs = [e for e in spans.values() if e["name"].startswith("verb:")]
    assert {e["comp"] for e in verbs} == {"server0", "server1"}
    for e in verbs:
        parent = spans[e["parent"]]
        assert parent["comp"] == "leader" and parent["name"] == "call:" + e["name"][5:]
    # each server's data-plane arrivals hang under the other's spans
    arrivals = [e for e in events if e.get("name") == "plane_recv"]
    assert {e["comp"] for e in arrivals} == {"server0", "server1"}
    for e in arrivals:
        assert spans[e["parent"]]["comp"] != e["comp"]
    # the port server's captures of levels 3 and 4, in the crawl's trace
    caps = ttrace.profile_captures()
    assert [(c["kind"], c["level"], c["trace"]) for c in caps] == [
        ("level", 3, tid), ("level", 4, tid)]
    for c in caps:
        assert "traceEvents" in json.loads(open(c["path"]).read())
    # the phases of every level on both servers are in the timeline
    for comp in ("server0", "server1"):
        for ph in ("fss", "gc_ot", "field"):
            assert {e["level"] for e in spans.values()
                    if e["comp"] == comp and e["name"] == ph} == set(range(L)), (comp, ph)
