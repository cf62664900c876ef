"""The port's live plane (``obs/exporter.py``, ``obs/alerts.py``,
``obs/ops.py``) against the JAX package's, tolerance zero (the output is
text and counts):

(a) the exporter: one set of registries fed the same counters, gauges,
    phase timings and histogram observations in each package renders the
    same exposition text (timings fixed, never read from the clock); the
    families, types and labels of the naming contract; the buckets rebuilt
    from a scrape give the run report's ``slo`` quantiles; producers pruned
    and a failing one isolated; bind, scrape and stop on an ephemeral port;
    no socket without ``FHH_METRICS_PORT``; a bad port and a bind conflict
    degrade to a ``metrics.disabled`` warning;
(b) the alerts: over the same session rows and registries the port fires
    the JAX package's list; a stall fires once across evaluations; the
    backlog, SLO and device-memory rules (the capacity injected, and the
    rule skipped where the CPU reports none); a kernel build after the
    warmup; a collector's ``status`` and the trace ring carry a fired alert;
    ``migration_stuck`` from a fleet placer's gauge while a move hangs;
(c) ``ops``: ``parse_prometheus``, ``buckets_to_hist`` and ``render_top``
    equal the JAX package's on the scrapes of a mixed pair (a port server 0
    and a JAX server 1, each package's exporter in this process) after a
    crawl, and ``ops top --once`` prints the frame.

The JAX modules come through ``tests/torch_ref.reference`` and run inside
``torch_ref.installed()`` (the exporter and the alerts import each other at
call time)."""

import asyncio
import contextlib
import io
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch import obs as tobs
from fuzzyheavyhitters_torch.obs import alerts as talerts
from fuzzyheavyhitters_torch.obs import devmem as tdevmem
from fuzzyheavyhitters_torch.obs import exporter as texporter
from fuzzyheavyhitters_torch.obs import logs as tlogs
from fuzzyheavyhitters_torch.obs import metrics as tmetrics
from fuzzyheavyhitters_torch.obs import ops as tops
from fuzzyheavyhitters_torch.obs import trace as ttrace
from fuzzyheavyhitters_torch.obs.hist import Histogram
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import fleet as tfleet
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jobs, jexporter, jalerts, jops, jmetrics, jrpc, jleader, jconfig) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.obs", "fuzzyheavyhitters_tpu.obs.exporter",
    "fuzzyheavyhitters_tpu.obs.alerts", "fuzzyheavyhitters_tpu.obs.ops",
    "fuzzyheavyhitters_tpu.obs.metrics", "fuzzyheavyhitters_tpu.protocol.rpc",
    "fuzzyheavyhitters_tpu.protocol.leader_rpc", "fuzzyheavyhitters_tpu.utils.config")

PKGS = {"port": (texporter, talerts, tmetrics, tops), "jax": (jexporter, jalerts, jmetrics, jops)}
L, N = 5, 12


@contextlib.contextmanager
def _own_jax_obs():
    """This file's load of the JAX ``obs`` modules in ``sys.modules`` and on
    their package for the block: the exporter and the alerts import each
    other at call time, and another test file's load may be the one
    ``torch_ref.installed`` put there."""
    mine = {"fuzzyheavyhitters_tpu.obs": jobs, "fuzzyheavyhitters_tpu.obs.alerts": jalerts,
            "fuzzyheavyhitters_tpu.obs.exporter": jexporter}
    saved = {k: sys.modules.get(k) for k in mine}
    sys.modules.update(mine)
    try:
        with torch_ref.attached(jobs, alerts=jalerts, exporter=jexporter):
            yield
    finally:
        for k, old in saved.items():
            if old is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = old


@pytest.fixture(autouse=True)
def _plane(monkeypatch):
    """Every test starts and ends with both packages' exporters stopped, no
    alert fired and the warmup flag down; the JAX modules loaded."""
    monkeypatch.delenv(texporter.ENV_PORT, raising=False)
    monkeypatch.delenv(texporter.ENV_HOST, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch_ref.installed(), _own_jax_obs():
        for exp, al, _, _ in PKGS.values():
            exp.stop()
            al._reset_for_tests()
        tdevmem._reset_for_tests()
        yield
        for exp, al, _, _ in PKGS.values():
            exp.stop()
            al._reset_for_tests()
        tdevmem._reset_for_tests()
    torch.set_num_threads(n)


def _get(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def _only(monkeypatch, pkg, regs):
    """Render and evaluate over ``regs`` alone (the process holds other
    tests' registries, which differ between the packages)."""
    exp, al, _, _ = PKGS[pkg]
    monkeypatch.setattr(exp, "all_registries", lambda: list(regs))
    monkeypatch.setattr(al, "all_registries", lambda: list(regs))


def _feed(m):
    """The same metric operations on registries of module ``m``, timings
    fixed."""
    r = m.Registry("rtexp")
    r.count("rt_frames", 3)
    r.count("data_bytes_sent", 4096, level=2)
    r.gauge("rt_depth_keys", 7)
    r.count("fresh_compiles:level")  # the colon becomes a key label
    r.timer_add("rt_phase", 1.5)
    r.timer_add("fss", 0.25, level=3)
    for v in (0.0003, 0.002, 0.015, 0.04, 0.09, 3.5):
        r.observe("level_latency", v)
    r.observe("rpc:tree_crawl", 0.02)
    t = m.Registry("server7:acme")  # a collection's registry
    t.gauge("rt_depth_keys", 9)
    t.gauge("hbm_in_use_bytes", 95.0)
    t.gauge("hbm_limit_bytes", 100.0)
    return [r, t]


# -- (a) the exporter ---------------------------------------------------------


def test_render_matches_jax(monkeypatch):
    texts = {}
    for pkg, (exp, al, m, _) in PKGS.items():
        regs = _feed(m)
        _only(monkeypatch, pkg, regs)
        al.evaluate_sessions({"acme": {"last_progress_s": 500.0, "queue_depth": 200000,
                                       "phase": "verb:tree_crawl", "level": 3}}, "server7")
        exp.add_producer(lambda: ['fhh_probe_total{registry="x"} 1'])
        texts[pkg] = exp.render()
        del regs
    assert texts["port"] == texts["jax"]
    assert "fhh_alert_active" in texts["port"] and 'key="level"' in texts["port"]


def test_render_families_types_and_labels(monkeypatch):
    regs = _feed(tmetrics)
    _only(monkeypatch, "port", regs)
    text = texporter.render()
    by = {}
    for name, lb, v in tops.parse_prometheus(text):
        by.setdefault(name, []).append((lb, v))

    def one(name, **want):
        return [v for lb, v in by.get(name, []) if all(lb.get(k) == w for k, w in want.items())]

    assert one("fhh_rt_frames_total", registry="rtexp") == [3.0]
    assert one("fhh_data_bytes_sent_total", registry="rtexp") == [4096.0]
    assert one("fhh_rt_depth_keys", registry="rtexp") == [7.0]
    assert one("fhh_rt_depth_keys", registry="server7", collection="acme") == [9.0]
    assert one("fhh_fresh_compiles_total", registry="rtexp", key="level") == [1.0]
    assert one("fhh_rt_phase_seconds_total", registry="rtexp") == [1.5]
    assert one("fhh_rt_phase_runs_total", registry="rtexp") == [1.0]
    assert one("fhh_rpc_seconds_count", registry="rtexp", key="tree_crawl") == [1.0]
    assert one("fhh_level_latency_seconds_bucket", registry="rtexp", le="+Inf") == [6.0]
    assert one("fhh_level_latency_seconds_count", registry="rtexp") == [6.0]
    assert text.count("# TYPE fhh_rt_depth_keys gauge") == 1
    assert "# TYPE fhh_level_latency_seconds histogram" in text


def test_hist_bucket_roundtrip_matches_run_report_slo(monkeypatch):
    r0, r1 = tmetrics.Registry("hrt_s0"), tmetrics.Registry("hrt_s1")
    for v in (0.0003, 0.002, 0.015, 0.04, 0.09):
        r0.observe("level_latency", v)
    for v in (0.0008, 0.004, 0.02, 0.06, 0.1):
        r1.observe("level_latency", v)
    _only(monkeypatch, "port", [r0, r1])
    samples = tops.parse_prometheus(texporter.render())
    rebuilt = []
    for reg in ("hrt_s0", "hrt_s1"):
        series = {n: [(lb, v) for name, lb, v in samples
                      if name == n and lb.get("registry") == reg]
                  for n in ("fhh_level_latency_seconds_bucket", "fhh_level_latency_seconds_sum",
                            "fhh_level_latency_seconds_count")}
        (_, sum_s), = series["fhh_level_latency_seconds_sum"]
        (_, count), = series["fhh_level_latency_seconds_count"]
        rebuilt.append(tops.hist_from_series(series["fhh_level_latency_seconds_bucket"], sum_s,
                                             int(count)))
    merged = Histogram.merged(rebuilt)
    slo = tobs.run_report(registries=[r0, r1])["slo"]["level_latency"]
    assert merged.count == slo["count"] == 10
    assert round(merged.sum, 6) == round(slo["sum_s"], 6)
    for q, key in ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")):
        assert round(merged.quantile(q), 6) == round(slo[key], 6)


def test_producers_prune_and_exception_isolation():
    calls = []

    def live():
        calls.append(1)
        return ["fhh_probe_total 1"]

    def boom():
        raise RuntimeError("producer crash")

    texporter.add_producer(live)
    texporter.add_producer(lambda: None)  # its owner is gone: pruned
    texporter.add_producer(boom)
    assert "fhh_probe_total 1" in texporter.render()
    assert len(texporter._producers) == 2
    assert "fhh_probe_total 1" in texporter.render()
    assert len(calls) == 2


def test_exporter_lifecycle_bind_scrape_stop(monkeypatch):
    monkeypatch.setenv(texporter.ENV_PORT, "0")
    port = texporter.maybe_start("s0")
    assert port and texporter.running() and texporter.port() == port
    assert texporter.maybe_start("s0") == port  # once a process
    status, ctype, body = _get(port)
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert body.startswith("# TYPE fhh_")
    with pytest.raises(urllib.error.HTTPError):
        _get(port, "/other")
    texporter.stop()
    assert not texporter.running() and texporter.port() is None
    texporter.stop()


def test_exporter_disabled_without_env():
    assert texporter.maybe_start("s0") is None and not texporter.running()


def _disabled_lines(monkeypatch, value):
    buf = io.StringIO()
    saved = (tlogs._cfg["fmt"], tlogs._cfg["stream"])
    tlogs.configure(fmt="json", stream=buf)
    try:
        monkeypatch.setenv(texporter.ENV_PORT, value)
        assert texporter.maybe_start("leader") is None and not texporter.running()
    finally:
        tlogs.configure(fmt=saved[0], stream=saved[1])
    return [ln for ln in buf.getvalue().splitlines() if '"metrics.disabled"' in ln]


def test_exporter_degrades_on_bad_port(monkeypatch):
    (line,) = _disabled_lines(monkeypatch, "not-a-port")
    assert '"sev": "warn"' in line and "not-a-port" in line


def test_exporter_degrades_on_bind_conflict(monkeypatch):
    import socket

    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        (line,) = _disabled_lines(monkeypatch, str(blocker.getsockname()[1]))
        assert '"sev": "warn"' in line
    finally:
        blocker.close()


# -- (b) the alerts --------------------------------------------------------------

ROWS = {"acme": {"last_progress_s": 500.0, "queue_depth": 200000, "phase": "verb:tree_crawl",
                 "level": 3},
        "calm": {"last_progress_s": 0.5, "queue_depth": 3}}


def _no_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def test_fired_list_matches_jax(monkeypatch):
    monkeypatch.setenv(talerts.ENV_LEVEL_P95_S[0], "1.0")
    fired = {}
    for pkg, (_, al, m, _) in PKGS.items():
        regs = _feed(m)
        al.evaluate_sessions(ROWS, "server0")
        al.evaluate_registries(regs)
        al.evaluate_sessions(ROWS, "server0")  # fire once
        fired[pkg] = (_no_ts(al.fired()), al.metrics_lines(),
                      {k: v for k, v in al.status_section().items() if k != "fired"})
    assert fired["port"] == fired["jax"]
    assert [r["rule"] for r in fired["port"][0]] == ["tenant_stall", "ingest_backlog",
                                                    "slo_burn", "hbm_high_water"]


def test_tenant_stall_fires_once_across_evaluations(monkeypatch):
    monkeypatch.setenv(talerts.ENV_STALL_S[0], "0.5")
    rows = {"acme": {"last_progress_s": 2.0, "phase": "crawl", "level": 3, "queue_depth": 0}}
    talerts.evaluate_sessions(rows, "server0")
    talerts.evaluate_sessions(rows, "server0")
    (rec,) = talerts.fired()
    assert (rec["rule"], rec["subject"], rec["phase"], rec["level"]) == (
        "tenant_stall", "server0/acme", "crawl", 3)
    st = talerts.status_section()
    assert st["count"] == 1 and st["dropped"] == 0 and st["fired"] == [rec]
    lines = talerts.metrics_lines()
    assert 'fhh_alerts_fired_total{rule="tenant_stall"} 1' in lines
    assert sum("fhh_alert_active{" in ln for ln in lines) == 1
    talerts.evaluate_sessions(rows, "server1")  # another server: its own subject
    assert len(talerts.fired()) == 2


def test_backlog_slo_and_hbm_rules(monkeypatch):
    monkeypatch.setenv(talerts.ENV_BACKLOG_KEYS[0], "10")
    talerts.evaluate_sessions({"bulk": {"last_progress_s": 0.0, "queue_depth": 100}}, "server1")
    r = tmetrics.Registry("rtslo")
    for _ in range(4):
        r.observe("level_latency", 5.0)
    r.gauge("hbm_in_use_bytes", 95.0)
    r.gauge("hbm_limit_bytes", 100.0)  # an injected capacity: 0.95 > 0.9
    talerts.evaluate_registries([r])
    rules = {rec["rule"] for rec in talerts.fired()}
    assert rules == {"ingest_backlog", "slo_burn", "hbm_high_water"}
    rep = tobs.run_report(registries=[r])
    assert rep["alerts"]["count"] == 3
    assert {rec["rule"] for rec in rep["alerts"]["fired"]} == rules
    talerts._reset_for_tests()
    assert "alerts" not in tobs.run_report(registries=[r])


def test_hbm_rule_skipped_without_capacity_and_recompile_after_warmup(monkeypatch):
    """On the CPU the port's memory sample knows no capacity, so the HBM rule
    is skipped however low its fraction; an ``nvcc`` build counted after the
    warmup fires ``recompile_after_warmup``."""
    monkeypatch.setenv(talerts.ENV_HBM_FRAC[0], "0.000001")
    r = tmetrics.Registry("rtcpu")
    tdevmem.sample(r, phase="status")
    r.gauge("hbm_in_use_bytes", 1 << 20)  # in use, but no capacity known
    assert r.gauge_value("hbm_limit_bytes") is None
    talerts.evaluate_registries([r])
    assert talerts.fired() == []
    # the builds count on a registry of this test's own, not the process's
    # default one, whose count the rule would then find in every later test
    reg = tmetrics.Registry("main")
    monkeypatch.setattr(tdevmem, "default_registry", lambda: reg)
    tdevmem.note_fresh_compile("probe_lib", 0.5)  # before the warmup: not counted
    assert reg.counter_value("fresh_compiles_post_warmup") == 0
    tdevmem.note_warmup_done()
    tdevmem.note_fresh_compile("probe_lib", 0.5)
    assert reg.counter_value("fresh_compiles_post_warmup") == 1
    talerts.evaluate_registries([reg])
    assert [rec["rule"] for rec in talerts.fired()] == ["recompile_after_warmup"]


def _keys(seed=7):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.full((N - 4, 1), 11), rng.integers(0, 1 << L, size=(4, 1))])
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


def _cfg_kw():
    return dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=5, num_sites=4,
                threshold=0.3, zipf_exponent=1.03, server0="127.0.0.1:1",
                server1="127.0.0.1:2", distribution="zipf", f_max=64)


async def _pair_crawl(kinds, after):
    """A pair of ``kinds`` crawls the keys under the port leader; then
    ``after(servers, clients)``."""
    kw = _cfg_kw()
    make = {"port": lambda sid: trpc.CollectorServer(sid, tconfig.Config(**kw), "cpu"),
            "jax": lambda sid: jrpc.CollectorServer(sid, jconfig.Config(**kw))}
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
        lead = tleader.RpcLeader(tconfig.Config(**kw), *clients)
        await asyncio.gather(*(c.call("reset") for c in clients))
        await lead.upload_keys(*_keys())
        res = await lead.run(N)
        return res, await after((s0, s1), clients)
    finally:
        for c in clients:
            await c.aclose()
        for s in (s0, s1):
            if s._peer_writer is not None:
                s._peer_writer.close()
        for s in (s0, s1):
            await asyncio.wait_for(s.aclose(), 30)


def test_status_and_trace_carry_alert(monkeypatch, tmp_path):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv(ttrace.ENV_DIR, str(trace_dir))
    ttrace._refresh()
    monkeypatch.setenv(talerts.ENV_STALL_S[0], "0.0")

    async def after(servers, clients):
        await asyncio.sleep(0.02)  # any gap beats the budget of 0
        return await clients[0].call("status")

    try:
        _, st = asyncio.run(asyncio.wait_for(_pair_crawl(("port", "port"), after), 120))
        stall = [rec for rec in st["alerts"]["fired"] if rec["rule"] == "tenant_stall"]
        assert [rec["subject"] for rec in stall] == ["server0/default"]
        assert st["alerts"]["count"] == len(st["alerts"]["fired"])
        ttrace.flush()
        evs = ttrace.load_events(str(trace_dir))
        assert [e["args"]["subject"] for e in evs if e.get("name") == "alert:tenant_stall"] == [
            "server0/default"]
    finally:
        monkeypatch.delenv(ttrace.ENV_DIR)
        ttrace._refresh()


def test_migration_stuck_from_placer_gauge(monkeypatch):
    """A fleet move that hangs holds the placer's ``migration_inflight_since``
    gauge; past the budget the rule fires once on the placer's registry, and
    the gauge is 0 again once the move ends."""
    monkeypatch.setenv(talerts.ENV_MIGRATION_STUCK_S[0], "0.05")

    class Ingest:
        def __init__(self):
            self.release = asyncio.Event()

        async def migrate(self, new_lead):
            await self.release.wait()
            return {"moved": 1}

    async def flow():
        directory = tfleet.FleetDirectory()
        for name in ("A", "B"):
            await directory.register(tfleet.HostPair(name=name))
        placer = tfleet.FleetPlacer(directory)
        await placer.place("default")
        ing = Ingest()
        task = asyncio.create_task(placer.migrate(ing, None, session="default", dest="B"))
        await asyncio.sleep(0.01)
        talerts.evaluate_registries([placer.obs])
        early = list(talerts.fired())
        await asyncio.sleep(0.1)
        talerts.evaluate_registries([placer.obs])
        talerts.evaluate_registries([placer.obs])
        ing.release.set()
        await task
        return early, placer.migration_inflight_since

    early, since = asyncio.run(flow())
    assert early == [] and since == 0.0
    (rec,) = talerts.fired()
    assert rec["rule"] == "migration_stuck" and rec["subject"] == "fleet"
    assert rec["inflight_s"] > 0.05 and rec["budget_s"] == 0.05


# -- (c) ops over a mixed pair's scrapes -------------------------------------------


def test_ops_agree_with_jax_over_mixed_pair_scrapes(monkeypatch, capsys):
    """Each package's exporter runs here (a port server 0 publishes its
    session rows through the port's, a JAX server 1 through the JAX one's);
    after a crawl both are scraped over HTTP, and the port's parser, bucket
    rebuild and frame equal the JAX package's on the second scrape's texts."""
    monkeypatch.setenv(texporter.ENV_PORT, "0")
    monkeypatch.setenv(talerts.ENV_STALL_S[0], "0.0")
    ports = {"port": texporter.maybe_start("s0"), "jax": jexporter.maybe_start("s1")}
    assert all(ports.values())

    async def after(servers, clients):
        await asyncio.sleep(0.02)
        # a scrape's producers evaluate the session rules after its alert
        # lines: the stall shows from the second scrape on
        for _ in range(2):
            got = {pkg: await asyncio.to_thread(_get, p) for pkg, p in ports.items()}
        return got

    _, got = asyncio.run(asyncio.wait_for(_pair_crawl(("port", "jax"), after), 120))
    texts = {pkg: body for pkg, (_, _, body) in got.items()}
    parsed = {}
    for pkg, text in texts.items():
        parsed[pkg] = tops.parse_prometheus(text)
        assert parsed[pkg] == jops.parse_prometheus(text)
        reg = "server0" if pkg == "port" else "server1"
        buckets = [(lb, v) for n, lb, v in parsed[pkg]
                   if n == "fhh_level_latency_seconds_bucket" and lb.get("registry") == reg]
        assert buckets
        th, jh = tops.buckets_to_hist(buckets), jops.buckets_to_hist(buckets)
        assert th.counts == jh.counts and th.count == jh.count == L
        rows = [lb["collection"] for n, lb, _ in parsed[pkg]
                if n == "fhh_session_last_progress_seconds"]
        assert rows == ["default"]
    monkeypatch.setattr(tops.time, "strftime", lambda fmt: "12:00:00")
    monkeypatch.setattr(jops.time, "strftime", lambda fmt: "12:00:00")
    samples = {f"127.0.0.1:{ports[pkg]}": parsed[pkg] for pkg in ("port", "jax")}
    frame = tops.render_top(samples)
    assert frame == jops.render_top(samples)
    assert "!! tenant_stall" in frame and "server0/default" in frame
    assert any(ln.startswith("server0") and " default " in ln for ln in frame.splitlines())
    target = f"127.0.0.1:{ports['port']}"
    assert tops.main(["top", "--targets", target, "--once"]) == 0
    assert "fhh-ops top" in capsys.readouterr().out
    monkeypatch.setenv(texporter.ENV_PORT, "0")  # base 0: no default targets
    assert tops.main(["top", "--once"]) == 2
    assert tops.scrape("127.0.0.1:1") == []
