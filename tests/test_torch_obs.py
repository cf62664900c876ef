"""The port's per-run telemetry (``fuzzyheavyhitters_torch/obs/``) against the
JAX package's ``obs/`` on the same inputs, tolerance zero for counts, bytes,
key sets and bucket counts (seconds are not compared):

(a) units: ``Registry`` level inheritance and report shape, a ``Histogram``
    snapshot merged across packages, JSON and human log lines with the clock
    pinned, the heartbeat naming the active span, the ``exit_report``
    SIGTERM contract (a subprocess of each package), the device-memory
    gauges and ``tree_nbytes``, the run report's summaries over the same
    registries, and the fresh-build counter fired through
    ``ops.cuda_build`` with ``nvcc`` stubbed;
(b) over sockets, trusted and secure (ot2s), on a port pair and on the two
    mixed pairs (one JAX server, one port server) under both leaders: every
    counter of a port server's registry, name, total and ``by_level``,
    equals the JAX server's in the same role on the same keys, but the
    port-only counters of :data:`PORT_ONLY` (each with its reason); its
    phase keys cover every level; its ``status`` ``slo`` section has the
    JAX keys.

The JAX modules come through ``tests/torch_ref.reference`` and run inside
``torch_ref.installed()`` (they import siblings at call time).  The traces
are held in ``test_torch_trace.py``."""

import asyncio
import io
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.obs import devmem as tdevmem
from fuzzyheavyhitters_torch.obs import heartbeat as theartbeat
from fuzzyheavyhitters_torch.obs import hist as thist
from fuzzyheavyhitters_torch.obs import logs as tlogs
from fuzzyheavyhitters_torch.obs import metrics as tmetrics
from fuzzyheavyhitters_torch.obs import report as treport
from fuzzyheavyhitters_torch.obs import trace as ttrace
from fuzzyheavyhitters_torch.ops import cuda_build
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jmetrics, jhist, jlogs, jheartbeat, jtrace, jreport, jdevmem, jrpc, jleader,
 jconfig) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.obs.metrics", "fuzzyheavyhitters_tpu.obs.hist",
    "fuzzyheavyhitters_tpu.obs.logs", "fuzzyheavyhitters_tpu.obs.heartbeat",
    "fuzzyheavyhitters_tpu.obs.trace", "fuzzyheavyhitters_tpu.obs.report",
    "fuzzyheavyhitters_tpu.obs.devmem", "fuzzyheavyhitters_tpu.protocol.rpc",
    "fuzzyheavyhitters_tpu.protocol.leader_rpc", "fuzzyheavyhitters_tpu.utils.config")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# counters a port server keeps beside the JAX server's, each with its reason
PORT_ONLY = {
    # crawl verbs begun and finished: server.exit's launch bounds on the card
    # (a verb that failed began but did not finish)
    "levels": "crawl verbs begun, for the launch bounds of server.exit",
    "levels_done": "crawl verbs finished, for the launch bounds of server.exit",
    # the upload's chunks: the JAX server keeps no count of them
    "add_keys": "add_keys chunks, which server.exit reports",
}


@pytest.fixture(autouse=True)
def _jax_installed():
    with torch_ref.installed(), torch_ref.attached(jrpc.obs, trace=jtrace):
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_seconds(rep: dict) -> dict:
    """A registry report with every phase's seconds zeroed."""
    out = json.loads(json.dumps(rep))
    for ph in out.get("phases", {}).values():
        ph["seconds"] = 0.0
        ph["by_level"] = {k: 0.0 for k in ph["by_level"]}
    return out


# -- (a) units ----------------------------------------------------------------


def _script(m, name):
    """The same metric operations on a registry of module ``m``."""
    reg = m.Registry(name)
    reg.count("bytes", 10, level=0)
    reg.count("bytes", np.int64(5), level=np.int32(0))
    reg.count("bytes", 7, level=3)
    reg.count("bytes", 1)  # no level, no span: the total only
    with reg.span("gc_ot", level=7) as sp:
        reg.count("data_bytes_sent", 100)  # inherits level 7
        with reg.span("inner"):  # a level-less inner span: still level 7
            reg.count("data_bytes_sent", 11)
            reg.gauge("survivors", 3)
        assert reg.current_span().name == "gc_ot"
    assert sp.seconds is not None and reg.current_span() is None
    reg.gauge("survivors", 5, level=2)
    reg.gauge("kernel_shards", 4, level=1)
    reg.gauge("kernel_shards", 2, level=2)
    reg.timer_add("fss", 0.25, level=1)
    reg.timer_add("fss", 0.5)
    for v in (1e-5, 0.003, 0.003, 0.7, 12.0, 3e4):
        reg.observe("level_latency", v)
    reg.observe("rpc:tree_crawl", 0.02)
    return reg


def test_registry_inheritance_and_report_match_jax():
    t, j = _script(tmetrics, "t-script"), _script(jmetrics, "j-script")
    assert _no_seconds(t.report()) == _no_seconds(j.report())
    for name, lvl in (("bytes", None), ("bytes", 0), ("data_bytes_sent", 7), ("none", None)):
        assert t.counter_value(name, lvl) == j.counter_value(name, lvl)
    assert (t.gauge_value("kernel_shards"), t.gauge_max("kernel_shards"),
            t.gauge_value("survivors", 7)) == (j.gauge_value("kernel_shards"),
                                              j.gauge_max("kernel_shards"),
                                              j.gauge_value("survivors", 7)) == (2, 4, 3)
    assert t.timer_seconds("fss", 1) == j.timer_seconds("fss", 1) == 0.25
    assert t.hists_summary() == j.hists_summary()
    t.reset()
    j.reset()
    assert t.report() == j.report() == {"counters": {}, "gauges": {}, "phases": {}}


def test_registries_are_listed_and_dropped_ones_retained():
    keep = tmetrics.Registry("t-listed")
    gone = tmetrics.Registry("t-dropped")
    gone.count("checkpoint_writes", 2, level=4)
    seq = gone.seq
    assert keep in tmetrics.all_registries() and gone in tmetrics.all_registries()
    del gone
    import gc

    gc.collect()
    assert any(n == "t-dropped" and s == seq and snap["counters"]["checkpoint_writes"]["total"]
               == 2 for n, s, snap in tmetrics.final_snapshots())
    assert "t-dropped" in {k.split("#")[0] for k in treport.run_report()["registries"]}
    assert tmetrics.default_registry() is tmetrics.default_registry()


def test_histogram_snapshots_merge_across_packages():
    assert thist.BUCKET_BOUNDS == jhist.BUCKET_BOUNDS and thist.N_BUCKETS == jhist.N_BUCKETS
    rng = np.random.default_rng(3)
    a = np.exp(rng.uniform(math.log(1e-5), math.log(5e4), 300))
    b = np.exp(rng.uniform(math.log(1e-4), math.log(10.0), 200))
    th, jh = thist.Histogram(), jhist.Histogram()
    for v in a:
        th.observe(v)
        jh.observe(v)
    assert th.snapshot() == jh.snapshot()
    tb, jb = thist.Histogram(), jhist.Histogram()
    for v in b:
        tb.observe(v)
        jb.observe(v)
    # a port snapshot merged into the JAX package's histogram, and back
    jm = jhist.Histogram.merged([jhist.Histogram.from_snapshot(th.snapshot()), jb])
    tm = thist.Histogram.merged([thist.Histogram.from_snapshot(jh.snapshot()), tb])
    want = jhist.Histogram.merged([jh, jb])
    assert jm.counts == tm.counts == want.counts and jm.count == tm.count == 500
    assert tm.summary()["p95_s"] == jm.summary()["p95_s"]
    assert thist.Histogram().summary() == jhist.Histogram().summary()


_CLOCK = types.SimpleNamespace(time=lambda: 1700000000.123456,
                               strftime=lambda fmt: "12:33:02")


def _trace_of(logs_module):
    """The trace module a logs module reaches at emit time (``from . import
    trace``): for the JAX package, the one its package holds in
    ``sys.modules`` now, which another test file's load may have replaced."""
    return sys.modules[logs_module.__package__].trace


def _log_lines(m, fmt, monkeypatch, tracing):
    sink = io.StringIO()
    old = dict(m._cfg)
    monkeypatch.setattr(m, "time", _CLOCK)
    m.configure(fmt=fmt, stream=sink, min_severity="info")
    try:
        m.emit("crawl.done", seconds=3.21, hitters=np.int64(4), secure=False, alive=None)
        m.emit("level.phases", severity="debug", level=5)  # below the threshold
        m.emit("verb.error", severity="warn", server=0, error="RuntimeError: x")
        m.emit("resilience.mesh_reshard", level=np.int32(8), shards=np.float32(0.5))
        trace = _trace_of(m)
        if tracing:
            with trace.root("crawl"):
                m.emit("hitter", value="[3, 4]", count=2)
    finally:
        m._cfg.update(old)
    return sink.getvalue().splitlines()


@pytest.mark.parametrize("fmt", ["json", "human"])
def test_log_lines_match_jax(fmt, monkeypatch, tmp_path):
    monkeypatch.setenv("FHH_TRACE_DIR", str(tmp_path))
    traces = [_trace_of(tlogs), _trace_of(jlogs)]
    for t in traces:
        t._refresh()
    try:
        got = _log_lines(tlogs, fmt, monkeypatch, True)
        want = _log_lines(jlogs, fmt, monkeypatch, True)
    finally:
        monkeypatch.delenv("FHH_TRACE_DIR")
        for t in traces:
            t._refresh()
    assert len(got) == len(want) == 4
    if fmt == "human":
        assert got == want
        return
    got, want = [json.loads(x) for x in got], [json.loads(x) for x in want]
    # the last line carries each package's own trace id under its root
    assert got[-1].pop("trace").startswith("crawl-") and want[-1].pop("trace").startswith(
        "crawl-")
    assert got == want
    assert got[0] == {"ts": 1700000000.123, "sev": "info", "event": "crawl.done",
                      "seconds": 3.21, "hitters": 4, "secure": False, "alive": None}


def test_log_defaults_and_sections_match_jax():
    """The env-derived defaults are the JAX package's (human lines on
    standard error at info), read in a fresh process of each package; and
    a whole section on one line keeps its structure (the port's
    ``server.exit`` puts its ``sessions`` and ``launches`` on one line)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("FHH_LOG_")}
    code = ("import importlib, json, sys; m = importlib.import_module(sys.argv[1]);"
            "print(json.dumps({k: m._cfg[k] for k in ('fmt', 'stream', 'min_severity')}))")
    got, want = (json.loads(subprocess.run(
        [sys.executable, "-c", code, f"{pkg}.obs.logs"],
        env=dict(env, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        check=True, timeout=120).stdout) for pkg in ("fuzzyheavyhitters_torch",
                                                     "fuzzyheavyhitters_tpu"))
    assert got == want == {"fmt": "human", "stream": "stderr", "min_severity": 20}
    sink = io.StringIO()
    old = dict(tlogs._cfg)
    tlogs.configure(fmt="json", stream=sink)
    try:
        tlogs.emit("server.exit", launches={"expand": np.int64(3)}, shards=[np.int32(1), 2],
                   arr=np.arange(3))
    finally:
        tlogs._cfg.update(old)
    rec = json.loads(sink.getvalue())
    assert rec["launches"] == {"expand": 3} and rec["shards"] == [1, 2] and rec["arr"] == [0, 1, 2]


def _beat(hb, m, metrics, name, monkeypatch):
    sink = io.StringIO()
    old = dict(m._cfg)
    m.configure(fmt="json", stream=sink, min_severity="info")
    reg = metrics.Registry(name)
    try:
        with reg.span("gc_ot", level=311):
            hb.Heartbeat(3600).beat()
    finally:
        m._cfg.update(old)
    lines = [json.loads(x) for x in sink.getvalue().splitlines()]
    return [{k: v for k, v in x.items() if k not in ("ts", "elapsed_s")}
            for x in lines if x.get("registry") == name]


def test_heartbeat_names_the_active_span(monkeypatch):
    got = _beat(theartbeat, tlogs, tmetrics, "hb-test", monkeypatch)
    want = _beat(jheartbeat, jlogs, jmetrics, "hb-test", monkeypatch)
    assert got == want == [{"sev": "info", "event": "heartbeat", "registry": "hb-test",
                            "span": "gc_ot", "level": 311}]
    monkeypatch.setenv("FHH_HEARTBEAT_S", "0")
    assert theartbeat.start_heartbeat() is None
    monkeypatch.setenv("FHH_HEARTBEAT_S", "30")
    hb = theartbeat.start_heartbeat()
    try:
        assert hb.is_alive() and hb.daemon and theartbeat.start_heartbeat() is hb
    finally:
        theartbeat.stop_heartbeat()
    hb.join(5)
    assert not hb.is_alive()


_EXIT_SCRIPT = """
import importlib, os, signal, sys, time
obs = importlib.import_module(sys.argv[1] + ".obs")
reg = obs.Registry("server0")
reg.count("checkpoint_writes", 3, level=1)
with obs.exit_report():
    with reg.span("fss", level=2):
        time.sleep(0.6)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(30)
"""


def _exit_run(pkg, tmp_path):
    report = tmp_path / f"{pkg}.json"
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu", FHH_RUN_REPORT=str(report),
               FHH_HEARTBEAT_S="0.1", FHH_LOG_FORMAT="json", FHH_LOG_STREAM="stdout")
    out = subprocess.run([sys.executable, "-c", _EXIT_SCRIPT, pkg], env=env,
                         capture_output=True, text=True, timeout=120)
    beats = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    return out.returncode, json.loads(report.read_text()), beats


def test_exit_report_sigterm_contract_matches_jax(tmp_path):
    """SIGTERM becomes ``SystemExit(143)``, the heartbeat runs meanwhile, and
    the run report is written on the way out, span and counters in it."""
    (trc, trep, tbeats), (jrc, jrep, jbeats) = (_exit_run(p, tmp_path) for p in (
        "fuzzyheavyhitters_torch", "fuzzyheavyhitters_tpu"))
    assert trc == jrc == 143
    assert trep["schema"] == jrep["schema"] == "fhh-run-report/1"
    t0, j0 = trep["registries"]["server0"], jrep["registries"]["server0"]
    assert _no_seconds(t0) == _no_seconds(j0)
    assert t0["phases"]["fss"]["count"] == 1  # the span closed on the way out
    for beats in (tbeats, jbeats):
        assert any(b["event"] == "heartbeat" and b.get("span") == "fss" and b["level"] == 2
                   for b in beats)


def test_devmem_on_the_cpu_and_tree_nbytes_match_jax():
    reg = tmetrics.Registry("t-devmem")
    assert tdevmem.device_bytes() == (0, None)  # no card: nothing allocated
    assert tdevmem.sample(reg, phase="status") == 0
    assert reg.gauge_value("hbm_in_use_bytes") == 0 and reg.gauge_value("hbm_delta_bytes") == 0
    assert reg.gauge_value("hbm_limit_bytes") is None
    shapes = [((5, 3), torch.int32, np.int32), ((7,), torch.bool, np.bool_),
              ((2, 2, 8), torch.int64, np.int64)]
    tree = (torch.zeros(5, 3, dtype=torch.int32),
            {"a": torch.zeros(7, dtype=torch.bool), "b": [torch.zeros(2, 2, 8,
                                                                      dtype=torch.int64)]})
    jtree = [np.zeros(s, d) for s, _, d in shapes]
    assert tdevmem.tree_nbytes(tree) == jdevmem.tree_nbytes(jtree) == 15 * 4 + 7 + 32 * 8
    assert tdevmem.tree_nbytes(None) == jdevmem.tree_nbytes(None) == 0
    keys = tibdcf.gen_l_inf_ball(np.zeros((3, 1, 4), bool), 1, np.random.default_rng(1),
                                 device="cpu")[0]
    assert tdevmem.tree_nbytes(keys) == sum(t.numel() * t.element_size() for t in keys)


_NVCC = """#!/bin/sh
# a stand-in compiler: writes an empty library at the -o path
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
"""


def test_fresh_build_counter_through_cuda_build(tmp_path, monkeypatch):
    """A fresh ``nvcc`` build counts as the JAX listener counts an XLA
    compile, under the innermost active span; a cached library counts
    nothing; a build after the warmup counts ``fresh_compiles_post_warmup``."""
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text(_NVCC)
    os.chmod(tmp_path / "bin" / "nvcc", 0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("FHH_TORCH_BUILD_DIR", str(tmp_path / "build"))
    reg = tmetrics.default_registry()
    names = ("fresh_compiles", "fresh_compiles:warmup", "fresh_compiles_post_warmup")
    before = [reg.counter_value(n) for n in names]
    delta = lambda: [reg.counter_value(n) - b for n, b in zip(names, before)]  # noqa: E731
    work = tmetrics.Registry("!compile-test")  # sorts first among live registries
    tdevmem._reset_for_tests()
    try:
        with work.span("warmup"):
            libs = cuda_build.build()
        assert all(p.exists() for p in libs.values())
        assert delta() == [len(cuda_build.SOURCES), len(cuda_build.SOURCES), 0]
        cuda_build.build()  # every library cached: no build, no count
        assert delta() == [len(cuda_build.SOURCES), len(cuda_build.SOURCES), 0]
        tdevmem.note_warmup_done()
        libs["expand"].unlink()
        cuda_build.build(["expand"])
        assert delta() == [len(cuda_build.SOURCES) + 1, len(cuda_build.SOURCES), 1]
    finally:
        tdevmem._reset_for_tests()
    # the JAX listener names the same counters under the same span
    jreg = jmetrics.default_registry()
    jbefore = {n: jreg.counter_value(n) for n in names[:2]}
    jwork = jmetrics.Registry("!compile-test")
    with jwork.span("warmup"):
        jdevmem._on_event(jdevmem._COMPILE_EVENT, 0.5)
    assert {n: jreg.counter_value(n) - jbefore[n] for n in names[:2]} == {
        names[0]: 1, names[1]: 1}


def _report_regs(m):
    """Registries of module ``m`` carrying every summary's metrics."""
    s0, s1, lead = m.Registry("server0"), m.Registry("server1"), m.Registry("leader")
    ing, fleet, tenant = m.Registry("ingest"), m.Registry("fleet"), m.Registry("server0:t1")
    for r in (s0, s1):
        for lvl in range(3):
            r.timer_add("fss", 0.5, level=lvl)
            r.timer_add("otext", 0.25, level=lvl)
            r.timer_add("b2a", 0.125, level=lvl)
            r.timer_add("garble", 0.0, level=lvl)
            r.timer_add("eval", 0.0, level=lvl)
            r.count("ot_path_ot2s", level=lvl)
            r.count("data_bytes_sent", 100 + lvl, level=lvl)
            r.gauge("data_shards", 4, level=lvl)
            r.gauge("kernel_shards", 2 + lvl, level=lvl)
            r.timer_add("ici_reduce", 0.0625, level=lvl)
            r.observe("level_latency", 0.01 * (lvl + 1))
        r.observe("rpc:tree_crawl", 0.02)
        r.count("dedup_hits", 2)
        r.count("verb_requests", 40)
        r.count("kernel_gathers", 1, level=2)
        r.timer_add("kernel_gather", 0.5, level=2)
        r.count("mesh_reshards", level=1)
        r.count("mesh_faults", level=1)
        r.timer_add("sketch", 1.0, level=0)
        r.gauge("sketch_shards", 2, level=0)
        r.count("tenant_device_turns", 6)
        r.count("tenant_stall_fills", 2)
        r.count("session_exports", 1)
    lead.count("recoveries")
    lead.count("levels_rerun", 2)
    lead.gauge("pipeline_depth", 2, level=1)
    lead.timer_add("pipeline_overlap", 0.75, level=1)
    lead.count("pipeline_stalls", 3, level=1)
    lead.count("pipeline_faults", level=1)
    ing.count("ingest_admitted", 1000, level=0)
    ing.count("ingest_shed", 10, level=0)
    ing.count("ingest_rejected", 3, level=0)
    ing.count("ingest_windows")
    ing.timer_add("ingest", 2.0, level=0)
    ing.timer_add("window_crawl", 4.0, level=0)
    ing.observe("seal_to_hitters", 5.0)
    fleet.count("placement_decisions", 2)
    fleet.count("session_migrations")
    tenant.timer_add("gc_ot", 0.5, level=4)
    tenant.count("pool_admitted_keys", 16)
    tenant.count("data_bytes_recv", 64)
    return [s0, s1, lead, ing, fleet, tenant]


def test_run_report_summaries_match_jax(tmp_path, monkeypatch):
    ttrace._refresh()
    jtrace._refresh()
    # each package's report holds the alerts its process fired (none here)
    treport._alerts._reset_for_tests()
    jreport._alerts._reset_for_tests()
    t = treport.run_report(_report_regs(tmetrics))
    j = jreport.run_report(_report_regs(jmetrics))
    for doc in (t, j):
        doc.pop("written_at")
    assert t == j
    assert set(t) == {"schema", "registries", "recovery", "pipeline", "secure_kernels", "sketch",
                      "ingest", "fleet", "mesh", "sessions", "slo"}
    path = tmp_path / "r.json"
    monkeypatch.setenv("FHH_RUN_REPORT", str(path))
    assert treport.maybe_write_run_report(_report_regs(tmetrics)) == str(path)
    assert json.loads(path.read_text())["schema"] == "fhh-run-report/1"
    assert treport.per_process_report_path("/x/r.json", "s0") == jreport.per_process_report_path(
        "/x/r.json", "s0") == "/x/r.s0.json"
    treport.claim_report_path("s1")
    assert os.environ["FHH_RUN_REPORT"] == str(tmp_path / "r.s1.json")


# -- (b) over sockets ---------------------------------------------------------

L, N = 5, 12


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


async def _pair_run(kinds, leader, mode):
    """Servers of ``kinds`` and a leader of either package over localhost;
    -> (the servers' registry reports after the crawl, their ``status``
    answers then, the hitters, the servers).  The reports are taken before
    the probe: a ``status`` answer is the package's own (the port's
    ``sessions`` rows carry their counters, the JAX server's ``alerts``), so
    its bytes differ."""
    tcfg, jcfg = tconfig.Config(**_cfg_kw(mode)), jconfig.Config(**_cfg_kw(mode))
    make = {"port": lambda sid: trpc.CollectorServer(sid, tcfg, "cpu"),
            "jax": lambda sid: jrpc.CollectorServer(sid, jcfg)}
    s0, s1 = make[kinds[0]](0), make[kinds[1]](1)
    p0, p1 = chip_smoke.free_ports()
    t1 = asyncio.create_task(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    t0 = asyncio.create_task(s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1))
    await asyncio.wait_for(asyncio.gather(t0, t1), 60)
    rpc, lrpc, cfg = (trpc, tleader, tcfg) if leader == "port" else (jrpc, jleader, jcfg)
    clients = []
    try:
        for p in (p0, p1):
            clients.append(await rpc.CollectorClient.connect("127.0.0.1", p))
        lead = lrpc.RpcLeader(cfg, *clients)
        await asyncio.gather(*(c.call("reset") for c in clients))
        await lead.upload_keys(*_keys())
        res = await asyncio.wait_for(lead.run(N), 300)
        reports = [s.obs.report() for s in (s0, s1)]
        st = await asyncio.gather(*(c.call("status") for c in clients))
        hitters = {tuple(int(v) for v in row): int(c)
                   for row, c in zip(res.decode_ints(), res.counts)}
        return reports, st, hitters, (s0, s1)
    finally:
        for c in clients:
            await c.aclose()
        for s in (s0, s1):
            if s._peer_writer is not None:
                s._peer_writer.close()
        for s in (s0, s1):
            await asyncio.wait_for(s.aclose(), 30)


_REF: dict = {}


def _reference(leader, mode):
    """The JAX pair's registries under ``leader`` (memoized)."""
    if (leader, mode) not in _REF:
        reports, st, hitters, _ = asyncio.run(_pair_run(("jax", "jax"), leader, mode))
        _REF[leader, mode] = (reports, st, hitters)
    return _REF[leader, mode]


@pytest.mark.parametrize("mode", ["trusted", "ot2s"])
@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port"), ("port", "jax")],
                         ids=["port-pair", "jax0-port1", "port0-jax1"])
def test_server_registry_matches_jax_over_sockets(kinds, leader, mode):
    ref, ref_st, ref_hitters = _reference(leader, mode)
    reports, st, hitters, _ = asyncio.run(_pair_run(kinds, leader, mode))
    assert hitters == ref_hitters and hitters
    for sid, kind in enumerate(kinds):
        if kind != "port":
            continue
        got, want = reports[sid], ref[sid]
        counters = {k: v for k, v in got["counters"].items() if k not in PORT_ONLY}
        assert counters == want["counters"], sid
        assert set(PORT_ONLY) <= set(got["counters"])
        # the phase keys, and every crawl phase covers every level
        assert set(got["phases"]) == set(want["phases"])
        crawl = ("fss", "gc_ot", "field") + (("otext", "b2a", "garble", "eval")
                                             if mode == "ot2s" else ())
        for ph in crawl:
            assert set(got["phases"][ph]["by_level"]) == {str(lv) for lv in range(L)}, ph
        assert set(got["gauges"]) - {"data_frame_max"} == set(want["gauges"])
        assert set(got["hists"]) == set(want["hists"])
        # the status slo section: the JAX keys, and the same sample counts
        slo, ref_slo = st[sid]["slo"], ref_st[sid]["slo"]
        assert set(slo) == set(ref_slo) and {k: v["count"] for k, v in slo.items()} == {
            k: v["count"] for k, v in ref_slo.items()}
        assert all(set(v) == set(ref_slo[k]) for k, v in slo.items())
        assert set(st[sid]) - {"alerts"} == set(ref_st[sid]) - {"alerts"}


def test_server_summary_reads_the_registries():
    """``server.exit``'s flat figures (``CollectorServer.summary``) come from
    the registry: the JAX counter under its old key, each phase's seconds,
    and a collection's row summing to the server's."""
    _, _, _, servers = asyncio.run(_pair_run(("port", "port"), "port", "ot2s"))
    for s in servers:
        rep, summ = s.obs.report(), s.summary()
        assert summ["levels"] == summ["levels_done"] == L
        assert summ["data_bytes_sent"] == rep["counters"]["data_bytes_sent"]["total"]
        assert summ["control_bytes_recv"] == rep["counters"]["control_bytes_recv"]["total"]
        assert summ["plane_handshake_calls"] == 1 and summ["add_keys"] == 3
        assert summ["seconds"]["otext"] == rep["phases"]["otext"]["seconds"]
        assert summ["data_frame_max"] == rep["gauges"]["data_frame_max"]["last"] > 0
        row = s.sessions_status()["per_session"]["default"]["counters"]
        assert {k: row[k] for k in ("levels", "data_bytes_recv", "device_fetches")} == {
            k: summ[k] for k in ("levels", "data_bytes_recv", "device_fetches")}
    assert servers[0].summary()["data_bytes_sent"] == servers[1].summary()["data_bytes_recv"]
