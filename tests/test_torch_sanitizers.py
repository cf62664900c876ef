"""The port's two runtime sanitizers (``utils/guards.py``, the lock
discipline, and ``utils/taint_guard.py``, the shadow taint) against the JAX
package's, tolerance zero:

(a) the lock-discipline units (after the JAX ``test_concurrency.py``), each
    on both packages' modules: a guarded attribute asserts its lock and its
    windows, ownership across tasks, off by default at no cost, armed by the
    environment, ``unguarded`` needs a reason; a port server's verb called
    without its collection's lock raises; two concurrent seals of a guarded
    ``WindowedIngest`` seal distinct windows;
(b) the guard-map drift test: every row of the JAX runtime twins
    (``_SESSION_GUARDS``, ``_SERVER_GUARDS``, ``_INGEST_GUARDS``,
    ``_FLEET_GUARDS``) maps to a port row through the port's rename table or
    to an absence the table names, and every port row names an attribute
    and a lock its object has;
(c) the taint units (after the JAX ``test_taint.py``), each on both
    packages' modules: off is inert; bytes, containment, hex and ``str``
    forms; the declassified window; reset; short scalars; a tensor, which the
    JAX ``tobytes`` path skips, registered and scanned by the port; the
    ``_DEFAULT_SOURCES`` keys equal the JAX table's;
(d) a registered secret injected into each of the port's sinks (exporter
    render, log emit, trace record, run report, alert fire) raises, as a
    numpy array and as a tensor;
(e) end to end with ``FHH_DEBUG_GUARDS=1`` and ``FHH_DEBUG_TAINT=1``: a port
    pair under the port leader and a mixed pair (a JAX server 0, a port
    server 1) under the JAX leader, trusted and secure (ot2s), a windowed
    ingest and a fleet move between two port pairs: no violation, and the
    hitters bit-identical to the same run unsanitized.

The JAX modules come through ``tests/torch_ref.reference`` in one load, so
its servers use the sanitizers loaded here."""

import asyncio
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_fleet_flows as flows
import torch_ref
from fuzzyheavyhitters_torch.obs import alerts as talerts
from fuzzyheavyhitters_torch.obs import exporter as texporter
from fuzzyheavyhitters_torch.obs import logs as tlogs
from fuzzyheavyhitters_torch.obs import metrics as tmetrics
from fuzzyheavyhitters_torch.obs import report as treport
from fuzzyheavyhitters_torch.obs import trace as ttrace
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import fleet as tfleet
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sessions as tsessions
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig
from fuzzyheavyhitters_torch.utils import guards as tguards
from fuzzyheavyhitters_torch.utils import taint_guard as ttaint

(jguards, jtaint, jrpc, jleader, jsessions, jfleet, jconfig) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.utils.guards", "fuzzyheavyhitters_tpu.utils.taint_guard",
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.protocol.sessions", "fuzzyheavyhitters_tpu.protocol.fleet",
    "fuzzyheavyhitters_tpu.utils.config")

GUARDS = {"port": tguards, "jax": jguards}
TAINT = {"port": ttaint, "jax": jtaint}
L, N = 5, 12
MODES = {"trusted": {}, "ot2s": dict(secure_exchange=True, ot_path="ot2s")}
RUN_S = 240


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _taint_clean():
    """Every test starts and ends with both packages' taint registries empty."""
    for m in TAINT.values():
        m.reset()
    yield
    for m in TAINT.values():
        m.reset()


def _cfg_kw(**extra):
    return dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=5, num_sites=4,
                threshold=0.3, zipf_exponent=1.03, server0="127.0.0.1:1",
                server1="127.0.0.1:2", distribution="zipf", f_max=64, **extra)


# -- (a) the lock discipline --------------------------------------------------


class _Obj:
    def __init__(self):
        self._lk = asyncio.Lock()
        self.state = 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_guarded_state_asserts_and_windows(pkg):
    g = GUARDS[pkg]
    obj = _Obj()
    assert g.install(obj, {"state": "_lk"}, force=True)
    assert type(obj).__name__ == "Guarded_Obj" and isinstance(obj, _Obj)

    async def flow():
        with pytest.raises(g.GuardViolation):
            _ = obj.state
        with pytest.raises(g.GuardViolation):
            obj.state = 1
        async with obj._lk:
            obj.state = 2
            assert obj.state == 2
        with g.unguarded("test window"):
            assert obj.state == 2

    asyncio.run(flow())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_guarded_state_cross_task_ownership(pkg):
    """``locked()`` alone is not ownership: an access while another task
    holds the lock is the race the lock exists to prevent."""
    g = GUARDS[pkg]
    obj = _Obj()
    assert g.install(obj, {"state": "_lk"}, force=True)

    async def flow():
        entered = asyncio.Event()

        async def holder():
            async with obj._lk:
                entered.set()
                await asyncio.sleep(0.05)

        h = asyncio.create_task(holder())
        await entered.wait()
        with pytest.raises(g.GuardViolation):
            _ = obj.state
        await h

    asyncio.run(flow())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sanitizer_off_by_default_no_overhead(monkeypatch, pkg):
    g = GUARDS[pkg]
    monkeypatch.delenv("FHH_DEBUG_GUARDS", raising=False)
    obj = _Obj()
    assert not g.install(obj, {"state": "_lk"})
    assert type(obj) is _Obj and not hasattr(obj._lk, "_fhh_tracked")
    obj.state = 3
    assert obj.state == 3


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_env_var_arms_install(monkeypatch, pkg):
    g = GUARDS[pkg]
    monkeypatch.setenv("FHH_DEBUG_GUARDS", "1")
    obj = _Obj()
    assert g.enabled() and g.install(obj, {"state": "_lk"})
    assert type(obj) is not _Obj


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_unguarded_requires_reason(pkg):
    g = GUARDS[pkg]
    for reason in ("", "   "):
        with pytest.raises(ValueError):
            with g.unguarded(reason):
                pass


def test_sanitizer_raises_on_unlocked_server_access():
    """A verb called directly, past the dispatch's lock, on a port server
    armed by ``debug_guards`` raises; the same verb under its collection's
    lock runs."""
    s = trpc.CollectorServer(0, tconfig.Config(**_cfg_kw(), debug_guards=True), "cpu")
    cs = s._table.default()
    assert type(s).__name__ == "GuardedCollectorServer"
    assert type(cs).__name__ == "GuardedCollectionSession"

    async def flow():
        with pytest.raises(tguards.GuardViolation):
            await s.reset({}, cs)
        async with cs._verb_lock:
            assert await s.reset({}, cs)
        with pytest.raises(tguards.GuardViolation):
            _ = s._sessions  # the replay table belongs to the server's lock
        async with s._verb_lock:
            assert s._sessions == {}

    asyncio.run(flow())


class _StubClient:
    session_id = "sess"
    boot_id = "boot"


class _StubLead:
    """The surface of ``RpcLeader`` a seal reads; its seal verbs answer after
    a real suspension (the interleaving a window id read outside the lock
    would lose)."""

    def __init__(self, debug_guards=True):
        self.cfg = tconfig.Config(**_cfg_kw(), debug_guards=debug_guards)
        self.c0, self.c1 = _StubClient(), _StubClient()
        self._boot_ids = {}
        self.sealed = []
        self.emit = lambda event, **kw: None

    async def _both(self, verb, req=None):
        assert verb == "window_seal"
        self.sealed.append(dict(req))
        await asyncio.sleep(0.01)
        r = {"keys": 0, "subs": 0, "shed_keys": 0, "rejected": 0}
        return r, dict(r)


def test_concurrent_seals_advance_distinct_windows():
    lead = _StubLead()
    wi = tleader.WindowedIngest(lead, checkpoint=False)
    assert type(wi).__name__ == "GuardedWindowedIngest"

    async def flow():
        await asyncio.gather(wi.seal_window(), wi.seal_window())
        async with wi._submit_lock:
            return wi.window, set(wi._sealed)

    assert asyncio.run(flow()) == (2, {0, 1})
    assert sorted(r["window"] for r in lead.sealed) == [0, 1]


# -- (b) the guard maps against the JAX runtime twins --------------------------


def _port_objects():
    cfg = tconfig.Config(**_cfg_kw())
    server = trpc.CollectorServer(0, cfg, "cpu")
    return {"session": server._table.default(), "server": server,
            "ingest": tleader.WindowedIngest(_StubLead(debug_guards=False), checkpoint=False),
            "fleet": tfleet.FleetDirectory()}


MAPS = {  # name: (JAX twin, port map, the port's rename table)
    "session": (jsessions._SESSION_GUARDS, tsessions._SESSION_GUARDS,
                tsessions._SESSION_RENAMES),
    "server": (jrpc._SERVER_GUARDS, trpc._SERVER_GUARDS, {}),
    "ingest": (jleader._INGEST_GUARDS, tleader._INGEST_GUARDS, {}),
    "fleet": (jfleet._FLEET_GUARDS, tfleet._FLEET_GUARDS, {}),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_guard_maps_match_jax_twins(monkeypatch, name):
    monkeypatch.delenv("FHH_DEBUG_GUARDS", raising=False)
    jmap, tmap, renames = MAPS[name]
    assert set(renames) <= set(jmap), "the rename table names rows the JAX map lacks"
    want = {renames.get(k, k): lock for k, lock in jmap.items() if renames.get(k, k) is not None}
    assert tmap == want
    absent = sorted(k for k in jmap if k in renames and renames[k] is None)
    assert absent == (["_radix"] if name == "session" else [])
    obj = _port_objects()[name]  # unguarded: plain attributes
    for attr, lock in tmap.items():
        assert attr in vars(obj), f"{type(obj).__name__} has no attribute {attr}"
        assert isinstance(vars(obj)[lock], asyncio.Lock)


# -- (c) the taint units --------------------------------------------------------


def _secret(seed=0):
    return np.random.default_rng(seed).integers(0, 256, 32, dtype=np.uint8)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_taint_off_is_inert(monkeypatch, pkg):
    t = TAINT[pkg]
    monkeypatch.delenv("FHH_DEBUG_TAINT", raising=False)
    s = _secret()
    t.register("CollectionSession._sec_seed", s)
    assert not t._armed
    t.check(s.tobytes(), sink="anywhere")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_taint_catches_bytes_containment_hex_and_repr(monkeypatch, pkg):
    t = TAINT[pkg]
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    s = _secret()
    t.register("CollectionSession._sec_seed", s)
    raw = s.tobytes()
    for payload in (raw, b"frame:" + raw + b":tail", f"v={raw.hex()}", f"arr={s}",
                    {"lines": ["ok", {"deep": raw}]}):
        with pytest.raises(t.TaintViolation, match="CollectionSession._sec_seed"):
            t.check(payload, sink="metrics-render")
    t.check("all clear", sink="metrics-render")
    t.check({"n": 7, "rows": [bytes(8)]}, sink="x")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_taint_declassified_window_and_reason(monkeypatch, pkg):
    t = TAINT[pkg]
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    s = _secret()
    t.register("OtExtSender._seeds", s)
    with t.declassified("a sanctioned flow"):
        t.check(s.tobytes(), sink="wire")
    with pytest.raises(t.TaintViolation):
        t.check(s.tobytes(), sink="wire")
    with pytest.raises(ValueError):
        t.declassified("   ")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_taint_reset_disarms(monkeypatch, pkg):
    t = TAINT[pkg]
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    s = _secret()
    t.register("OtExtReceiver._seeds0", s)
    t.reset()
    assert not t._armed
    t.check(s.tobytes(), sink="wire")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_taint_short_scalars_not_text_marked(monkeypatch, pkg):
    t = TAINT[pkg]
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    t.register("CollectionSession._sketch_seed", np.frombuffer(b"\x07", np.uint8))
    t.check("value=7 elsewhere", sink="log-emit")
    with pytest.raises(t.TaintViolation):
        t.check(b"\x07", sink="log-emit")


def test_taint_tensor_registered_by_port_skipped_by_jax(monkeypatch):
    """A port secret held as an int32 tensor: the JAX ``tobytes`` path skips
    it (nothing registered), the port registers its bytes, which are the
    uint32 words' bytes, and scans a tensor met inside a payload."""
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    words = np.random.default_rng(3).integers(0, 2**32, (128, 4), dtype=np.uint32)
    tensor = torch.from_numpy(words.view(np.int32).copy())
    jtaint.register("OtExtSender._seeds", tensor)
    assert not jtaint._armed and not jtaint._byte_markers
    ttaint.register("OtExtSender._seeds", tensor)
    assert ttaint._armed and words.tobytes() in ttaint._byte_markers
    wider = torch.cat([torch.zeros((4, 4), dtype=torch.int32), tensor])
    for payload in (words.tobytes(), words.tobytes().hex(), {"args": {"blob": tensor}},
                    [wider]):
        with pytest.raises(ttaint.TaintViolation, match="OtExtSender._seeds"):
            ttaint.check(payload, sink="trace-event")
    ttaint.check({"args": {"blob": tensor[:64]}}, sink="trace-event")


def test_default_sources_match_jax():
    assert set(ttaint._DEFAULT_SOURCES) == set(jtaint._DEFAULT_SOURCES)


# -- (d) a secret injected into each sink ---------------------------------------


def _registered(form):
    """A registered secret -> (what a sink is handed, its hex)."""
    words = np.random.default_rng(11).integers(0, 2**32, 8, dtype=np.uint32)
    held = torch.from_numpy(words.view(np.int32).copy()) if form == "tensor" else words
    ttaint.register("CollectionSession._sec_seed", held)
    return held, words.tobytes().hex()


@pytest.fixture
def _trace_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(ttrace.ENV_DIR, str(tmp_path / "trace"))
    ttrace._refresh()
    yield
    monkeypatch.delenv(ttrace.ENV_DIR)
    ttrace._refresh()


def _inject_metrics(held, hexed):
    texporter.add_producer(lambda: [f'fhh_debug_dump{{blob="{hexed}"}} 1'])
    try:
        texporter.render()
    finally:
        with texporter._lock:
            texporter._producers.clear()


def _inject_log(held, hexed):
    tlogs.emit("debug.dump", blob=hexed)


def _inject_trace(held, hexed):
    ttrace.instant("debug.dump", "test", blob=hexed)


def _inject_report(held, hexed):
    reg = tmetrics.Registry(f"dump-{hexed}")
    treport.run_report(registries=[reg])


def _inject_alert(held, hexed):
    talerts.evaluate_sessions({hexed: {"last_progress_s": 1e9, "queue_depth": 0}}, "server0")


SINKS = {"metrics-render": _inject_metrics, "log-emit": _inject_log,
         "trace-event": _inject_trace, "run-report": _inject_report,
         "alert-fire": _inject_alert}


@pytest.mark.parametrize("form", ["numpy", "tensor"])
@pytest.mark.parametrize("sink", sorted(SINKS))
def test_secret_injected_into_each_sink_raises(monkeypatch, _trace_dir, sink, form):
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    talerts._reset_for_tests()
    held, hexed = _registered(form)
    try:
        with pytest.raises(ttaint.TaintViolation, match=sink):
            SINKS[sink](held, hexed)
        with ttaint.declassified("the same payload, sanctioned"):
            SINKS[sink](held, hexed)
    finally:
        talerts._reset_for_tests()


# -- (e) end to end under both sanitizers ----------------------------------------


def _keys(seed=7):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.full((N - 4, 1), 11), rng.integers(0, 1 << L, size=(4, 1))])
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


def _hitters(res):
    return {tuple(int(v) for v in row): int(c) for row, c in zip(res.decode_ints(), res.counts)}


async def _close(clients, servers):
    for c in clients:
        await c.aclose()
    for s in servers:
        if s._peer_writer is not None:
            s._peer_writer.close()
    for s in servers:
        await asyncio.wait_for(s.aclose(), 30)


async def _crawl(kinds, leader, mode, seen):
    kw = _cfg_kw(**MODES[mode])
    make = {"port": lambda sid: trpc.CollectorServer(sid, tconfig.Config(**kw), "cpu"),
            "jax": lambda sid: jrpc.CollectorServer(sid, jconfig.Config(**kw))}
    s0, s1 = make[kinds[0]](0), make[kinds[1]](1)
    seen["servers"] = (s0, s1)
    p0, p1 = chip_smoke.free_ports()
    t1 = asyncio.create_task(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    t0 = asyncio.create_task(s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1))
    await asyncio.wait_for(asyncio.gather(t0, t1), 60)
    rpc, lrpc, cfgmod = (trpc, tleader, tconfig) if leader == "port" else (jrpc, jleader, jconfig)
    clients = []
    try:
        for p in (p0, p1):
            clients.append(await rpc.CollectorClient.connect("127.0.0.1", p))
        lead = lrpc.RpcLeader(cfgmod.Config(**kw), *clients)
        await asyncio.gather(*(c.call("reset") for c in clients))
        await lead.upload_keys(*_keys())
        res = await lead.run(N)
        seen["status"] = await clients[1].call("status")
        return _hitters(res)
    finally:
        await _close(clients, (s0, s1))


async def _windowed(seen):
    """Two windows of six one-key submissions on a port pair, the port
    ``WindowedIngest`` sealing and crawling each."""
    kw = _cfg_kw()
    s0, s1 = (trpc.CollectorServer(sid, tconfig.Config(**kw), "cpu") for sid in (0, 1))
    seen["servers"] = (s0, s1)
    p0, p1 = chip_smoke.free_ports()
    t1 = asyncio.create_task(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    await s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1)
    await asyncio.wait_for(t1, 60)
    k0, k1 = _keys()
    clients = []
    try:
        for p in (p0, p1):
            clients.append(await trpc.CollectorClient.connect("127.0.0.1", p))
        lead = tleader.RpcLeader(tconfig.Config(**kw), *clients)
        await lead._both("reset")
        wi = tleader.WindowedIngest(lead, checkpoint=False)
        seen["ingest"] = wi
        out = {}
        for w in (0, 1):
            for i in range(6 * w, 6 * w + 6):
                await wi.submit(f"c{i}", tuple(a[i:i + 1] for a in k0),
                                tuple(a[i:i + 1] for a in k1))
            await wi.seal_window()
            out[w] = _hitters(await wi.crawl_window(w))
        return out
    finally:
        await _close(clients, (s0, s1))


async def _fleet_move(tmp, seen):
    """Window 0 sealed on port pair A, half of window 1 submitted there, the
    collection migrated to port pair B by a ``FleetPlacer``, the rest
    submitted to B and both windows crawled there."""
    kw = flows.cfg_kw()
    ck = str(tmp / "ck")
    os.makedirs(ck, exist_ok=True)
    live_a, ports_a = await flows.start_pair(("port", "port"), kw, ck)
    live_b, ports_b = await flows.start_pair(("port", "port"), kw, ck)
    seen["servers"] = (*live_a.values(), *live_b.values())
    pkg, leads = flows.Pkg("port"), []
    try:
        lead_a = await pkg.lead(kw, ports_a)
        leads.append(lead_a)
        directory = tfleet.FleetDirectory()
        seen["directory"] = directory
        for name, live, ports in (("A", live_a, ports_a), ("B", live_b, ports_b)):
            await directory.register(tfleet.HostPair(
                name=name, host0="127.0.0.1", port0=ports[0], host1="127.0.0.1",
                port1=ports[1], boot0=live["s0"].boot_id, boot1=live["s1"].boot_id))
        placer = tfleet.FleetPlacer(directory)
        assert (await placer.place("default")).name == "A"
        wi = tleader.WindowedIngest(lead_a)
        await flows.submit(wi, range(0, 6), False)
        await wi.seal_window()
        await flows.submit(wi, range(6, 9), False)
        lead_b = await pkg.lead(kw, ports_b, reset=False)
        leads.append(lead_b)
        await placer.migrate(wi, lead_b, session="default", dest="B")
        await flows.submit(wi, range(9, 12), False)
        out = {0: flows.result(await wi.crawl_window(0))}
        await wi.seal_window()
        out[1] = flows.result(await wi.crawl_window(1))
        return out, await directory.status()
    finally:
        for lead in leads:
            for c in (lead.c0, lead.c1):
                await c.aclose()
        for live in (live_a, live_b):
            for s in live.values():
                await flows.kill(s)


def _twice(monkeypatch, make):
    """``make(seen)``'s coroutine run unsanitized, then with both sanitizers
    armed -> (plain result, armed result, what the armed run saw)."""
    monkeypatch.delenv("FHH_DEBUG_GUARDS", raising=False)
    monkeypatch.delenv("FHH_DEBUG_TAINT", raising=False)
    with torch_ref.installed():
        plain = asyncio.run(asyncio.wait_for(make({}), RUN_S))
    monkeypatch.setenv("FHH_DEBUG_GUARDS", "1")
    monkeypatch.setenv("FHH_DEBUG_TAINT", "1")
    seen = {}
    with torch_ref.installed():
        armed = asyncio.run(asyncio.wait_for(make(seen), RUN_S))
    return plain, armed, seen


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kinds,leader", [(("port", "port"), "port"), (("jax", "port"), "jax")],
                         ids=["port-pair-port-leader", "mixed-pair-jax-leader"])
def test_sanitized_crawl_bit_identical(monkeypatch, kinds, leader, mode):
    plain, armed, seen = _twice(monkeypatch, lambda seen: _crawl(kinds, leader, mode, seen))
    assert armed == plain and plain
    names = [type(s).__name__ for s in seen["servers"]]
    assert names == [f"Guarded{'CollectorServer'}"] * 2
    assert type(seen["servers"][1]._table.default()).__name__ == "GuardedCollectionSession"
    alerts = seen["status"]["alerts"]
    assert set(alerts) == {"count", "dropped", "fired"} and alerts["count"] >= len(alerts["fired"])
    if mode == "ot2s":  # the port server's OT extension and seeds registered
        labels = set(ttaint._byte_markers.values())
        assert {"CollectionSession._sketch_seed", "CollectionSession._sec_seed"} <= labels
        assert labels & {"OtExtSender._seeds", "OtExtReceiver._seeds0"}


def test_sanitized_windowed_ingest_bit_identical(monkeypatch):
    plain, armed, seen = _twice(monkeypatch, _windowed)
    assert armed == plain and all(plain.values())
    assert type(seen["ingest"]).__name__ == "GuardedWindowedIngest"


def test_sanitized_fleet_move_bit_identical(monkeypatch, tmp_path):
    runs = iter(("plain", "armed"))
    plain, armed, seen = _twice(
        monkeypatch, lambda seen: _fleet_move(tmp_path / next(runs), seen))
    assert armed[0] == plain[0] and armed[0][0][0]
    assert armed[1]["placements"] == {"default": "B"}
    assert type(seen["directory"]).__name__ == "GuardedFleetDirectory"
    assert "CollectionSession._imported_pool_shares" in set(ttaint._byte_markers.values())
