"""The PyTorch port's collector fleet, its units against the JAX package on
the CPU, tolerance zero: ``resilience/chaos.py``'s host drills
(``parse_host_faults``, ``HostChaos``, ``ChaosLinks``), ``protocol/fleet.py``
(``FleetDirectory``'s scan, placement and probe, ``FleetPlacer``'s status),
the ``session_export`` / ``session_import`` verbs of ``protocol/rpc.py``
(their refusals leave the state as it was; retire; a migrated reservoir;
the ``status`` ``fleet`` section) and blobs exported by either package
imported by the other.  Shapes are the JAX ``tests/test_fleet.py``'s (L =
5, d = 1).  The end-to-end moves are ``test_torch_fleet_rpc.py`` and
``test_torch_fleet_secure.py``."""

import asyncio
import json
import os
import re
import time

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.bin import server as tserver_bin
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import fleet as tfleet
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import tenancy as ttenancy
from fuzzyheavyhitters_torch.resilience import chaos as tchaos
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jconfig, jfleet, jchaos, jtenancy, _jtrace) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.utils.config",
    "fuzzyheavyhitters_tpu.protocol.fleet", "fuzzyheavyhitters_tpu.resilience.chaos",
    "fuzzyheavyhitters_tpu.protocol.tenancy", "fuzzyheavyhitters_tpu.obs.trace")

L, N = 5, 12
PKGS = {"port": (trpc, tconfig, tfleet, tchaos), "jax": (jrpc, jconfig, jfleet, jchaos)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(**kw):
    return dict(dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=8, num_sites=4,
                     threshold=0.2, zipf_exponent=1.03, server0="127.0.0.1:1",
                     server1="127.0.0.1:2", distribution="zipf", f_max=32), **kw)


def _keys():
    rng = np.random.default_rng(3)
    pts = np.concatenate([np.full(N - 4, 11), rng.integers(0, 1 << L, size=4)])[:, None]
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, _ = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0)


KEYS = _keys()


def _sub(w, sub_id, lo, hi, client="c"):
    return {"window": w, "sub_id": sub_id, "client_id": client,
            "keys": tuple(leaf[lo:hi] for leaf in KEYS)}


def _server(kind, kw, ckpt_dir=None):
    rpc, cfgmod = PKGS[kind][:2]
    if kind == "port":
        return rpc.CollectorServer(0, cfgmod.Config(**kw), "cpu", ckpt_dir=ckpt_dir)
    return rpc.CollectorServer(0, cfgmod.Config(**kw), ckpt_dir=ckpt_dir)


def _call(server, verb, req):
    with torch_ref.installed():
        return asyncio.run(getattr(server, verb)(req))


def _pools(server) -> dict:
    return server._default()._ingest_pools


def _pool_view(server) -> dict:
    out = {}
    for w, p in sorted(_pools(server).items()):
        res = None if p.wa.reservoir is None else p.wa.reservoir.state().tolist()
        out[w] = (p.sealed, p.keys, p.admitted_keys, p.shed_keys, p.rejected,
                  None if p.sk_root is None else np.asarray(p.sk_root).tolist(),
                  [[a.tobytes() for a in e] for e in p.entries], dict(p.verdicts),
                  p.wa.subs, p.wa.keys, p.wa.sub_keys, dict(p.wa.client_keys),
                  p.wa.pending_draws, res)
    return out


def _boot(server) -> str:
    return server.boot_id if isinstance(server, trpc.CollectorServer) else server._boot_id


def _counter(server, name) -> int:
    cs = server._default()
    return cs.summary()[name] if isinstance(server, trpc.CollectorServer) else int(
        cs.obs.counter_value(name))


def _fill(server):
    """Window 0 sealed with six submissions, window 1 open with three."""
    for i in range(6):
        _call(server, "submit_keys", _sub(0, f"s{i}", i, i + 1, f"site{i % 2}"))
    _call(server, "window_seal", {"window": 0})
    for i in range(6, 9):
        _call(server, "submit_keys", _sub(1, f"s{i}", i, i + 1, f"site{i % 2}"))


# -- the host drills -----------------------------------------------------------

_SPECS = ["host:kill@window=2; host:kill@window=5", "", "host:kill",
          "mesh:kill@window=1", "host:pause@window=1", "host:kill@level=1",
          "host:kill@window=-1", "host:kill@"]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_host_faults_matches_jax(spec):
    """Each spec parses to the JAX package's clauses, or is refused with
    its ``ValueError`` text."""
    got = []
    for chaos in (tchaos, jchaos):
        try:
            got.append([(f.action, f.at_window) for f in chaos.parse_host_faults(spec)])
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]
    if spec.startswith("host:kill@window=2"):
        assert got[0] == [("kill", 2), ("kill", 5)]


def test_host_chaos_fires_once_per_clause(monkeypatch):
    # the JAX injector emits a trace instant through its package's obs.trace,
    # which the reference loader detaches after each import
    monkeypatch.setattr(jchaos.obs, "trace", _jtrace, raising=False)
    events = []
    hc = tchaos.HostChaos(tchaos.parse_host_faults("host:kill@window=1;host:kill@window=3"),
                          emit=lambda event, **kw: events.append((event, kw)))
    jhc = jchaos.HostChaos(jchaos.parse_host_faults("host:kill@window=1;host:kill@window=3"))
    for w in range(5):
        assert hc.before_window(w) is jhc.before_window(w) is (w in (1, 3))
    assert hc.fired == jhc.fired == [("kill", 1), ("kill", 3)]
    assert events == [("resilience.host_chaos_fired", {"action": "kill", "window": 1}),
                      ("resilience.host_chaos_fired", {"action": "kill", "window": 3})]


def test_chaos_links_proxy_the_three_links():
    """One fault spec, three proxies on consecutive ports; a frame through
    each arrives, and the ``ctl1`` clause severs only its own link."""
    async def flow():
        got = {}

        async def echo(reader, writer):
            data = await reader.read(64)
            writer.write(data)
            await writer.drain()
            writer.close()

        srvs = [await asyncio.start_server(echo, "127.0.0.1", 0) for _ in range(3)]
        targets = [("127.0.0.1", s.sockets[0].getsockname()[1]) for s in srvs]
        base = _three_free_ports()
        links = await tchaos.ChaosLinks("127.0.0.1", base, *targets,
                                        faults=tchaos.parse_faults("ctl1:sever@msg=1")).start()
        try:
            for link in ("ctl0", "ctl1", "plane"):
                assert links.addr(link) == ("127.0.0.1", base + ("ctl0", "ctl1",
                                                                 "plane").index(link))
                r, w = await asyncio.open_connection(*links.addr(link))
                w.write(trpc._HDR.pack(3) + b"abc")
                await w.drain()
                got[link] = await asyncio.wait_for(r.read(64), 10)
                w.close()
        finally:
            await links.stop()
            for s in srvs:
                s.close()
        return got, links.proxies["ctl1"].fired

    got, fired = asyncio.run(flow())
    assert got["ctl0"] == got["plane"] == trpc._HDR.pack(3) + b"abc"
    assert got["ctl1"] == b"" and fired == [("sever", "c2s", 1)]


def _three_free_ports() -> int:
    """Three consecutive free ports."""
    import socket

    while True:
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            base = a.getsockname()[1]
            try:
                with socket.socket() as b, socket.socket() as c:
                    b.bind(("127.0.0.1", base + 1))
                    c.bind(("127.0.0.1", base + 2))
            except OSError:
                continue
        return base


# -- the directory and the placer ---------------------------------------------


def _reg_row(d, pair, sid, boot, capacity=4):
    (d / f"{pair}_s{sid}.json").write_text(json.dumps({
        "pair": pair, "server_id": sid, "host": "127.0.0.1", "port": 1000 + sid,
        "boot_id": boot, "capacity": capacity, "ts": 1.0}))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_directory_scan_folds_halves_and_skips_torn(tmp_path, pkg):
    fleet = PKGS[pkg][2]
    _reg_row(tmp_path, "pairA", 0, "bootA0", capacity=2)
    _reg_row(tmp_path, "pairA", 1, "bootA1", capacity=2)
    _reg_row(tmp_path, "pairB", 0, "bootB0")  # half a pair: still starting
    (tmp_path / "torn_s0.json").write_text("{\"pair\": \"to")  # a torn write

    async def flow():
        fd = fleet.FleetDirectory(str(tmp_path))
        n = await fd.scan()
        pairs = await fd.pairs()
        await fd.note_load("pairA", stall_fill_ratio=0.5, max_progress_age_s=3.0)
        await fd.scan()  # the load signals survive a scan
        return n, pairs, await fd.pairs(), await fd.status()

    n, pairs, rescanned, st = asyncio.run(flow())
    assert n == 1 and [p.name for p in pairs] == ["pairA"]
    assert (pairs[0].boot0, pairs[0].boot1, pairs[0].capacity) == ("bootA0", "bootA1", 2)
    assert pairs[0].addr(1) == ("127.0.0.1", 1001)
    assert (rescanned[0].stall_fill_ratio, rescanned[0].max_progress_age_s) == (0.5, 3.0)
    assert st == {"pairs": {"pairA": {"alive": True, "boot0": "bootA0", "boot1": "bootA1",
                                      "capacity": 2, "stall_fill_ratio": 0.5,
                                      "max_progress_age_s": 3.0}}, "placements": {}}


def _placements(fleet):
    async def flow():
        fd = fleet.FleetDirectory()
        await fd.register(fleet.HostPair(name="A", capacity=1))
        await fd.register(fleet.HostPair(name="B", capacity=4))
        names = [(await fd.place("t1")).name,  # a tie on load: the name decides
                 (await fd.place("t2")).name,  # A is full: B
                 (await fd.place("t3")).name]  # B at 1/4 beats A at 1/1
        await fd.register(fleet.HostPair(name="C", capacity=4))
        await fd.note_load("C", stall_fill_ratio=0.9)
        names.append((await fd.place("t4")).name)  # C at 0/4 beats B at 2/4
        await fd.register(fleet.HostPair(name="D", capacity=4))
        await fd.note_load("D", stall_fill_ratio=0.9)
        names.append((await fd.place("t5")).name)  # C and D at 1/4 and 0/4: D
        await fd.note_load("C", stall_fill_ratio=0.1)
        await fd.release("t4")
        names.append((await fd.place("t6")).name)  # C, D at 0/4, 1/4: C
        names.append((await fd.place("t7")).name)  # C and D at 1/4: the lower stall, C
        await fd.mark_dead("C")
        names.append((await fd.place("t8", exclude=("A",))).name)  # D 1/4 beats B 2/4
        placed = await fd.placement_of("t8")
        err = None
        try:
            await fleet.FleetDirectory().place("t")
        except RuntimeError as e:
            err = str(e)
        return names, placed, await fd.orphans_of("C"), await fd.status(), err

    return asyncio.run(flow())


def test_placement_prefers_least_loaded_pair_as_jax():
    got = _placements(tfleet)
    assert got == _placements(jfleet)
    names, placed, orphans, st, err = got
    assert names == ["A", "B", "B", "C", "D", "C", "C", "D"]
    assert placed == "D" and orphans == ["t6", "t7"]
    assert st["pairs"]["C"]["alive"] is False
    assert err == "fleet: no live pair to place onto"


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_probe_marks_dead_on_error_and_on_changed_boot(pkg):
    fleet = PKGS[pkg][2]

    async def flow():
        events = []
        fd = (tfleet.FleetDirectory(emit=lambda e, **kw: events.append((e, kw)))
              if pkg == "port" else fleet.FleetDirectory())
        for name in ("up", "rebooted", "down"):
            await fd.register(fleet.HostPair(name=name, boot0="b0", boot1="b1"))
        await fd.move("tenant", "down")

        async def probe_fn(name):
            if name == "down":
                raise ConnectionError("unreachable")
            return {"boot0": "b0", "boot1": "NEW" if name == "rebooted" else "b1"}

        died = await fd.probe(probe_fn)
        again = await fd.probe(probe_fn)  # dead pairs are not probed again
        return sorted(died), again, await fd.orphans_of("down"), await fd.status(), events

    died, again, orphans, st, events = asyncio.run(flow())
    assert died == ["down", "rebooted"] and again == [] and orphans == ["tenant"]
    assert [st["pairs"][p]["alive"] for p in ("up", "rebooted", "down")] == [True, False,
                                                                            False]
    if pkg == "port":
        assert events == [("fleet.pairs_dead", {"pairs": ["down", "rebooted"]})]


def test_placer_status_keys_and_values_match_jax():
    """A placement and a failing migration: both placers count the same,
    and the in-flight stamp is cleared on the failure."""
    class Broken:
        async def migrate(self, new_lead):
            raise RuntimeError("export refused")

    async def flow(fleet):
        fd = fleet.FleetDirectory()
        await fd.register(fleet.HostPair(name="A"))
        placer = fleet.FleetPlacer(fd)
        await placer.place("t")
        with pytest.raises(RuntimeError, match="export refused"):
            await placer.migrate(Broken(), None, session="t", dest="B")
        return placer.status(), await fd.placement_of("t")

    got = [asyncio.run(flow(f)) for f in (tfleet, jfleet)]
    assert got[0] == got[1] == ({"placement_decisions": 1, "session_migrations": 0,
                                 "session_failovers": 0, "migration_inflight_since": 0.0},
                                "A")


def test_scheduler_fleet_load_matches_jax():
    for sched in (ttenancy.TenantScheduler(), jtenancy.TenantScheduler()):
        assert sched.fleet_load(now=100.0) == {"stall_fill_ratio": 0.0,
                                               "max_progress_age_s": 0.0}
        sched.note_dispatch("ta")
        assert 5.0 <= sched.fleet_load(now=time.time() + 5.0)["max_progress_age_s"] < 6.0
        sched.forget("ta")
        assert sched.fleet_load(now=100.0)["max_progress_age_s"] == 0.0


# -- the verbs -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_session_export_refuses_mid_level_and_without_ckpt_dir(tmp_path, kind):
    with pytest.raises(RuntimeError, match="session_export: no checkpoint dir"):
        _call(_server(kind, _cfg_kw()), "session_export", {})
    s = _server(kind, _cfg_kw(), str(tmp_path))
    _call(s, "submit_keys", _sub(0, "a", 0, 2))
    cs = s._default()
    cache = "children" if kind == "port" else "_children"
    setattr(cs, cache, [])  # a child cache between crawl and prune: mid-level
    with pytest.raises(RuntimeError, match="session is mid-level"):
        _call(s, "session_export", {})
    setattr(cs, cache, None)
    cs._shard_children[0] = object()  # a span of a level being assembled
    with pytest.raises(RuntimeError, match="session is mid-level"):
        _call(s, "session_export", {})
    cs._shard_children.clear()
    x = _call(s, "session_export", {})
    assert (x["epoch"], x["boot"], x["windows"]) == (1, _boot(s), [0])
    assert x["path"] == str(tmp_path / "fhh_server0_lxport.npz") and os.path.exists(x["path"])
    assert _call(s, "session_export", {})["epoch"] == 2
    # the export file stays outside the level grammar
    assert cs.ckpt_levels() == [] and _counter(s, "session_exports") == 2


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_session_import_refuses_torn_blob_without_mutating(tmp_path, kind):
    src = _server("port", _cfg_kw(), str(tmp_path))
    _call(src, "submit_keys", _sub(0, "a", 0, 2))
    x = _call(src, "session_export", {})
    blob = open(x["path"], "rb").read()
    with open(x["path"], "wb") as f:
        f.write(blob[:len(blob) // 2])  # torn mid-write
    dst = _server(kind, _cfg_kw(), str(tmp_path))
    _call(dst, "submit_keys", _sub(0, "mine", 4, 6))
    before = _pool_view(dst)
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        _call(dst, "session_import", {"path": x["path"], "boot": x["boot"],
                                      "epoch": x["epoch"]})
    assert _pool_view(dst) == before  # both hosts untouched
    assert len(_pools(src)[0].entries) == 1
    with pytest.raises(RuntimeError, match="session_import: no blob at"):
        _call(dst, "session_import", {"level": 7})
    with pytest.raises(RuntimeError, match="session_import: no checkpoint dir"):
        _call(_server(kind, _cfg_kw()), "session_import", {"level": -1})


def _refusal_cases(tmp_path, kind):
    """(name, request, the refusal) of an export that must not import."""
    os.makedirs(tmp_path / "src")
    src = _server("port", _cfg_kw(), str(tmp_path / "src"))
    _fill(src)
    x = _call(src, "session_export", {})
    req = {"path": x["path"], "boot": x["boot"], "epoch": x["epoch"]}
    with np.load(x["path"]) as z:
        fields = {k: z[k] for k in z.files}

    def variant(name, **change):
        path = str(tmp_path / f"{name}.npz")
        blob = dict(fields)
        for k, v in change.items():
            if v is None:
                blob.pop(k)
            else:
                blob[k] = v
        with open(path, "wb") as f:
            np.savez(f, **blob)
        return dict(req, path=path)

    return req, [
        ("wrong stamp epoch", dict(req, epoch=99), "stale file"),
        ("wrong stamp boot", dict(req, boot="0" * 16), "stale file"),
        ("another collection", variant("sess", sess=np.str_("tenant-b")),
         "stamped for collection 'tenant-b', not 'default'"),
        ("not ingest-only", variant("crawl", ing_only=np.bool_(False)),
         "only ingest-form blobs migrate"),
        ("radix 2 into radix 1", variant("radix", radix=np.int64(2)),
         "exported under crawl_radix_bits=2; this session runs crawl_radix_bits=1"),
        ("torn ing tail", variant("torn", ing1_leaf2=None), "missing leaf 2"),
        ("torn verdicts", variant("verdicts", ing0_sub_codes=fields["ing0_sub_codes"][:-1]),
         "verdict table is torn"),
    ]


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_session_import_refuses_before_it_changes_anything(tmp_path, kind):
    """Every refusal of the JAX verb, each leaving the destination as it
    was; then the announced export imports once, and a second import of the
    same stamp is refused."""
    req, cases = _refusal_cases(tmp_path, kind)
    dst = _server(kind, _cfg_kw(), str(tmp_path / "src"))
    _call(dst, "submit_keys", _sub(0, "mine", 10, 12))
    before = _pool_view(dst)
    for name, bad, want in cases:
        with pytest.raises(RuntimeError, match=re.escape(want)):
            _call(dst, "session_import", bad)
        assert _pool_view(dst) == before, name
    assert _counter(dst, "session_imports") == 0
    assert _call(dst, "session_import", req) == {"windows": [0, 1]}
    with pytest.raises(RuntimeError, match="already imported"):
        _call(dst, "session_import", req)
    assert _counter(dst, "session_imports") == 1


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_session_import_refuses_radix_one_into_radix_two(tmp_path, kind):
    src = _server("port", _cfg_kw(), str(tmp_path))
    _fill(src)
    x = _call(src, "session_export", {})
    dst = _server(kind, _cfg_kw(crawl_radix_bits=2), str(tmp_path))
    with pytest.raises(RuntimeError, match=re.escape(
            "exported under crawl_radix_bits=1; this session runs crawl_radix_bits=2")):
        _call(dst, "session_import", {"path": x["path"], "boot": x["boot"],
                                      "epoch": x["epoch"]})
    assert _pools(dst) == {}


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_retire_requires_matching_epoch_and_drops_sealed_pools(tmp_path, kind):
    s = _server(kind, _cfg_kw(), str(tmp_path))
    _call(s, "submit_keys", _sub(0, "a", 0, 2))
    _call(s, "window_seal", {"window": 0})
    x = _call(s, "session_export", {})
    for bad in ({"retire": True, "epoch": 99}, {"retire": True}):
        with pytest.raises(RuntimeError, match="retire epoch"):
            _call(s, "session_export", bad)
    assert len(_pools(s)) == 1  # the refusals changed nothing
    assert _call(s, "session_export", {"retire": True, "epoch": x["epoch"]}) == {
        "retired": True, "pools_dropped": 1}
    assert _pools(s) == {} and not os.path.exists(x["path"])
    assert s._default().idle()
    if kind == "port":
        assert s.summary()["sessions_retired"] == 1


@pytest.mark.parametrize("src_kind,dst_kind", [("port", "port"), ("jax", "port"),
                                               ("port", "jax")])
def test_migrated_reservoir_continues_identical_shed_stream(tmp_path, src_kind, dst_kind):
    """The reservoir's state rides the export: the destination's next shed
    decisions are the source's, slot for slot, and so are the seal stats."""
    kw = _cfg_kw(ingest_window_keys=4, ingest_shed="reservoir", ingest_seed=17)
    src = _server(src_kind, kw, str(tmp_path))
    for i in range(8):
        _call(src, "submit_keys", _sub(0, f"s{i}", i, i + 1))
    x = _call(src, "session_export", {})
    dst = _server(dst_kind, kw, str(tmp_path))
    _call(dst, "session_import", {"path": x["path"], "boot": x["boot"], "epoch": x["epoch"]})
    assert _pool_view(dst) == _pool_view(src)
    want = [_call(src, "submit_keys", _sub(0, f"f{i}", i, i + 1)) for i in range(8, 12)]
    got = [_call(dst, "submit_keys", _sub(0, f"f{i}", i, i + 1)) for i in range(8, 12)]
    assert got == want and any(r.get("shed") for r in got)
    assert _call(dst, "window_seal", {"window": 0}) == _call(src, "window_seal", {"window": 0})


# -- across packages -----------------------------------------------------------


def _blob(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shed", ["reject", "reservoir"])
def test_export_blob_is_the_jax_blob_field_for_field(tmp_path, shed):
    kw = _cfg_kw(**({"ingest_window_keys": 4, "ingest_shed": "reservoir", "ingest_seed": 5}
                    if shed == "reservoir" else {}))
    blobs = {}
    for kind in ("port", "jax"):
        os.makedirs(tmp_path / kind)
        s = _server(kind, kw, str(tmp_path / kind))
        _fill(s)
        blobs[kind] = _blob(_call(s, "session_export", {})["path"])
    port, jax_ = blobs["port"], blobs["jax"]
    assert sorted(port) == sorted(jax_)
    for k in port:
        assert port[k].dtype == jax_[k].dtype and port[k].shape == jax_[k].shape, k
        if k not in ("xp_boot",) and not k.endswith("_sealed_at"):
            assert port[k].tobytes() == jax_[k].tobytes(), k
    assert (port["ing_only"].dtype, port["sess"].dtype.kind, port["level"].dtype,
            port["radix"].dtype, port["xp_epoch"].dtype) == (np.bool_, "U", np.int64,
                                                             np.int64, np.int64)


@pytest.mark.parametrize("src_kind,dst_kind", [("jax", "port"), ("port", "jax")])
def test_exports_import_across_packages(tmp_path, src_kind, dst_kind):
    """A JAX server's export imports into a port server and the reverse:
    the pools, verdicts, ledgers and the reservoir are equal, the next
    submissions answer alike, and a replayed one answers its recorded
    verdict on both."""
    kw = _cfg_kw(ingest_window_keys=4, ingest_shed="reservoir", ingest_seed=9)
    src = _server(src_kind, kw, str(tmp_path))
    _fill(src)
    x = _call(src, "session_export", {})
    dst = _server(dst_kind, kw, str(tmp_path))
    assert _call(dst, "session_import", {"path": x["path"], "boot": x["boot"],
                                         "epoch": x["epoch"]}) == {"windows": [0, 1]}
    assert _pool_view(dst) == _pool_view(src)
    for i in range(9, 12):
        r = [_call(s, "submit_keys", _sub(1, f"n{i}", i, i + 1)) for s in (src, dst)]
        assert r[0] == r[1]
    dup = [_call(s, "submit_keys", _sub(1, "s7", 7, 8, "site1")) for s in (src, dst)]
    assert dup[0] == dup[1] and dup[0]["dup"] is True
    assert _pool_view(dst) == _pool_view(src)
    # the import forced the collection's channel to key up again
    assert dst._default().plane_epoch == 0 and dst._default()._ot_snd is None
    src_st, dst_st = (_call(s, "status", {})["fleet"] for s in (src, dst))
    assert (src_st["session_exports"], dst_st["session_imports"]) == (1, 1)


def test_status_fleet_section_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FHH_FLEET_PAIR", "pairA")
    got = {}
    for kind in ("port", "jax"):
        os.makedirs(tmp_path / kind)
        s = _server(kind, _cfg_kw(), str(tmp_path / kind))
        _fill(s)
        _call(s, "session_export", {})
        st = _call(s, "status", {})["fleet"]
        assert st.pop("boot_id") == _boot(s)
        st["load"].pop("max_progress_age_s")
        got[kind] = st
    assert got["port"] == got["jax"] == {"pair": "pairA", "session_exports": 1,
                                         "session_imports": 0,
                                         "load": {"stall_fill_ratio": 0.0}}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fleet_registration_rows_scan_into_a_pair(tmp_path, monkeypatch, pkg):
    """``bin.server``'s registration: each server writes its half by a
    rename, prints ``fleet.registered``, and either package's directory
    scans the two halves into one pair with the servers' boot ids."""
    monkeypatch.setenv("FHH_FLEET", str(tmp_path / "fleet"))
    monkeypatch.setenv("FHH_FLEET_PAIR", "pairB")
    monkeypatch.setenv("FHH_FLEET_CAPACITY", "3")
    servers = [trpc.CollectorServer(i, tconfig.Config(**_cfg_kw()), "cpu") for i in (0, 1)]
    events = []
    monkeypatch.setattr(tserver_bin, "emit", lambda event, **kw: events.append((event, kw)))
    paths = [tserver_bin.fleet_register(s, i, "127.0.0.1", 4000 + i)
             for i, s in enumerate(servers)]
    assert [os.path.basename(p) for p in paths] == ["pairB_s0.json", "pairB_s1.json"]
    assert sorted(os.listdir(tmp_path / "fleet")) == ["pairB_s0.json", "pairB_s1.json"]
    assert events == [("fleet.registered", {"pair": "pairB", "server": i,
                                            "boot_id": s.boot_id})
                      for i, s in enumerate(servers)]
    fleet = PKGS[pkg][2]

    async def flow():
        fd = fleet.FleetDirectory(str(tmp_path / "fleet"))
        return await fd.scan(), await fd.pairs()

    n, pairs = asyncio.run(flow())
    assert n == 1
    p = pairs[0]
    assert (p.name, p.boot0, p.boot1, p.capacity, p.addr(0), p.addr(1)) == (
        "pairB", servers[0].boot_id, servers[1].boot_id, 3, ("127.0.0.1", 4000),
        ("127.0.0.1", 4001))
    monkeypatch.delenv("FHH_FLEET")
    assert tserver_bin.fleet_register(servers[0], 0, "127.0.0.1", 4000) is None


def test_status_probe_reads_boot_ids_and_bounds_a_dead_pair():
    """``fleet.status_probe`` reads a live pair's two boot ids through
    ``status``; once the pair is closed the probe fails within its budget
    (a refused dial retried until the budget runs out), and the directory
    marks only that pair dead."""
    import torch_fleet_flows as F

    async def flow():
        live, ports = await F.start_pair(("port", "port"), _cfg_kw(), None)
        pair = tfleet.HostPair(name="A", host0="127.0.0.1", port0=ports[0],
                               host1="127.0.0.1", port1=ports[1],
                               boot0=live["s0"].boot_id, boot1=live["s1"].boot_id)
        gone = tfleet.HostPair(name="Z", host0="127.0.0.1", port0=ports[0],
                               host1="127.0.0.1", port1=ports[1], boot0="x", boot1="y")
        probe = tfleet.status_probe({"A": pair, "Z": gone}, budget_s=1.0)
        got = await probe("A")
        fd = tfleet.FleetDirectory()
        await fd.register(pair)
        await fd.register(gone)
        assert await fd.probe(probe) == ["Z"]  # its boot ids are not the servers'
        for s in live.values():
            await F.kill(s)
        t0 = time.perf_counter()
        with pytest.raises((asyncio.TimeoutError, ConnectionError, OSError)):
            await probe("A")
        waited = time.perf_counter() - t0
        return got, waited, await fd.probe(probe), (live["s0"].boot_id, live["s1"].boot_id)

    got, waited, died, boots = asyncio.run(asyncio.wait_for(flow(), 60))
    assert (got["boot0"], got["boot1"]) == boots
    assert waited < 2.0 and died == ["A"]
