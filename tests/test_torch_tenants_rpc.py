"""Many collections on one server pair (the PyTorch port's ``protocol/
sessions.py``, ``protocol/tenancy.py`` and ``leader_rpc.
MultiCollectionDriver``) against the JAX package, on the CPU over localhost
TCP in one event loop, tolerance zero: four collections crawled at once,
trusted and secure (ot2s), on a port pair and on a JAX server 0 beside a
port server 1, under the port's ``MultiCollectionDriver`` and under the JAX
one.  Each collection's paths and counts equal its solo run's (the port's
in-process driver on its keys; for ``t0`` also its keys crawled alone in
the default collection of the same pair), the ``status`` ``sessions``
section counts the five collections, each keyed its own channel, the port
servers' per-collection counters sum to their totals, and each supervised
collection checkpoints in its own namespace.

The secure cases under the JAX driver run in ``test_torch_sessions.py``, and
the mixed pair's secure case under the port's driver and the drills (stall
fills, gates, the flood-and-kill drill, two ``bin.leader`` processes) in
``test_torch_tenants_drill.py``, so that each file stays near a minute on
one worker (a secure collection's base OT takes seconds).  The
shapes are ``tests/test_sessions.py``'s (L = 5, d = 1; secure n = 24).
Ports come from the OS (``chip_smoke.free_ports``)."""

import asyncio
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sessions as tsessions
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jconfig, jpolicy) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.utils.config", "fuzzyheavyhitters_tpu.resilience.policy")

L = 5
FLOW_S = 240
SECURE = dict(secure_exchange=True, ot_path="ot2s")
PKG = {"port": (trpc, tleader, tconfig), "jax": (jrpc, jleader, jconfig)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(**kw):
    return dict(dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=64, num_sites=4,
                     threshold=0.05, zipf_exponent=1.0, server0="127.0.0.1:1",
                     server1="127.0.0.1:2", distribution="zipf", f_max=16, backend="cpu"),
                **kw)


def _keys(seed, n):
    """``tests/test_sessions.py``'s clients (four sites) as wire-form keys."""
    r = np.random.default_rng(seed)
    sites = r.integers(0, 1 << L, size=4)
    pts = sites[r.integers(0, 4, size=n)]
    bits = np.array([[tbits.int_to_bits(L, int(v))] for v in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, r, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


def _take(keys, sl):
    return tibdcf.IbDcfKeyBatch(*(np.asarray(a)[sl] for a in keys))


def _result(res):
    return np.asarray(res.paths).tolist(), np.asarray(res.counts).tolist()


async def _start_pair(kinds, cfg_kw, ports, dirs=(None, None)):
    made = {"port": lambda sid: trpc.CollectorServer(sid, tconfig.Config(**cfg_kw), "cpu",
                                                     ckpt_dir=dirs[sid]),
            "jax": lambda sid: jrpc.CollectorServer(sid, jconfig.Config(**cfg_kw),
                                                    ckpt_dir=dirs[sid])}
    s0, s1 = made[kinds[0]](0), made[kinds[1]](1)
    p0, p1 = ports
    t1 = asyncio.ensure_future(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    await asyncio.wait_for(asyncio.gather(s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1), t1),
                           60)
    return {"s0": s0, "s1": s1}


async def _kill(server):
    for w in list(server._ctl_writers):
        w.close()
    if server._peer_writer is not None:
        server._peer_writer.close()
    await asyncio.wait_for(server.aclose(), 30)


async def _solo(leader, cfg_kw, ports, k0, k1, n):
    """One collection's keys crawled alone in the default collection."""
    rpc, lrpc, cfgmod = PKG[leader]
    clients = [await rpc.CollectorClient.connect("127.0.0.1", p) for p in ports]
    try:
        lead = lrpc.RpcLeader(cfgmod.Config(**cfg_kw), *clients)
        await lead._both("reset")
        await lead.upload_keys(k0, k1)
        return _result(await lead.run(n))
    finally:
        for c in clients:
            await c.aclose()


def _port_servers(live):
    return [s for s in live.values() if isinstance(s, trpc.CollectorServer)]


def _check_sums(server):
    """Every collection's counters sum to the server's totals."""
    rows = server.sessions_status()["per_session"]
    timers = tuple(f"{t}_{x}" for t in tsessions.SUMMARY_TIMERS for x in ("s", "calls"))
    for k in tsessions.SUMMARY_COUNTERS + timers:
        assert (sum(r["counters"][k] for r in rows.values())
                == pytest.approx(server.summary()[k])), k
    for ph in tsessions.PHASES:
        assert (sum(r["counters"]["seconds"][ph] for r in rows.values())
                == pytest.approx(server.summary()["seconds"][ph]))


_WANT: dict = {}


def _want(seed, n):
    """The port's in-process driver on a collection's keys: what its solo
    run must give (cached)."""
    if (seed, n) not in _WANT:
        k0, k1 = (tibdcf.keys_from_numpy(k, "cpu") for k in _keys(seed, n))
        res = tdriver.Leader(*tdriver.make_servers(k0, k1), n_dims=1, data_len=L,
                             f_max=16).run(nreqs=n, threshold=_cfg_kw()["threshold"])
        _WANT[seed, n] = _result(res)
    return _WANT[seed, n]


async def _tenants_flow(kinds, leader, cfg_kw, n, n_coll, tmp, supervised):
    """A pair of ``kinds``; first ``t0``'s keys crawled alone in the default
    collection (the solo run), then ``n_coll`` collections at once through
    ``leader``'s ``MultiCollectionDriver``.  -> (solo result, results,
    ``t0``'s status, the servers, their checkpoint dirs)."""
    ports = chip_smoke.free_ports()
    dirs = tuple(str(tmp / f"s{i}") for i in (0, 1))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    live = await _start_pair(kinds, cfg_kw, ports, dirs)
    keysets = {f"t{i}": _keys(100 + i, n) for i in range(n_coll)}
    rpc, lrpc, cfgmod = PKG[leader]
    try:
        solo = await _solo(leader, cfg_kw, ports, *keysets["t0"], n)
        drv = lrpc.MultiCollectionDriver(cfgmod.Config(**cfg_kw), "127.0.0.1", ports[0],
                                         "127.0.0.1", ports[1])
        try:
            jobs = [{"collection": key, "nreqs": n, "keys0": k0, "keys1": k1}
                    for key, (k0, k1) in keysets.items()]
            kw = {"checkpoint_every": 2} if supervised else {}
            res = await drv.run_collections(jobs, supervised=supervised, **kw)
            status = await drv.leaders["t0"].c0.call("status")
        finally:
            await drv.close()
        return solo, res, status, live, dirs
    finally:
        for s in live.values():
            await _kill(s)


def four_collections(tmp_path, mode, kinds, leader):
    """(a): four collections at once, each equal to its solo run; ``t0``'s
    solo run is a crawl of its keys alone in the default collection of the
    same pair, every collection's the port's in-process driver on its keys."""
    secure = mode == "secure"
    cfg_kw = _cfg_kw(**(SECURE if secure else {}))
    n = 24 if secure else 48
    supervised = leader == "port"  # the JAX driver's acceptance test runs unsupervised
    with torch_ref.installed():
        solo, res, status, live, dirs = asyncio.run(asyncio.wait_for(
            _tenants_flow(kinds, leader, cfg_kw, n, 4, tmp_path, supervised), FLOW_S))
    for i in range(4):
        key = f"t{i}"
        assert not isinstance(res[key], BaseException), (key, res[key])
        assert _result(res[key]) == _want(100 + i, n), key
    assert _result(res["t0"]) == solo and solo[0]
    sess = status["sessions"]
    assert sess["count"] == 5  # the default collection (the solo run) and four tenants
    assert sorted(sess["per_session"]) == ["default", "t0", "t1", "t2", "t3"]
    assert status["collection"] == "t0"
    for row in sess["per_session"].values():
        assert {"phase", "level", "queue_depth", "dedup_entries", "ckpt_levels",
                "plane_epoch"} <= set(row)
        assert row["plane_epoch"] >= 1  # every collection keyed its own channel
    assert sess["scheduler"]["device_turns"] > 0
    for s in _port_servers(live):
        _check_sums(s)
        for t in ("t0", "t1", "t2", "t3"):
            assert s._table.peek(t).summary()["levels"] == L
            if secure:
                assert s._table.peek(t)._ot_snd is not None
    if supervised:  # each collection checkpointed in its own namespace
        for sid, d in enumerate(dirs):
            names = sorted(os.listdir(d))
            for t in ("t0", "t1", "t2", "t3"):
                assert f"fhh_server{sid}_c{t}_l3.npz" in names, names
            assert not any(nm.startswith(f"fhh_server{sid}_l") for nm in names), names


@pytest.mark.parametrize("mode,kinds,leader", [
    ("trusted", ("port", "port"), "port"), ("trusted", ("port", "port"), "jax"),
    ("trusted", ("jax", "port"), "port"), ("trusted", ("jax", "port"), "jax"),
    ("secure", ("port", "port"), "port")],
    ids=["trusted-port-pair-port", "trusted-port-pair-jax", "trusted-jax0-port1-port",
         "trusted-jax0-port1-jax", "secure-port-pair-port"])
def test_four_collections_equal_their_solo_runs(tmp_path, mode, kinds, leader):
    """The secure cases under the JAX driver are in ``test_torch_sessions.py``,
    the mixed pair's under the port's in ``test_torch_tenants_drill.py``
    (each file stays near a minute on one worker)."""
    four_collections(tmp_path, mode, kinds, leader)
