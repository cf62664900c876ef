"""Drills of many collections on one server pair (the PyTorch port's
``protocol/sessions.py``, ``protocol/tenancy.py``, ``leader_rpc.
MultiCollectionDriver`` and ``bin.leader``'s ``FHH_COLLECTION``) against the
JAX package, on the CPU over localhost TCP, tolerance zero:

(a) four secure collections at once on a JAX server 0 beside a port server
    1 under the port's ``MultiCollectionDriver``, each equal to its solo run
    (``test_torch_tenants_rpc.py``'s check), and two secure collections at
    once: the port servers' scheduler counts stall fills (JAX
    ``test_multi_tenant_stall_fills_observed``);
(b) per-collection gates: a collection flooding its token bucket dry leaves
    another collection's submissions all admitted;
(c) the flood-and-kill drill (JAX ``tests/test_sessions.py:454``): one
    collection floods its gate while another streams a window through
    ``WindowedIngest``, seals it and crawls it, and server 1 is killed at
    round 2 of that crawl and started again on its ports and checkpoint
    directory: the window's hitters equal a batch crawl of its keys, its
    gate refused nothing while the flooder's refused, the reconnected
    clients' hellos bound their collections on the new server, and each
    collection's checkpoints lie in its own namespace;
(d) two ``bin.leader`` processes with distinct ``FHH_COLLECTION``s on one
    port pair, supervised and warmed: each prints the hitters of the port's
    in-process driver on its keys, and the two collections' warmups share
    the ladder (one warm run a shape a server).

The shapes and helpers are ``test_torch_tenants_rpc.py``'s."""

import asyncio
import json
import os
import sys

import pytest
import torch

import chip_smoke
import test_torch_tenants_rpc as tt
import torch_ref
from fuzzyheavyhitters_torch.bin import leader as tleader_bin
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import tenancy as ttenancy
from fuzzyheavyhitters_torch.resilience import policy as tpolicy
from fuzzyheavyhitters_torch.utils import config as tconfig

L, FLOW_S, PKG = tt.L, tt.FLOW_S, tt.PKG
_cfg_kw, _keys, _take, _result = tt._cfg_kw, tt._keys, tt._take, tt._result
_start_pair, _kill, _solo = tt._start_pair, tt._kill, tt._solo


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_four_secure_collections_on_a_mixed_pair_equal_their_solo_runs(tmp_path):
    tt.four_collections(tmp_path, "secure", ("jax", "port"), "port")


def test_two_secure_collections_fill_each_others_stalls(tmp_path):
    """Two secure collections at once: some device turns run while the
    other collection waits on the wire (JAX ``test_multi_tenant_stall_fills
    _observed``)."""
    with torch_ref.installed():
        solo, res, status, live, _ = asyncio.run(asyncio.wait_for(
            tt._tenants_flow(("port", "port"), "port", _cfg_kw(**tt.SECURE), 16, 2, tmp_path,
                             False), FLOW_S))
    assert _result(res["t0"]) == solo == tt._want(100, 16)
    assert _result(res["t1"]) == tt._want(101, 16)
    sched = status["sessions"]["scheduler"]
    assert sched["stall_fills"] > 0 and 0 < sched["fill_ratio"] <= 1
    assert sum(sched["fills_by_session"].values()) == sched["stall_fills"]
    for s in live.values():
        st = s._sched.stats()
        assert st["stall_fills"] > 0 and st["wire_waiting"] == []


async def _flood(wi, keys, lo, hi, step, errors):
    """Submit ``keys[lo:hi]`` in chunks of ``step`` as one client; each
    submission that ends in ``errors`` counts as refused."""
    refused = 0
    for i in range(lo, hi, step):
        try:
            await wi.submit("flooder", _take(keys[0], slice(i, i + step)),
                            _take(keys[1], slice(i, i + step)))
        except errors:
            refused += 1
        await asyncio.sleep(0.005)
    return refused


@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port")],
                         ids=["port-pair", "jax0-port1"])
def test_per_collection_gates_isolate_a_flooding_collection(kinds):
    """Collection ``ta`` floods its token bucket dry; every submission of
    ``tb`` is admitted: each collection has its own gate (JAX
    ``test_per_session_gates_flooding_tenant_isolated``)."""
    cfg_kw = _cfg_kw(ingest_rate_keys_per_s=64.0, ingest_burst_keys=8)
    kA, kB = _keys(21, 64), _keys(22, 8)

    async def flow():
        ports = chip_smoke.free_ports()
        live = await _start_pair(kinds, cfg_kw, ports)
        drv = tleader.MultiCollectionDriver(tconfig.Config(**cfg_kw), "127.0.0.1", ports[0],
                                            "127.0.0.1", ports[1])
        try:
            wa = tleader.WindowedIngest(
                await drv.open("ta"), checkpoint=False,
                policy=tpolicy.RetryPolicy(base_s=0.001, cap_s=0.002, factor=1.0, attempts=2))
            wb = tleader.WindowedIngest(await drv.open("tb"), checkpoint=False)

            async def honest():
                for i in range(8):
                    await wb.submit(f"b{i}", _take(kB[0], slice(i, i + 1)),
                                    _take(kB[1], slice(i, i + 1)))
                    await asyncio.sleep(0.005)

            await asyncio.gather(_flood(wa, kA, 0, 64, 8, tleader.IngestOverloadedError),
                                 honest())
            return await wa.seal_window(), await wb.seal_window()
        finally:
            await drv.close()
            for s in live.values():
                await _kill(s)

    with torch_ref.installed():
        st_a, st_b = asyncio.run(asyncio.wait_for(flow(), FLOW_S))
    assert st_a["rejected"] > 0
    assert st_b["keys"] == 8 and st_b["rejected"] == 0


@pytest.mark.parametrize("kinds,leader", [(("port", "port"), "port"), (("jax", "port"), "jax")],
                         ids=["port-pair-port-leader", "jax0-port1-jax-leader"])
def test_flood_and_kill_mid_crawl_keeps_the_other_collection_exact(tmp_path, kinds, leader):
    """Collection ``ta`` floods its gate; ``tb`` streams 10 clients into a
    window, seals and crawls it; server 1 is killed at round 2 of that crawl
    and started again on its ports and directory.  ``tb``'s window equals a
    batch crawl of its keys, its gate refused nothing, ``ta``'s did; the
    reconnected clients bound their collections on the new server, and each
    collection's checkpoints lie in its own namespace."""
    nb = 10
    cfg_kw = _cfg_kw(ingest_rate_keys_per_s=200.0, ingest_burst_keys=16)
    kA, kB = _keys(31, 96), _keys(32, nb)
    dirs = (str(tmp_path / "s0"), str(tmp_path / "s1"))
    for d in dirs:
        os.makedirs(d)
    rpc, lrpc, cfgmod = PKG[leader]
    pol = (tpolicy if leader == "port" else tt.jpolicy).RetryPolicy(base_s=0.001, cap_s=0.002,
                                                                 factor=1.0, attempts=2)

    async def flow():
        ports = chip_smoke.free_ports()
        live = await _start_pair(kinds, cfg_kw, ports, dirs)
        drv = lrpc.MultiCollectionDriver(cfgmod.Config(**cfg_kw), "127.0.0.1", ports[0],
                                         "127.0.0.1", ports[1])
        try:
            lead_a, lead_b = await drv.open("ta"), await drv.open("tb")
            wa = lrpc.WindowedIngest(lead_a, checkpoint=False, policy=pol)
            wb = lrpc.WindowedIngest(lead_b)  # checkpointing on
            for i in range(nb):
                await wb.submit(f"b{i}", _take(kB[0], slice(i, i + 1)),
                                _take(kB[1], slice(i, i + 1)))
            await wb.seal_window()
            fig = {}

            async def assassin():  # round 2 of tb's crawl on server 1
                while True:
                    cs = live["s1"]._table.peek("tb")
                    if cs is not None and cs.stats["levels"] >= 2:
                        break
                    await asyncio.sleep(0.001)
                fig["killed_at"] = cs.stats["levels"]
                await _kill(live["s1"])
                await asyncio.sleep(0.3)
                live["s1"] = trpc.CollectorServer(1, tconfig.Config(**cfg_kw), "cpu",
                                                  ckpt_dir=dirs[1])
                await live["s1"].start("127.0.0.1", ports[1], "127.0.0.1", ports[1] + 1)

            errors = (lrpc.IngestOverloadedError, ConnectionError, TimeoutError, OSError,
                      RuntimeError)
            kill = asyncio.ensure_future(assassin())
            fl = asyncio.ensure_future(_flood(wa, kA, 0, 96, 8, errors))
            res_b = await wb.crawl_window(0, max_recoveries=8)
            await kill
            await fl
            fig["st_b"] = await lead_b.c0.call("status")
            fig["st_a"] = await lead_a.c0.call("status")
            new = live["s1"]._table
            fig["bound"] = {k: new.peek(k).bound for k in ("ta", "tb") if new.peek(k)}
            fig["restores"] = new.peek("tb").stats["restores"]
            return _result(res_b), fig
        finally:
            await drv.close()
            for s in live.values():
                await _kill(s)

    async def batch():  # a fault-free crawl of tb's keys on a fresh pair
        ports = chip_smoke.free_ports()
        live = await _start_pair(("port", "port"), cfg_kw, ports)
        try:
            return await _solo("port", cfg_kw, ports, _take(kB[0], slice(0, nb)),
                               _take(kB[1], slice(0, nb)), nb)
        finally:
            for s in live.values():
                await _kill(s)

    with torch_ref.installed():
        got, fig = asyncio.run(asyncio.wait_for(flow(), FLOW_S))
    want = asyncio.run(asyncio.wait_for(batch(), FLOW_S))
    assert got == want and want[0]
    assert fig["killed_at"] >= 2
    ing_b, ing_a = fig["st_b"]["ingest"], fig["st_a"]["ingest"]
    assert ing_b["rejected"] == 0 and ing_b["admitted"] == nb and ing_b["shed"] == 0
    assert ing_a["rejected"] > 0
    # the reconnects said hello with their collections to the new server 1
    assert fig["bound"].get("tb", 0) >= 1 and fig["restores"] >= 1
    for sid, d in enumerate(dirs):
        names = os.listdir(d)
        assert names and all(nm.startswith(f"fhh_server{sid}_ctb_l") for nm in names), names


def test_two_leader_processes_with_distinct_collections_share_one_pair(tmp_path):
    """Two ``bin.leader`` processes, ``FHH_COLLECTION=ca`` and ``cb``, run
    their supervised, warmed crawls at once on one port pair: each prints
    the hitters of the port's in-process driver on its own keys, each
    collection checkpointed in its namespace, and each server warmed every
    shape once for the two collections (the second's warmup hit the
    ladder)."""
    ttenancy.ladder_reset()  # shapes this worker warmed before are not this test's
    cfg_kw = _cfg_kw()
    n = 48
    seeds = {"ca": 5, "cb": 6}
    cfg = tconfig.Config(**cfg_kw)
    want = {}
    for key, seed in seeds.items():
        ck = tleader_bin.client_keys(cfg, n, torch.device("cpu"), seed)
        k0, k1 = (tibdcf.keys_from_numpy(k, "cpu") for k in (ck.keys0, ck.keys1))
        res = tdriver.Leader(*tdriver.make_servers(k0, k1), n_dims=1, data_len=L,
                             f_max=cfg.f_max).run(nreqs=n, threshold=cfg.threshold)
        want[key] = {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
    dirs = (str(tmp_path / "s0"), str(tmp_path / "s1"))
    for d in dirs:
        os.makedirs(d)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    async def flow():
        ports = chip_smoke.free_ports()
        live = await _start_pair(("port", "port"), cfg_kw, ports, dirs)
        path = str(tmp_path / "config.json")
        with open(path, "w") as f:
            json.dump(dict(cfg_kw, server0=f"127.0.0.1:{ports[0]}",
                           server1=f"127.0.0.1:{ports[1]}"), f)
        env = {k: v for k, v in os.environ.items() if not k.startswith("FHH_")}
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["FHH_CKPT_EVERY"] = "2"
        try:
            procs = {key: await asyncio.create_subprocess_exec(
                sys.executable, "-m", "fuzzyheavyhitters_torch.bin.leader", "--config", path,
                "-n", str(n), "--seed", str(seed), "--device", "cpu", cwd=str(tmp_path),
                env=dict(env, FHH_COLLECTION=key), stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.STDOUT) for key, seed in seeds.items()}
            outs = {}
            for key, p in procs.items():
                out, _ = await asyncio.wait_for(p.communicate(), FLOW_S)
                outs[key] = (p.returncode, out.decode())
            stats = {sid: {k: dict(s._table.peek(k).stats) for k in seeds}
                     for sid, s in enumerate((live["s0"], live["s1"]))}
            return outs, stats
        finally:
            for s in live.values():
                await _kill(s)

    outs, stats = asyncio.run(asyncio.wait_for(flow(), FLOW_S))
    for key, (rc, text) in outs.items():
        assert rc == 0, text[-3000:]
        ev = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
        got = {e["value"]: e["count"] for e in ev if e["event"] == "hitter"}
        assert got == want[key] and got, key
        done = next(e for e in ev if e["event"] == "crawl.done")
        assert done["supervised"] and done["crawl_checkpoints"] >= 1
    for sid, per in stats.items():
        shapes = [per[k]["warmup_shapes"] for k in seeds]
        hits = [per[k]["warmup_ladder_hits"] for k in seeds]
        assert sum(shapes) == 5 and sum(shapes) + sum(hits) == 10, (shapes, hits)  # 1..16
        for key in seeds:
            assert per[key]["levels"] == L
    for sid, d in enumerate(dirs):
        names = os.listdir(d)
        for key in seeds:
            assert any(nm.startswith(f"fhh_server{sid}_c{key}_l") for nm in names), names
