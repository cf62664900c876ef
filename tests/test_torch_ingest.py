"""The PyTorch port's streaming ingestion (``submit_keys``, ``window_seal``,
``window_load`` of ``protocol/rpc.py``, the pools of
``protocol/sessions.py``, ``leader_rpc.WindowedIngest``) against the JAX
package, on the CPU over localhost TCP in one event loop, tolerance zero:

(a) windowed crawls under reservoir shedding, each window's result
    (hitters, paths, counts) equal to a batch crawl over exactly the keys
    its pool admitted, whose slot table equals what the port's own
    ``AdmissionController`` predicts from the seed and the offer order: a
    port pair and both mixed JAX/port pairs, under the port leader and the
    JAX leader; secure (ot2s) on a port pair and a mixed pair, which holds
    the OT sessions' consumption across windows to the JAX order; malicious
    on a port pair and a mixed pair, each window's committed root equal on
    both servers and to ``sketch.window_root`` of either package;
(b) the server verbs: seal idempotence and a sealed window's refusals, a
    replayed submission admitted once, Overloaded then retried and landed,
    idle-window eviction, the ``status`` ingest section beside the JAX
    server's;
(c) ingest-only checkpoints restored across packages both ways (pools,
    verdicts, ledgers, the reservoir's state), and torn ``ing_*`` fields
    refused with the pools untouched;
(d) server 1 killed mid-window, while window 1 ingests and window 0 crawls,
    with a ``submit_keys`` frame flooded on the leader's link to server 0:
    both windows bit-exact against their batch crawls, nothing admitted
    twice.

Ports come from the OS (``chip_smoke.free_ports``); every flow runs under
its own ``asyncio.wait_for``.  A killed server is the in-process stand-in
for a process death, as in ``test_torch_resilience.py``."""

import asyncio
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sketch as tsketch
from fuzzyheavyhitters_torch.resilience import admission as tadm
from fuzzyheavyhitters_torch.resilience.chaos import ChaosProxy, parse_faults
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jconfig, jsketch) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.utils.config", "fuzzyheavyhitters_tpu.protocol.sketch")

L, W, PER_W, BS = 5, 2, 16, 2  # data_len, windows, clients a window, keys a submission
FLOW_S = 240
RESERVOIR = dict(ingest_shed="reservoir", ingest_window_keys=8, ingest_seed=11)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(**kw):
    return dict(dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=BS, num_sites=4,
                     threshold=0.25, zipf_exponent=1.03, server0="127.0.0.1:1",
                     server1="127.0.0.1:2", distribution="zipf", f_max=32), **kw)


def _points(n=W * PER_W, seed=5):
    rng = np.random.default_rng(seed)
    pts = np.where(rng.random(n) < 0.6, 11, rng.integers(0, 1 << L, size=n))[:, None]
    return np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts]), rng


def _keys():
    bits, rng = _points()
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


def _sketch_keys():
    bits, _ = _points()
    srng = np.random.default_rng(99)
    seeds = srng.integers(0, 2**32, size=(bits.shape[0], 1, 2, 4), dtype=np.uint32)
    cseed = srng.integers(0, 2**32, size=4, dtype=np.uint32)
    return [tsketch.sketch_to_numpy(s) for s in tsketch.gen(
        seeds, bits, tfields.FE62, tfields.F255, cseed, device="cpu")]


KEYS = _keys()


def _chunks(w):
    """Window ``w``'s submissions: (client id, slice), as ``bin.leader``
    cuts them."""
    lo_w = w * PER_W
    return [(f"site{i % 4}", slice(lo, lo + BS))
            for i, lo in enumerate(range(lo_w, lo_w + PER_W, BS))]


def predict_pool(cfg_kw, w) -> list:
    """The slot table (chunk slices in slot order) the port's own gate
    decides for window ``w``'s offers in order."""
    cfg = tconfig.Config(**cfg_kw)
    ctl = tadm.AdmissionController(max_window_keys=cfg.ingest_window_keys,
                                   client_quota=cfg.ingest_client_quota,
                                   shed=cfg.ingest_shed, seed=cfg.ingest_seed)
    wa, table = ctl.window(w), []
    for client, sl in _chunks(w):
        v = ctl.admit(wa, client, sl.stop - sl.start)
        assert v.scope is None
        if v.admitted and v.slot is None:
            table.append(sl)
        elif v.admitted:
            table[v.slot] = sl
    return table


def _take(keys, slices):
    return tuple(np.concatenate([leaf[sl] for sl in slices]) for leaf in keys)


_BATCH = {}


def _batch(cfg_kw, w):
    """A batch crawl (the port's in-process ``driver.Leader``) over
    exactly the keys the gate admits into window ``w``."""
    table = predict_pool(cfg_kw, w)
    key = (tuple(sorted(cfg_kw.items())), w)
    if key not in _BATCH:
        k0, k1 = (tibdcf.keys_from_numpy(tibdcf.IbDcfKeyBatch(*_take(k, table)), "cpu")
                  for k in KEYS)
        n = k0.cw_seed.shape[0]
        lead = tdriver.Leader(*tdriver.make_servers(k0, k1), n_dims=1, data_len=L, f_max=32)
        _BATCH[key] = _result(lead.run(nreqs=n, threshold=cfg_kw["threshold"]))
        assert _BATCH[key][0]
    return _BATCH[key]


def _result(res):
    hitters = {tuple(int(v) for v in r): int(c) for r, c in zip(res.decode_ints(), res.counts)}
    return hitters, np.asarray(res.paths).tolist(), np.asarray(res.counts).tolist()


def _new_server(kind, sid, cfg_kw, ckpt_dir):
    if kind == "port":
        return trpc.CollectorServer(sid, tconfig.Config(**cfg_kw), "cpu", ckpt_dir=ckpt_dir)
    return jrpc.CollectorServer(sid, jconfig.Config(**cfg_kw), ckpt_dir=ckpt_dir)


async def _start(server, sid, ports):
    p0, p1 = ports
    await server.start("127.0.0.1", (p0, p1)[sid], "127.0.0.1", p1 + 1)
    return server


async def _start_pair(kinds, cfg_kw, ports, dirs):
    s1 = _new_server(kinds[1], 1, cfg_kw, dirs[1])
    t1 = asyncio.ensure_future(_start(s1, 1, ports))
    await asyncio.sleep(0.05)
    s0 = await _start(_new_server(kinds[0], 0, cfg_kw, dirs[0]), 0, ports)
    await asyncio.wait_for(t1, 60)
    return {"s0": s0, "s1": s1}


async def _kill(server):
    for w in list(server._ctl_writers):
        w.close()
    if server._peer_writer is not None:
        server._peer_writer.close()
    await asyncio.wait_for(server.aclose(), 30)


def _pools(server) -> dict:
    if isinstance(server, trpc.CollectorServer):
        return server._ingest._ingest_pools
    return server._default()._ingest_pools


def _stat(server, name) -> int:
    if isinstance(server, trpc.CollectorServer):
        return server.stats[name]
    return int(server._default().obs.counter_value(name))


def _counter(wi, name) -> int:
    if isinstance(wi, tleader.WindowedIngest):
        return wi.counters[name]
    return int(wi.obs.counter_value(name))


async def _windowed(kinds, leader, tmp, cfg_kw, *, faults=None, kill=False, sketch=None,
                    overlap=False):
    """Both windows through ``WindowedIngest`` of ``leader``'s package on
    servers of ``kinds``; with ``overlap`` window 0's crawl runs while window
    1's submissions land; ``faults`` is a fault spec on a proxy of the
    leader's link to server 0; ``kill`` kills server 1 once window 0's crawl
    began and window 1 holds two submissions, and starts it again on its
    ports and directory.  -> (per-window results, the gate's slot tables at
    each seal, figures)."""
    ports = chip_smoke.free_ports()
    dirs = (str(tmp / "s0"), str(tmp / "s1"))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    live = await _start_pair(kinds, cfg_kw, ports, dirs)
    rpc, lrpc, cfgmod = ((trpc, tleader, tconfig) if leader == "port"
                         else (jrpc, jleader, jconfig))
    px = None
    dial0 = ports[0]
    if faults is not None:
        px = await ChaosProxy("127.0.0.1", chip_smoke.free_ports()[0], "127.0.0.1", ports[0],
                              parse_faults(faults), link="ctl0").start()
        dial0 = px.listen_port
    clients = [await rpc.CollectorClient.connect("127.0.0.1", p) for p in (dial0, ports[1])]
    lead = lrpc.RpcLeader(cfgmod.Config(**cfg_kw), *clients)
    fig = {"tables": {}, "s1_pool1_at_kill": None}
    try:
        await lead._both("reset")
        wi = lrpc.WindowedIngest(lead)
        results, crawl = {}, None

        async def submit(w):
            for client, sl in _chunks(w):
                sk = {} if sketch is None else {
                    "sk0_chunk": [leaf[sl] for leaf in sketch[0]],
                    "sk1_chunk": [leaf[sl] for leaf in sketch[1]]}
                await wi.submit(client, tuple(leaf[sl] for leaf in KEYS[0]),
                                tuple(leaf[sl] for leaf in KEYS[1]), **sk)

        async def seal(w):
            st = await wi.seal_window()
            gate = _pools(live["s0"])[w]
            fig["tables"][w] = [e[1].tobytes() for e in gate.entries]  # root seeds a slot
            fig.setdefault("seals", {})[w] = st
            return st

        def landed(w):
            pool = _pools(live["s0"]).get(w)
            return 0 if pool is None else len(pool.entries)

        async def assassin():  # window 0 crawling, window 1 holding two submissions
            while not (getattr(lead, "paths", None) is not None and landed(1) >= 2):
                await asyncio.sleep(0.001)
            await _kill(live["s1"])
            await asyncio.sleep(0.3)
            live["s1"] = _new_server(kinds[1], 1, cfg_kw, dirs[1])
            await _start(live["s1"], 1, ports)

        for w in range(W):
            if overlap and w == 1:
                killer = asyncio.ensure_future(assassin()) if kill else None
                await submit(w)
                if killer is not None:
                    await asyncio.wait_for(killer, 60)
                results[0] = _result(await crawl)
            else:
                await submit(w)
            await seal(w)
            if overlap and w == 0:
                crawl = asyncio.ensure_future(wi.crawl_window(0))
            elif not overlap or w == 1:
                results[w] = _result(await wi.crawl_window(w))
        fig["stats"] = {k: {n: _stat(s, n) for n in ("pool_dup_submits", "pool_submits")}
                        for k, s in live.items()}
        fig["counters"] = {n: _counter(wi, n) for n in ("ingest_recoveries", "ingest_rejected",
                                                        "ingest_journal_replays")}
        fig["fired"] = px.fired if px is not None else []
        fig["servers"] = dict(live)
        fig["alive"] = [_alive(s) for s in live.values()]
        return results, fig
    finally:
        for c in clients:
            await c.aclose()
        if px is not None:
            await px.stop()
        for s in live.values():
            await _kill(s)


def _run(*args, **kw):
    with torch_ref.installed():
        return asyncio.run(asyncio.wait_for(_windowed(*args, **kw), FLOW_S))


def _alive(server) -> list:
    if isinstance(server, trpc.CollectorServer):
        return server.alive_keys.cpu().numpy().tolist()
    return np.asarray(server._default().alive_keys).tolist()


def _seeds(slices):
    return [KEYS[0].root_seed[sl].tobytes() for sl in slices]


def _check(results, fig, cfg_kw):
    for w in range(W):
        assert fig["tables"][w] == _seeds(predict_pool(cfg_kw, w)), w
        assert results[w] == _batch(cfg_kw, w), w
        assert fig["seals"][w]["keys"] == RESERVOIR["ingest_window_keys"]


# -- (a) windowed crawls against batch crawls of the admitted keys -------------


@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port"), ("port", "jax")],
                         ids=["port-pair", "jax0-port1", "port0-jax1"])
def test_windowed_crawl_equals_batch_crawl_of_admitted_keys(tmp_path, kinds, leader):
    cfg_kw = _cfg_kw(**RESERVOIR)
    results, fig = _run(kinds, leader, tmp_path, cfg_kw)
    _check(results, fig, cfg_kw)
    # the gate shed: the pool is a sample of the window
    assert all(len(t) < PER_W // BS for t in fig["tables"].values())


def test_windowed_crawl_on_data_shards_places_the_loaded_keys_per_shard(tmp_path):
    """Servers with two data shards: a loaded window's keys go through the
    upload's per-shard placement, and the server keeps its chunks for a
    re-shard; the windows equal their batch crawls."""
    cfg_kw = _cfg_kw(server_data_devices=2, **RESERVOIR)
    results, fig = _run(("port", "port"), "port", tmp_path, cfg_kw)
    _check(results, fig, cfg_kw)
    for s in fig["servers"].values():
        assert s._mesh.shards == 2 and len(s.keys_parts) == len(fig["tables"][W - 1])
        assert s._mesh.occupancy() == [RESERVOIR["ingest_window_keys"] // 2] * 2


@pytest.mark.parametrize("kinds", [("port", "port"), ("port", "jax")], ids=["port-pair",
                                                                           "port0-jax1"])
def test_secure_windowed_crawl_equals_batch_crawl(tmp_path, kinds):
    """Secure (ot2s): the OT sessions keep running across windows, so a
    mixed pair matches only if the port consumes them in the JAX order."""
    cfg_kw = _cfg_kw(secure_exchange=True, ot_path="ot2s", **RESERVOIR)
    results, fig = _run(kinds, "port", tmp_path, cfg_kw)
    _check(results, fig, cfg_kw)


@pytest.mark.parametrize("kinds,leader", [(("port", "port"), "port"),
                                          (("jax", "port"), "jax")],
                         ids=["port-pair-port-leader", "jax0-port1-jax-leader"])
def test_malicious_window_roots_agree_across_packages(tmp_path, kinds, leader):
    """The sketch leaves ride each submission; each sealed window commits
    ``sketch.window_root`` of the plane's coin flip, equal on both servers
    (the leaders refuse a mismatch), the two windows' roots apart; everyone
    honest stays alive and each window equals its batch crawl."""
    cfg_kw = _cfg_kw(malicious=True, **RESERVOIR)
    # the 16 wire leaves are the JAX sketch batch's jax.tree.leaves order
    results, fig = _run(kinds, leader, tmp_path, cfg_kw, sketch=_sketch_keys())
    _check(results, fig, cfg_kw)
    roots = [fig["seals"][w]["sk_root"] for w in range(W)]
    assert roots[0] != roots[1] and all(len(r) == 4 for r in roots)
    s0 = fig["servers"]["s0"]  # no fault: one plane, one coin flip
    flip = s0._sketch_seed if kinds[0] == "port" else s0._default()._sketch_seed
    for w in range(W):
        assert roots[w] == tsketch.window_root(flip, w).tolist()
        assert roots[w] == jsketch.window_root(flip, w).tolist()
    assert all(all(a) for a in fig["alive"])


def test_window_root_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(4):
        seed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
        for w in (0, 1, 7, 2**40):
            np.testing.assert_array_equal(tsketch.window_root(seed, w),
                                          jsketch.window_root(seed, w))


# -- (b) the server verbs ------------------------------------------------------


def _sub(w, sub_id, sl, client="c", **extra):
    return dict({"window": w, "sub_id": sub_id, "client_id": client,
                 "keys": tuple(leaf[sl] for leaf in KEYS[0])}, **extra)


def _server(kind, cfg_kw, ckpt_dir=None):
    return _new_server(kind, 0, cfg_kw, ckpt_dir)


def _call(server, verb, req):
    with torch_ref.installed():
        return asyncio.run(getattr(server, verb)(req))


def test_seal_is_idempotent_and_a_sealed_window_refuses():
    s = _server("port", _cfg_kw())
    assert _call(s, "submit_keys", _sub(0, "a", slice(0, 2)))["admitted"]
    st = _call(s, "window_seal", {"window": 0})
    assert st == {"window": 0, "sealed": True, "keys": 2, "subs": 1, "admitted_keys": 2,
                  "shed_keys": 0, "rejected": 0}
    assert _call(s, "window_seal", {"window": 0}) == st and s.stats["windows_sealed"] == 1
    with pytest.raises(RuntimeError, match="window 0 is sealed"):
        _call(s, "submit_keys", _sub(0, "b", slice(2, 4)))
    assert _call(s, "submit_keys", _sub(1, "b", slice(2, 4)))["admitted"]
    with pytest.raises(RuntimeError, match="window 1 is not sealed"):
        _call(s, "window_load", {"window": 1})
    with pytest.raises(RuntimeError, match="no ingest pool for window 5"):
        _call(s, "window_load", {"window": 5})
    assert _call(s, "window_seal", {"window": 2})["keys"] == 0  # an idle window seals
    with pytest.raises(RuntimeError, match="window 2 admitted no keys"):
        _call(s, "window_load", {"window": 2})
    with pytest.raises(RuntimeError, match="sketch material submitted to a semi-honest"):
        _call(s, "submit_keys", _sub(1, "c", slice(4, 6), sketch=[np.zeros(2)] * 16))
    loaded = _call(s, "window_load", {"window": 0})
    assert loaded == {"window": 0, "keys": 2, "subs": 1, "sketch": False}
    assert len(s.keys_parts) == 1 and s.keys is None and s.frontier is None
    assert sorted(s._ingest._ingest_pools) == [0, 1, 2]
    _call(s, "window_seal", {"window": 1})
    assert _call(s, "window_load", {"window": 1})["keys"] == 2
    assert sorted(s._ingest._ingest_pools) == [1, 2]  # earlier windows go at a load
    assert _call(s, "reset", {}) and not s._ingest._ingest_pools


def test_malicious_submit_needs_its_sketch_and_a_root():
    s = _server("port", _cfg_kw(malicious=True))
    with pytest.raises(RuntimeError, match="requires the client's sketch chunk"):
        _call(s, "submit_keys", _sub(0, "a", slice(0, 2)))
    with pytest.raises(ValueError, match="16 leaves, got 3"):
        _call(s, "submit_keys", _sub(0, "a", slice(0, 2), sketch=[np.zeros(2)] * 3))


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_replayed_submission_is_admitted_once(kind):
    """A submission replayed under a new request id (a reconnect, the
    recovery journal) answers its recorded verdict; the pool, the ledgers
    and the reservoir's stream stay as they were, on either package."""
    s = _server(kind, _cfg_kw(**RESERVOIR))
    first = [_call(s, "submit_keys", _sub(0, f"s{i}", sl, client))
             for i, (client, sl) in enumerate(_chunks(0))]
    pool = _pools(s)[0]
    before = (pool.keys, len(pool.entries), pool.wa.reservoir.state().tolist())
    again = _call(s, "submit_keys", _sub(0, "s5", _chunks(0)[5][1], "site1"))
    assert again == dict(first[5], dup=True)
    assert (pool.keys, len(pool.entries), pool.wa.reservoir.state().tolist()) == before
    assert _stat(s, "pool_dup_submits") == 1 and _stat(s, "pool_submits") == 9


def test_overloaded_then_retried_and_landed(tmp_path):
    """A rate-limited gate answers Overloaded; the leader backs off for the
    refill horizon and the same submission lands."""
    async def flow():
        cfg_kw = _cfg_kw(ingest_rate_keys_per_s=40.0, ingest_burst_keys=4)
        live = await _start_pair(("port", "port"), cfg_kw, chip_smoke.free_ports(),
                                 (None, None))
        clients = [await trpc.CollectorClient.connect("127.0.0.1", s._rpc_srv.sockets[0]
                                                      .getsockname()[1])
                   for s in (live["s0"], live["s1"])]
        try:
            lead = tleader.RpcLeader(tconfig.Config(**cfg_kw), *clients)
            wi = tleader.WindowedIngest(lead, checkpoint=False)
            for client, sl in _chunks(0)[:6]:
                r = await wi.submit(client, tuple(x[sl] for x in KEYS[0]),
                                    tuple(x[sl] for x in KEYS[1]))
                assert r["admitted"]
            assert wi.counters["ingest_rejected"] >= 1
            assert live["s0"].stats["pool_rejected"] == wi.counters["ingest_rejected"]
            st = await wi.seal_window()
            assert st["keys"] == 12 and st["rejected"] == wi.counters["ingest_rejected"]
            with pytest.raises(tleader.IngestOverloadedError, match="burst allowance"):
                await wi.submit("big", tuple(x[:6] for x in KEYS[0]),
                                tuple(x[:6] for x in KEYS[1]))
        finally:
            for c in clients:
                await c.aclose()
            for s in live.values():
                await _kill(s)

    asyncio.run(asyncio.wait_for(flow(), FLOW_S))


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_idle_windows_are_evicted_and_the_bound_refuses(kind):
    s = _server(kind, _cfg_kw(ingest_windows_retained=2))
    _call(s, "window_seal", {"window": 0})  # idle and sealed: evictable
    _call(s, "submit_keys", _sub(1, "a", slice(0, 2)))
    _call(s, "submit_keys", _sub(2, "b", slice(2, 4)))  # evicts window 0
    assert sorted(_pools(s)) == [1, 2]
    with pytest.raises(RuntimeError, match="window 3 would exceed the 2 live-window bound"):
        _call(s, "submit_keys", _sub(3, "c", slice(4, 6)))


def test_status_ingest_section_matches_jax():
    cfg_kw = _cfg_kw(**RESERVOIR)
    got = []
    for kind in ("port", "jax"):
        s = _server(kind, cfg_kw)
        for i, (client, sl) in enumerate(_chunks(0)):
            _call(s, "submit_keys", _sub(0, f"s{i}", sl, client))
        _call(s, "window_seal", {"window": 0})
        _call(s, "submit_keys", _sub(1, "n", slice(16, 18)))
        got.append(_call(s, "status", {})["ingest"])
    assert got[0] == got[1]
    assert got[0]["current_window"] == 1 and got[0]["queue_depth"] == 2 and got[0]["shed"] > 0


# -- (c) ingest checkpoints across packages ------------------------------------


def _fill(server, cfg_kw):
    for i, (client, sl) in enumerate(_chunks(0)):
        _call(server, "submit_keys", _sub(0, f"s{i}", sl, client))
    _call(server, "window_seal", {"window": 0})
    for i, (client, sl) in enumerate(_chunks(1)[:5]):
        _call(server, "submit_keys", _sub(1, f"t{i}", sl, client))


def _pool_view(server) -> dict:
    out = {}
    for w, p in sorted(_pools(server).items()):
        res = None if p.wa.reservoir is None else p.wa.reservoir.state().tolist()
        out[w] = (p.sealed, p.keys, p.admitted_keys, p.shed_keys, p.rejected,
                  [[a.tobytes() for a in e] for e in p.entries], dict(p.verdicts),
                  p.wa.subs, p.wa.keys, p.wa.sub_keys, dict(p.wa.client_keys), res)
    return out


@pytest.mark.parametrize("shed", ["reject", "reservoir"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_ingest_checkpoint_restores_across_packages(tmp_path, src, dst, shed):
    cfg_kw = _cfg_kw(**dict(RESERVOIR, ingest_shed=shed))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(a)
    os.makedirs(b)
    writer = _server(src, cfg_kw, a)
    _fill(writer, cfg_kw)
    assert _call(writer, "tree_checkpoint", {"level": -1, "ingest_only": True}) == {"level": -1}
    name = "fhh_server0_l-1.npz"
    shutil.copy(os.path.join(a, name), os.path.join(b, name))
    reader = _server(dst, cfg_kw, b)
    assert _call(reader, "tree_restore", {"level": -1}) == {"level": -1}
    assert _pool_view(reader) == _pool_view(writer)
    # the restored gate goes on with the same decisions
    for i, (client, sl) in enumerate(_chunks(1)[5:]):
        r = [_call(s, "submit_keys", _sub(1, f"u{i}", sl, client)) for s in (writer, reader)]
        assert r[0] == r[1]
    assert _pool_view(reader) == _pool_view(writer)


_TORN = {
    "meta missing": lambda z: z.pop("ing1_meta"),
    "a leaf missing": lambda z: z.pop("ing1_leaf2"),
    "a leaf cut short": lambda z: z.__setitem__("ing0_leaf1", z["ing0_leaf1"][:-1]),
    "verdicts torn": lambda z: z.__setitem__("ing1_sub_codes", z["ing1_sub_codes"][:-1]),
    "entry table torn": lambda z: z.__setitem__("ing0_lens", z["ing0_lens"][:-1]),
}


@pytest.mark.parametrize("tear", sorted(_TORN))
def test_torn_ingest_fields_are_refused_with_state_untouched(tmp_path, tear):
    cfg_kw = _cfg_kw(**RESERVOIR)
    s = _server("port", cfg_kw, str(tmp_path))
    _fill(s, cfg_kw)
    _call(s, "tree_checkpoint", {"level": -1, "ingest_only": True})
    path = tmp_path / "fhh_server0_l-1.npz"
    with np.load(path) as npz:
        z = {k: npz[k] for k in npz.files}
    _TORN[tear](z)
    with open(path, "wb") as f:
        np.savez(f, **z)
    _call(s, "submit_keys", _sub(1, "late", slice(30, 32)))  # state past the blob
    before = _pool_view(s)
    with pytest.raises(RuntimeError, match="tree_restore: .*(ingest|torn|covers)"):
        _call(s, "tree_restore", {"level": -1})
    assert _pool_view(s) == before


def test_ingest_only_checkpoint_refusals(tmp_path):
    s = _server("port", _cfg_kw(), str(tmp_path))
    with pytest.raises(RuntimeError, match="tree_checkpoint before tree_init"):
        _call(s, "tree_checkpoint", {"level": -1, "ingest_only": True})
    _call(s, "window_seal", {"window": 0})
    _call(s, "tree_checkpoint", {"level": -1, "ingest_only": True})
    os.replace(tmp_path / "fhh_server0_l-1.npz", tmp_path / "fhh_server0_l-2.npz")
    with pytest.raises(RuntimeError, match="stamped level -2 but records level -1"):
        _call(s, "tree_restore", {"level": -2})


# -- (d) a kill mid-window under a flood ---------------------------------------


@pytest.mark.parametrize("leader", ["port", "jax"])
def test_kill_mid_window_under_flood_is_bit_exact(tmp_path, leader):
    """Window 0 crawls while window 1 ingests; a ``submit_keys`` frame to
    server 0 arrives twice (the dedup absorbs it) and server 1 dies and
    comes back on its directory: it restores window 0's ingest checkpoint,
    the journal replays (window 0's records as duplicates, window 1's
    rebuilding its pool), window 0's crawl runs again, and both windows
    equal their batch crawls, each admitted set exactly the gate's."""
    cfg_kw = _cfg_kw(**RESERVOIR)
    results, fig = _run(("port", "port"), leader, tmp_path, cfg_kw,
                        faults="ctl0:flood@msg=4,count=1", kill=True, overlap=True)
    _check(results, fig, cfg_kw)
    assert fig["fired"] == [("flood", "c2s", 4)]
    assert fig["counters"]["ingest_recoveries"] >= 1
    assert fig["counters"]["ingest_journal_replays"] >= 1
    assert fig["stats"]["s1"]["pool_dup_submits"] >= 1
    assert fig["servers"]["s1"].stats["restores"] == 1


def test_slow_client_stalls_only_itself(tmp_path):
    """Three frames of the leader's link to server 0, from window 0's
    ingest checkpoint on (window 1's submissions and window 0's crawl verbs
    share the link), trickle in 100 ms late each: nothing faults, nothing
    is recovered, and both windows equal their batch crawls."""
    cfg_kw = _cfg_kw(**RESERVOIR)
    results, fig = _run(("port", "port"), "port", tmp_path, cfg_kw,
                        faults="ctl0:slowclient@msg=12,ms=100,count=3", overlap=True)
    _check(results, fig, cfg_kw)
    assert fig["fired"] == [("slowclient", "c2s", m) for m in (12, 13, 14)]
    assert fig["counters"]["ingest_recoveries"] == 0

