"""The PyTorch port's supervised socket crawl against the JAX package's, on
the CPU over localhost TCP, in one event loop, tolerance zero: the
server's replay dedup, status and checkpoint verbs with their refusals,
the reconnecting client, and the supervised leader through the JAX
package's drills (its ``tests/test_resilience.py``): a sever of the
leader's control link to server 0 in the answer's direction (the verb ran,
its answer was lost: the replay must come from the cache) and a kill and
restart of server 1 at the first checkpoint, trusted and secure; a span
lost mid-level; the radix-2 crawl; and the mixed pairs, which hold the
slice against the reference: the JAX leader driving port servers, the
port leader driving a JAX server with a port server in both roles, and a
server killed and restarted as the other package's on the same
checkpoint directory, both ways (each package's blob layout restored into
the other's).  Every drill's hitters, paths and counts equal the
fault-free JAX pair's.

Ports come from the OS (``chip_smoke.free_ports``); every drill runs under
its own ``asyncio.wait_for``.  A killed server is the in-process stand-in
for a process death: its transports and listeners close, its memory goes,
its checkpoint files stay."""

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
from fuzzyheavyhitters_torch.resilience import policy as respolicy
from fuzzyheavyhitters_torch.resilience.chaos import ChaosProxy, parse_faults
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jibdcf, jconfig) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.ops.ibdcf", "fuzzyheavyhitters_tpu.utils.config")

L, N = 5, 12
DRILL_S = 240  # each drill's own limit: a wedged plane fails its test, not the suite
MODES = {"trusted": {}, "secure": dict(secure_exchange=True, ot_path="ot2s")}
# frame 9 from server 0 to the leader (hello, reset, 2 add_keys, tree_init, level
# 0's crawl and prune, level 1's crawl, then its prune): that prune ran, its
# answer is cut
SEVER = "ctl0:sever@msg=9,dir=s2c"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are tiny, and the suite's other
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(**kw):
    return dict(dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=8, num_sites=4,
                     threshold=0.2, zipf_exponent=1.03, server0="127.0.0.1:1",
                     server1="127.0.0.1:2", distribution="zipf", f_max=32), **kw)


def _keys(seed=7, n=N):
    """Both parties' keys in wire form: n - 4 clients at 11, 4 random."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.full(n - 4, 11), rng.integers(0, 1 << L, size=4)])[:, None]
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


KEYS = _keys()


def _result(res):
    """(hitters, paths, counts) of a crawl, exactly."""
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
    """Process death, as peers see it: every transport and listener closes
    (transports first: on Python 3.12 a listener's ``wait_closed`` waits
    for them)."""
    for w in list(server._ctl_writers):
        w.close()
    if server._peer_writer is not None:
        server._peer_writer.close()
    await asyncio.wait_for(server.aclose(), 30)


def _counter(lead, name):
    if isinstance(lead, tleader.RpcLeader):
        return lead.counters[name]
    return lead.obs.counter_value(name)


def _first_checkpoint(lead):
    return _counter(lead, "crawl_checkpoints") >= 1


async def _supervised(kinds, leader, tmp, *, mode="trusted", sever=None, restart_as=None,
                      kill_when=_first_checkpoint, ckpt=True, extra=None, budgets=None,
                      checkpoint_every=2, keys=KEYS):
    """One supervised crawl: servers of ``kinds`` (server 0, server 1:
    "port" or "jax") with checkpoint directories under ``tmp`` (none
    without ``ckpt``), the ``leader`` of either package, the fault spec
    ``sever`` on a proxy of its control link to server 0, and with
    ``restart_as`` server 1 killed once ``kill_when(leader)`` (by default
    at the first checkpoint) and a server of that kind started on its ports
    and directory.  Returns (result, leader, figures)."""
    cfg_kw = _cfg_kw(**MODES[mode], **(extra or {}))
    ports = chip_smoke.free_ports()
    dirs = (str(tmp / "s0"), str(tmp / "s1")) if ckpt else (None, None)
    for d in dirs:
        if d:
            os.makedirs(d, exist_ok=True)
    live = await _start_pair(kinds, cfg_kw, ports, dirs)
    rpc, lrpc, cfgmod, ibdcf = ((trpc, tleader, tconfig, tibdcf) if leader == "port"
                                else (jrpc, jleader, jconfig, jibdcf))
    px = None
    dial0 = ports[0]
    if sever is not None:
        px = await ChaosProxy("127.0.0.1", chip_smoke.free_ports()[0], "127.0.0.1", ports[0],
                              parse_faults(sever), link="ctl0").start()
        dial0 = px.listen_port
    clients = [await rpc.CollectorClient.connect("127.0.0.1", p, budgets=budgets)
               for p in (dial0, ports[1])]
    lead = lrpc.RpcLeader(cfgmod.Config(**cfg_kw), *clients)
    fig = {"boots": [c.boot_id for c in clients]}

    async def assassin():
        while not kill_when(lead):
            await asyncio.sleep(0)
        await _kill(live["s1"])
        await asyncio.sleep(0.3)
        live["s1"] = _new_server(restart_as, 1, cfg_kw, dirs[1])
        await _start(live["s1"], 1, ports)

    try:
        kill = asyncio.ensure_future(assassin()) if restart_as else None
        k0, k1 = (ibdcf.IbDcfKeyBatch(*k) for k in keys)
        res = await lead.run_supervised(N, k0, k1, checkpoint_every=checkpoint_every)
        if kill is not None:
            await asyncio.wait_for(kill, 30)
        fig["status"] = [await c.call("status") for c in clients]
        fig["epochs"] = [c.epoch for c in clients]
        fig["fired"] = px.fired if px is not None else []
        fig["levels"] = {k: _counter(lead, k) for k in
                         ("recoveries", "levels_rerun", "shards_rerun", "crawl_checkpoints")}
        fig["servers"] = dict(live)
        return res, lead, fig
    finally:
        for c in clients:
            await c.aclose()
        if px is not None:
            await px.stop()
        for s in live.values():
            await _kill(s)


def _drill(kinds, leader, tmp, **kw):
    with torch_ref.installed():
        return asyncio.run(asyncio.wait_for(_supervised(kinds, leader, tmp, **kw), DRILL_S))


_WANT = {}


def _jax_fault_free(tmp, mode="trusted", extra=None):
    """The reference: the JAX pair under the JAX leader's supervised crawl,
    no fault."""
    key = (mode, tuple(sorted((extra or {}).items())))
    if key not in _WANT:
        res, _, fig = _drill(("jax", "jax"), "jax", tmp / f"ff_{len(_WANT)}", mode=mode,
                             extra=extra)
        assert fig["levels"]["recoveries"] == 0
        _WANT[key] = _result(res)
        assert _WANT[key][0]  # the stacked clients clear the threshold
    return _WANT[key]


def _port_driver(keys=KEYS):
    k0, k1 = (tibdcf.keys_from_numpy(k, "cpu") for k in keys)
    lead = tdriver.Leader(*tdriver.make_servers(k0, k1), n_dims=1, data_len=L, f_max=32)
    return _result(lead.run(nreqs=N, threshold=0.2))[0]


# -- the server: replay dedup, status, the checkpoint namespace ---------------


async def _port_pair(cfg_kw=None, dirs=(None, None)):
    ports = chip_smoke.free_ports()
    live = await _start_pair(("port", "port"), cfg_kw or _cfg_kw(), ports, dirs)
    return live, ports


def test_session_replay_answers_from_cache():
    """Resending the same (session, request id) does not run the verb again:
    ``add_keys`` appends once, and a replayed refusal is the same refusal."""
    async def flow():
        live, (p0, _) = await _port_pair()
        s0 = live["s0"]
        r, w = await asyncio.open_connection("127.0.0.1", p0)
        await trpc._send(w, (1, "__hello__", {"session": "t-sess", "epoch": 1}))
        hello = await trpc._recv(r)
        assert hello[0] == 1 and hello[1]["boot_id"] == s0.boot_id
        await trpc._send(w, (2, "reset", {}))
        assert (await trpc._recv(r))[1] is True
        frame = (3, "add_keys", {"keys": tuple(KEYS[0])})
        for _ in range(2):  # the second is a replay
            await trpc._send(w, frame)
            assert (await trpc._recv(r))[1] is True
        assert len(s0.keys_parts) == 1 and s0.stats["add_keys"] == 1
        await trpc._send(w, (4, "status", {}))
        st = (await trpc._recv(r))[1]
        assert st["dedup_hits"] == 1 and st["has_keys"] and not st["has_frontier"]
        assert st["mesh"] is None and st["ckpt_levels"] == [] and st["plane_resets"] == 0
        errs = []
        for _ in range(2):
            await trpc._send(w, (5, "tree_restore", {"level": 0}))
            errs.append((await trpc._recv(r))[1])
        assert "no checkpoint dir" in errs[0]["__error__"] and errs[0] == errs[1]
        assert s0.stats["dedup_hits"] == 2
        w.close()
        for s in live.values():
            await _kill(s)

    asyncio.run(asyncio.wait_for(flow(), DRILL_S))


def test_session_cache_is_byte_bounded():
    sess = trpc._Session()
    big = np.zeros(trpc._SESSION_CACHE_BYTES // 4, np.uint8)
    for i in range(1, 8):
        sess.put(i, {"shares": big})
    assert len(sess.cache) < 7 and 7 in sess.cache  # the newest survives
    assert sess.bytes_total <= trpc._SESSION_CACHE_BYTES + big.nbytes
    one = trpc._Session()
    one.put(1, np.zeros(trpc._SESSION_CACHE_BYTES + 1024, np.uint8))
    assert 1 in one.cache
    many = trpc._Session()
    for i in range(trpc._SESSION_CACHE_CAP + 10):
        many.put(i, True)
    assert len(many.cache) == trpc._SESSION_CACHE_CAP and 0 not in many.cache


def test_client_reconnects_and_replays_across_sever():
    """The answer to ``reset`` is cut: the client redials through the proxy
    and replays, and the server answers from its cache."""
    async def flow():
        live, (p0, _) = await _port_pair()
        px = await ChaosProxy("127.0.0.1", chip_smoke.free_ports()[0], "127.0.0.1", p0,
                              parse_faults("ctl0:sever@msg=2,dir=s2c"), link="ctl0").start()
        c0 = await trpc.CollectorClient.connect("127.0.0.1", px.listen_port)
        assert await c0.call("reset") is True
        st = await c0.call("status")
        assert c0.epoch == 2 and c0.stats["reconnects"] == 1
        assert st["dedup_hits"] == 1 and px.fired == [("sever", "s2c", 2)]
        await c0.aclose()
        await px.stop()
        for s in live.values():
            await _kill(s)

    asyncio.run(asyncio.wait_for(flow(), DRILL_S))


def test_blackhole_exhausts_verb_budget_loudly():
    async def flow():
        live, (p0, _) = await _port_pair()
        px = await ChaosProxy("127.0.0.1", chip_smoke.free_ports()[0], "127.0.0.1", p0,
                              parse_faults("ctl0:blackhole@msg=2,count=99"), link="ctl0").start()
        c0 = await trpc.CollectorClient.connect(
            "127.0.0.1", px.listen_port,
            budgets=respolicy.VerbBudgets(default_s=0.6, per_verb={}))
        with pytest.raises(TimeoutError):
            await c0.call("reset")
        await c0.aclose()
        await px.stop()
        for s in live.values():
            await _kill(s)

    asyncio.run(asyncio.wait_for(flow(), DRILL_S))


def test_new_boot_id_raises_server_restarted():
    """A server restarted under a call: the redial's hello finds another
    boot id, and the call refuses to replay into the empty state."""
    async def flow():
        live, ports = await _port_pair()
        c0 = await trpc.CollectorClient.connect("127.0.0.1", ports[0])
        first = c0.boot_id
        assert await c0.call("reset") is True
        await _kill(live["s0"])
        live["s0"] = await _start(_new_server("port", 0, _cfg_kw(), None), 0, ports)
        with pytest.raises(trpc.ServerRestartedError, match="restarted while 'status'"):
            await c0.call("status")
        assert c0.boot_id == live["s0"].boot_id != first and c0.epoch == 2
        assert (await c0.call("status"))["boot_id"] == c0.boot_id  # the next call runs
        await c0.aclose()
        for s in live.values():
            await _kill(s)

    asyncio.run(asyncio.wait_for(flow(), DRILL_S))


def test_dial_policy_bounds_connect_to_a_dead_server():
    """Nothing listens: the client's own dial policy gives up, loudly."""
    async def flow():
        port = chip_smoke.free_ports()[0]
        pol = respolicy.RetryPolicy(base_s=0.01, cap_s=0.02, attempts=3)
        with pytest.raises(ConnectionError, match=f"server 127.0.0.1:{port} unreachable"):
            await trpc.CollectorClient.connect("127.0.0.1", port, dial_policy=pol)

    asyncio.run(asyncio.wait_for(flow(), DRILL_S))


def test_reset_clears_checkpoints_and_prune_orders_numerically(tmp_path):
    s = trpc.CollectorServer(0, tconfig.Config(**_cfg_kw()), "cpu", ckpt_dir=str(tmp_path))
    for lvl in (2, 9, 10, 11):
        (tmp_path / f"fhh_server0_l{lvl}.npz").write_bytes(b"x")
    (tmp_path / "fhh_server1_l1.npz").write_bytes(b"x")  # the peer's: untouched
    (tmp_path / "fhh_server0_lx.npz").write_bytes(b"x")  # not a level stamp
    assert s._ckpt_levels() == [2, 9, 10, 11]
    s._ckpt_prune(keep=2)  # a string sort would keep l9 and drop l11
    assert s._ckpt_levels() == [10, 11]
    asyncio.run(s.reset({}))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fhh_server0_lx.npz",
                                                          "fhh_server1_l1.npz"]


def _server_with_ckpt(tmp_path, level=1, keys=KEYS, **cfg):
    """A lone port server with keys, a root frontier and one checkpoint
    (checkpoint and restore never touch the data plane, so the lone
    server's counts as keyed and ``tree_init`` runs without a peer)."""
    s = trpc.CollectorServer(0, tconfig.Config(**_cfg_kw(**cfg)), "cpu",
                             ckpt_dir=str(tmp_path))
    s._plane_keyed = True

    async def go():
        await s.add_keys({"keys": tuple(keys[0])})
        await s.tree_init({})
        await s.tree_checkpoint({"level": level})

    asyncio.run(go())
    return s


def _rewrite(path, **fields):
    with np.load(path) as z:
        blob = {k: z[k] for k in z.files}
    blob.update(fields)
    with open(path, "wb") as f:
        np.savez(f, **blob)


@pytest.mark.parametrize("case", ["key_batch", "truncated", "deeper", "renamed", "radix",
                                  "collection", "clients"])
def test_tree_restore_refusals_leave_state_untouched(tmp_path, case):
    """Every refusal comes before any state changes: the live frontier, the
    client liveness and the child cache are the objects they were."""
    s = _server_with_ckpt(tmp_path, level=7 if case == "deeper" else 1)
    level = {"deeper": 7, "renamed": 3}.get(case, 1)
    want = {"key_batch": "different key batch", "truncated": "corrupt or truncated",
            "deeper": "deeper than", "renamed": "records level 1", "radix":
            "crawl_radix_bits=2", "collection": "stamped for collection 'tenant-a'",
            "clients": "client count"}[case]
    path = s._ckpt_path(1 if case != "deeper" else 7)
    if case == "key_batch":  # a server holding another batch restores the file
        s = trpc.CollectorServer(0, tconfig.Config(**_cfg_kw()), "cpu",
                                 ckpt_dir=str(tmp_path))
        asyncio.run(s.add_keys({"keys": tuple(_keys(seed=8)[0])}))
    elif case == "truncated":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    elif case == "renamed":
        os.rename(path, s._ckpt_path(3))
    elif case == "radix":
        _rewrite(path, radix=np.int64(2))
    elif case == "collection":
        _rewrite(path, sess=np.str_("tenant-a"))
    elif case == "clients":
        _rewrite(path, alive_keys=np.ones(N + 1, bool))
    before = (s.frontier, s.alive_keys, s.children)
    with pytest.raises(RuntimeError, match=want):
        asyncio.run(s.tree_restore({"level": level}))
    assert all(a is b for a, b in zip((s.frontier, s.alive_keys, s.children), before))
    assert s.stats["restores"] == 0


def test_checkpoint_blob_is_the_jax_servers(tmp_path):
    """The port's blob carries the JAX field names and stamps, its key
    fingerprint is the JAX server's ``keys_fp``, and a JAX server restores
    it (planar into its interleaved layout) to the port's frontier."""
    s = _server_with_ckpt(tmp_path, level=1)
    with np.load(s._ckpt_path(1)) as z:
        blob = {k: z[k] for k in z.files}
    assert set(blob) == {"seed", "bit", "y_bit", "alive", "alive_keys", "planar", "keys_fp",
                         "level", "sess", "radix"}
    assert bool(blob["planar"]) and str(blob["sess"]) == "default" and int(blob["radix"]) == 1
    assert blob["seed"].dtype == np.uint32 and blob["seed"].shape == (4, 1, 2, 1, N)

    async def jax_restore():
        j = jrpc.CollectorServer(0, jconfig.Config(**_cfg_kw()), ckpt_dir=str(tmp_path))
        await j.add_keys({"keys": tuple(KEYS[0]), "sketch": None})
        assert await j.tree_restore({"level": 1}) == {"level": 1}
        cs = j._default()
        np.testing.assert_array_equal(cs.keys_fp(), blob["keys_fp"])
        return {k: np.asarray(v) for k, v in cs.frontier.states._asdict().items()}

    with torch_ref.installed():
        got = asyncio.run(jax_restore())
    np.testing.assert_array_equal(got["seed"], blob["seed"].transpose(3, 4, 1, 2, 0))
    np.testing.assert_array_equal(got["bit"], blob["bit"].transpose(2, 3, 0, 1))


# -- the supervised crawl -------------------------------------------------------


def test_supervised_without_ckpt_dir_degrades_gracefully(tmp_path):
    """Servers without a checkpoint directory refuse ``tree_checkpoint``;
    the crawl turns checkpointing off and completes."""
    res, lead, fig = _drill(("port", "port"), "port", tmp_path, ckpt=False)
    assert _result(res) == _jax_fault_free(tmp_path)
    assert fig["levels"]["crawl_checkpoints"] == 0 and fig["levels"]["recoveries"] == 0


def test_supervised_without_ckpt_dir_restarts_from_scratch(tmp_path):
    """No checkpoint to stand on: server 1 killed after two rounds and
    started again, and the crawl recovers by a reset, a full upload to
    both and a re-run from level 0."""
    res, lead, fig = _drill(("port", "port"), "port", tmp_path, ckpt=False, restart_as="port",
                            kill_when=lambda lead: len(lead.buckets) >= 3)
    assert _result(res) == _jax_fault_free(tmp_path)
    assert fig["levels"]["recoveries"] >= 1 and fig["levels"]["crawl_checkpoints"] == 0
    assert fig["servers"]["s0"].stats["add_keys"] == 4  # the upload, and the one again


@pytest.mark.parametrize("mode", ["trusted", "secure"])
def test_e2e_sever_and_kill_bit_identical(tmp_path, mode):
    """The acceptance drill: server 0's answer severed mid-crawl (the replay
    is answered from its cache) and server 1 killed at the first checkpoint
    and started again; the result equals the fault-free JAX pair's and the
    in-process ``driver.Leader``'s.  Secure, the re-keyed plane runs fresh
    base-OT sessions on both sides."""
    res, lead, fig = _drill(("port", "port"), "port", tmp_path, mode=mode, sever=SEVER,
                            restart_as="port")
    want = _jax_fault_free(tmp_path, mode)
    assert _result(res) == want
    assert want[0] == _port_driver()
    assert fig["epochs"][0] >= 2 and fig["status"][0]["dedup_hits"] >= 1
    assert fig["fired"] == [("sever", "s2c", 9)]
    assert fig["levels"]["recoveries"] >= 1 and fig["levels"]["levels_rerun"] >= 1
    s1 = fig["servers"]["s1"]
    assert s1.boot_id != fig["boots"][1] and s1.stats["restores"] == 1
    assert s1.stats["add_keys"] == 2  # the restarted server's re-upload, and only its
    assert fig["servers"]["s0"].stats["add_keys"] == 2
    assert fig["servers"]["s0"].stats["plane_resets"] >= 1


def test_e2e_mid_level_span_loss_reruns_the_span(tmp_path):
    """A span verb to server 0 black-holed inside a pipelined level (node
    spans of 1, depth 2): the verb budget turns it into a timeout, the
    leader quiesces the pipeline and re-runs that level's spans on a fresh
    plane, with no rollback."""
    extra = dict(crawl_shard_nodes=1, crawl_pipeline_depth=2)
    budgets = respolicy.VerbBudgets(default_s=6.0, per_verb={})
    # c2s frame 9: hello, reset, 2 add_keys, tree_init, level 0's crawl and
    # prune, then level 1's first span
    res, lead, fig = _drill(("port", "port"), "port", tmp_path, extra=extra,
                            sever="ctl0:blackhole@msg=9,count=1", budgets=budgets)
    assert _result(res) == _jax_fault_free(tmp_path)
    assert lead.counters["pipeline_faults"] == 1 and lead.counters["shards_rerun"] >= 1
    assert lead.counters["recoveries"] == 0 and lead.counters["levels_rerun"] == 0
    assert fig["fired"] == [("blackhole", "c2s", 9)]


def test_supervised_radix2_through_kill(tmp_path):
    """``crawl_radix_bits: 2``: checkpoints bank after fused rounds and the
    crawl resumes at ``level + r``; the blob's radix stamp matches."""
    extra = dict(crawl_radix_bits=2)
    res, lead, fig = _drill(("port", "port"), "port", tmp_path, extra=extra,
                            restart_as="port")
    assert _result(res) == _jax_fault_free(tmp_path, extra=extra) == _jax_fault_free(tmp_path)
    assert fig["levels"]["recoveries"] >= 1
    with np.load(fig["servers"]["s1"]._ckpt_path(2)) as z:
        assert int(z["radix"]) == 2 and int(z["level"]) == 2


# -- mixed pairs: the hold against the reference ---------------------------------


@pytest.mark.parametrize("mode", ["trusted", "secure"])
def test_jax_leader_drives_port_pair_through_kill(tmp_path, mode):
    res, lead, fig = _drill(("port", "port"), "jax", tmp_path, mode=mode, sever=SEVER,
                            restart_as="port")
    assert _result(res) == _jax_fault_free(tmp_path, mode)
    assert lead.obs.counter_value("recoveries") >= 1
    assert fig["epochs"][0] >= 2 and fig["status"][0]["dedup_hits"] >= 1


@pytest.mark.parametrize("kinds", [("jax", "port"), ("port", "jax")],
                         ids=["jax0-port1", "port0-jax1"])
def test_port_leader_drives_mixed_pair_through_sever_and_kill(tmp_path, kinds):
    res, lead, fig = _drill(kinds, "port", tmp_path, sever=SEVER, restart_as=kinds[1])
    assert _result(res) == _jax_fault_free(tmp_path)
    assert lead.counters["recoveries"] >= 1 and fig["epochs"][0] >= 2
    assert fig["status"][0]["dedup_hits"] >= 1


@pytest.mark.parametrize("before,after,leader", [("jax", "port", "jax"),
                                                 ("port", "jax", "port")],
                         ids=["jax-blob-to-port", "port-blob-to-jax"])
def test_cross_package_restore(tmp_path, before, after, leader):
    """Server 1 killed and started again as the other package's server on
    the same checkpoint directory: the JAX server's interleaved blob into
    the port's plane-major frontier, and the port's into the JAX layout."""
    res, lead, fig = _drill((before, before), leader, tmp_path, restart_as=after)
    assert _result(res) == _jax_fault_free(tmp_path)
    assert _counter(lead, "recoveries") >= 1
    s1 = fig["servers"]["s1"]
    assert isinstance(s1, trpc.CollectorServer) == (after == "port")
    if after == "port":
        assert s1.stats["restores"] == 1
    # the level-1 blob is the killed server's, in its package's layout; the
    # level-3 one the new server's
    for level, kind in ((1, before), (3, after)):
        with np.load(tmp_path / "s1" / f"fhh_server1_l{level}.npz") as z:
            assert bool(z["planar"]) == (kind == "port")
