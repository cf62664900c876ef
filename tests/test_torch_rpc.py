"""The PyTorch port's socket deployment (``protocol/rpc.py``,
``protocol/leader_rpc.py``, ``protocol/sessions.py``) against the JAX
package, over localhost TCP in one event loop, tolerance zero:

(a) the trusted exchange's mask stream and the NumPy twins it and the
    leader's reconstruction use, byte-equal to the JAX package's;
(b) a port server pair driven by the port ``RpcLeader`` and by the JAX
    ``RpcLeader`` gives the port ``driver.Leader``'s hitters on the same
    keys, trusted (d = 1, 2) and secure (ot2s, gc), sending only numpy frames;
(c) mixed pairs — a JAX ``CollectorServer`` with a port server, in both
    roles, under both leaders — give the JAX ``driver.Leader``'s hitters,
    trusted and secure, and their ``final_shares`` reconstruct them;
(d) the refusals: unported verbs, a named collection, unported options,
    and the leader's environment read with the JAX leader's defaults.

The node-span crawl is held in ``test_torch_spans.py``.

Ports come from the OS (``chip_smoke.free_ports``).  The JAX package's
functions run inside ``torch_ref.installed()`` (they import sibling modules
at call time)."""

import asyncio
import re

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.bin import leader as tleader_bin
from fuzzyheavyhitters_torch.bin import server as tserver_bin
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sessions as tsessions
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jdriver, jibdcf, jconfig, jfields, jprg) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.protocol.driver", "fuzzyheavyhitters_tpu.ops.ibdcf",
    "fuzzyheavyhitters_tpu.utils.config", "fuzzyheavyhitters_tpu.ops.fields",
    "fuzzyheavyhitters_tpu.ops.prg")

L, N = 5, 12
MODES = {"trusted": {}, "ot2s": dict(secure_exchange=True, ot_path="ot2s"),
         "gc": dict(secure_exchange=True, ot_path="gc")}
WIRE_DTYPES = {np.dtype(t) for t in (np.uint32, np.uint64, np.int32, np.int64, bool,
                                     np.uint8)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are tiny, and the suite's other
    workers share the cores (many threads each slow every test tens of times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(d, mode):
    return dict(data_len=L, n_dims=d, ball_size=1, addkey_batch_size=5, num_sites=4,
                threshold=0.3, zipf_exponent=1.03, server0="127.0.0.1:1",
                server1="127.0.0.1:2", distribution="zipf", f_max=64, **MODES[mode])


def _keys(d, seed=7):
    """Both parties' keys as the wire form: 8 clients at 11 in every dim
    (hitters 10..12 per dim with the ball of 1) and 4 random ones."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.full((N - 4, d), 11), rng.integers(0, 1 << L, size=(4, d))])
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    return tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)


def _hitters(res):
    return {tuple(int(v) for v in row): int(c) for row, c in zip(res.decode_ints(), res.counts)}


async def _close(clients, servers):
    for c in clients:
        await c.aclose()
    for s in servers:  # the data plane first: a listener waits for its transports
        if s._peer_writer is not None:
            s._peer_writer.close()
    for s in servers:
        await asyncio.wait_for(s.aclose(), 30)


async def _socket_run(kinds, leader, d, mode, keys, extra=None, seen=None):
    """Servers of ``kinds`` (server 0, server 1: "port" or "jax") and a
    ``leader`` of either package, on ``keys``, with the config fields
    ``extra`` added; returns (result, the servers' final_shares).  ``seen``
    (a dict) receives the leader and the servers."""
    tcfg = tconfig.Config(**_cfg_kw(d, mode), **(extra or {}))
    jcfg = jconfig.Config(**_cfg_kw(d, mode), **(extra or {}))
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
        if seen is not None:
            seen.update(leader=lead, servers=(s0, s1))
        await asyncio.gather(*(c.call("reset") for c in clients))
        await lead.upload_keys(*keys)
        res = await asyncio.wait_for(lead.run(N), 300)
        finals = await asyncio.gather(*(c.call("final_shares") for c in clients))
        return res, finals
    finally:
        await _close(clients, (s0, s1))


def _run(kinds, leader, d, mode, keys, extra=None, seen=None):
    with torch_ref.installed():
        return asyncio.run(_socket_run(kinds, leader, d, mode, keys, extra, seen))


_JAX_WANT = {}


def _jax_driver_hitters(d, keys):
    """The JAX package's in-process trusted driver on the same keys."""
    if d not in _JAX_WANT:
        with torch_ref.installed():
            k0, k1 = (jibdcf.IbDcfKeyBatch(*k) for k in keys)
            lead = jdriver.Leader(*jdriver.make_servers(k0, k1), n_dims=d, data_len=L,
                                  f_max=64)
            _JAX_WANT[d] = _hitters(lead.run(nreqs=N, threshold=0.3))
    return _JAX_WANT[d]


def _port_driver_hitters(d, keys):
    k0, k1 = (tibdcf.keys_from_numpy(k, "cpu") for k in keys)
    lead = tdriver.Leader(*tdriver.make_servers(k0, k1), n_dims=d, data_len=L, f_max=64)
    return _hitters(lead.run(nreqs=N, threshold=0.3))


def _wire_leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _wire_leaves(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _wire_leaves(v)
    else:
        yield obj


# -- (a) the mask stream and the NumPy twins ----------------------------------


@pytest.mark.parametrize("level", [0, 3, 15, 511])
def test_masks_match_jax(level):
    for n in (1, 7, 64):
        np.testing.assert_array_equal(tsessions.mask_fe62(level, n), jrpc.mask_fe62(level, n))
        np.testing.assert_array_equal(tsessions.mask_f255(level, n), jrpc.mask_f255(level, n))
        assert tsessions.mask_fe62(level, n).dtype == np.uint64
        assert tsessions.mask_f255(level, n).dtype == np.uint32
    F, C = 3, 4
    np.testing.assert_array_equal(tsessions.mask_rows(level, F, C, False),
                                  jrpc.mask_fe62(level, F * C).reshape(F, C))
    np.testing.assert_array_equal(tsessions.mask_rows(level, F, C, True),
                                  jrpc.mask_f255(level, F * C).reshape(F, C, 8))


def test_host_stream_matches_jax_and_device_stream():
    seed = np.array([1, 0xFFFFFFFF, 7, 0x80000000], np.uint32)
    got = tprg.np_stream_words(seed, 100)
    np.testing.assert_array_equal(got, jprg.np_stream_words(seed, 100))
    dev = tprg.stream_words(torch.from_numpy(seed.view(np.int32)), 100)
    np.testing.assert_array_equal(got, dev.numpy().view(np.uint32))
    blocks = np.random.default_rng(3).integers(0, 2**32, size=(5, 4), dtype=np.uint32)
    np.testing.assert_array_equal(tprg.np_chacha_block(blocks), jprg.np_chacha_block(blocks))
    np.testing.assert_array_equal(tprg.seeds_from_bytes(tsessions.SHARED_MASK_SEED),
                                  jprg.seeds_from_bytes(tsessions.SHARED_MASK_SEED))


def test_fe62_twins_match_jax():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(300, 4), dtype=np.uint32)
    words[:4] = 0xFFFFFFFF
    a = tfields.FE62.np_sample(words)
    np.testing.assert_array_equal(a, jfields.FE62.np_sample(words))
    b = tfields.FE62.np_sample(words[::-1])
    np.testing.assert_array_equal(tfields.FE62.np_add(a, b), jfields.FE62.np_add(a, b))
    with torch_ref.installed():
        want = np.asarray(jfields.FE62.canon(jfields.FE62.sub(a, b)))
    np.testing.assert_array_equal(tfields.FE62.np_canon(tfields.FE62.np_sub(a, b)), want)
    # and the device twins agree on the same bit patterns
    t = tfields.FE62.canon(tfields.FE62.sub(torch.from_numpy(a.view(np.int64)),
                                            torch.from_numpy(b.view(np.int64))))
    np.testing.assert_array_equal(t.numpy().view(np.uint64), want)


def test_f255_twins_match_jax():
    rng = np.random.default_rng(12)
    words = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint32)
    words[:3] = 0xFFFFFFFF
    words[3] = np.array(tfields._P255_LIMBS, np.uint32)
    a = tfields.F255.np_sample(words)
    np.testing.assert_array_equal(a, jfields.F255.np_sample(words))
    b = tfields.F255.np_sample(words[::-1])
    np.testing.assert_array_equal(tfields.F255.np_add(a, b), jfields.F255.np_add(a, b))
    with torch_ref.installed():
        want = np.asarray(jfields.F255.sub(a, b))
    np.testing.assert_array_equal(tfields.F255.np_sub(a, b), want)
    assert not tfields.F255.np_sub(a, a).any()


def test_keys_wire_form_round_trips():
    keys = _keys(2)
    for k in keys:
        assert [a.dtype for a in k] == [np.dtype(bool), np.dtype(np.uint32),
                                        np.dtype(np.uint32), np.dtype(bool), np.dtype(bool)]
        back = tibdcf.keys_to_numpy(tibdcf.keys_from_numpy(k, "cpu"))
        for x, y in zip(back, k):
            np.testing.assert_array_equal(x, y)
    assert keys[0].cw_seed.shape == (N, 2, 2, L, 4)


# -- (b) a port server pair under either leader -------------------------------


@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("d,mode", [(1, "trusted"), (2, "trusted"), (1, "ot2s"), (1, "gc"),
                                    (2, "ot2s")])
def test_port_pair_matches_port_driver(leader, d, mode, monkeypatch):
    sent = []
    real_send = trpc._send

    async def spy(writer, obj, count=None):
        sent.append(obj)
        await real_send(writer, obj, count)

    monkeypatch.setattr(trpc, "_send", spy)
    keys = _keys(d)
    res, finals = _run(("port", "port"), leader, d, mode, keys)
    got = _hitters(res)
    assert got == _port_driver_hitters(d, keys)
    assert got
    # every frame a port process sent is numpy of the JAX package's dtypes
    # and Python values
    for leaf in _wire_leaves(sent):
        assert not isinstance(leaf, torch.Tensor)
        if isinstance(leaf, np.ndarray):
            assert leaf.dtype in WIRE_DTYPES, leaf.dtype
        else:
            assert leaf is None or isinstance(leaf, (bool, int, float, str, bytes, np.generic))
    plane = [f[1] for f in sent if isinstance(f, tuple) and len(f) == 2 and f[0] == "default"]
    if mode == "trusted":  # the swapped share bits: uint32[F, N]
        bits = [p for p in plane if isinstance(p, np.ndarray)]
        assert len(bits) == 2 * L and all(p.dtype == np.uint32 and p.shape[1] == N
                                          for p in bits)
    else:  # the evaluator's u and the garbler's message, uint32 words, per level
        words = [p for p in plane if isinstance(p, np.ndarray)]
        assert len(words) == 2 * L and all(p.dtype == np.uint32 for p in words)
    shares = [np.asarray(f["shares"]) for f in finals]
    v = tfields.F255.np_sub(*shares)
    np.testing.assert_array_equal(v[:, 0], res.counts)


# -- (c) mixed JAX/port pairs ---------------------------------------------------


@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("kinds", [("jax", "port"), ("port", "jax")],
                         ids=["jax0-port1", "port0-jax1"])
@pytest.mark.parametrize("mode", ["trusted", "ot2s", "gc"])
def test_mixed_pair_matches_jax_driver(mode, kinds, leader):
    keys = _keys(1)
    res, finals = _run(kinds, leader, 1, mode, keys)
    got = _hitters(res)
    assert got == _jax_driver_hitters(1, keys)
    assert got
    v = tfields.F255.np_sub(*(np.asarray(f["shares"], np.uint32) for f in finals))
    assert not v[:, 1:].any()
    np.testing.assert_array_equal(v[:, 0], np.asarray(res.counts))


# -- (d) refusals -------------------------------------------------------------


async def _port_pair_clients(cfg):
    s0, s1 = trpc.CollectorServer(0, cfg, "cpu"), trpc.CollectorServer(1, cfg, "cpu")
    p0, p1 = chip_smoke.free_ports()
    t1 = asyncio.create_task(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    await asyncio.wait_for(
        asyncio.gather(s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1), t1), 30)
    return (s0, s1), p0, p1


@pytest.mark.parametrize("verb", sorted(trpc.UNPORTED_VERBS))
def test_unported_verbs_are_refused(verb):
    async def flow():
        servers, p0, _ = await _port_pair_clients(tconfig.Config(**_cfg_kw(1, "trusted")))
        c0 = await trpc.CollectorClient.connect("127.0.0.1", p0)
        try:
            with pytest.raises(RuntimeError, match=re.escape(
                    f"NotImplementedError: {verb}: {trpc.UNPORTED_VERBS[verb]} is not "
                    "ported to PyTorch yet")):
                await c0.call(verb, {"level": 0})
            with pytest.raises(RuntimeError, match="ValueError: unknown verb 'no_such'"):
                await c0.call("no_such")
            assert await c0.call("reset") is True  # the connection still serves
        finally:
            await _close([c0], servers)

    asyncio.run(flow())


def test_requests_of_unported_paths_are_refused():
    async def flow():
        cfg = tconfig.Config(**_cfg_kw(1, "trusted"))
        servers, p0, p1 = await _port_pair_clients(cfg)
        c = trpc.CollectorClient("127.0.0.1", p0)
        c.collection = "tenant-a"
        with pytest.raises(RuntimeError, match="hello refused.*NotImplementedError: __hello__ "
                           "for collection 'tenant-a': the multi-tenant collection layer"):
            await c._ensure_connected(0)
        await c.aclose()
        clients = [await trpc.CollectorClient.connect("127.0.0.1", p) for p in (p0, p1)]
        try:
            k0, _ = _keys(1)
            with pytest.raises(RuntimeError, match="add_keys: the malicious sketch"):
                await clients[0].call("add_keys", {"keys": tuple(k0), "sketch": [k0.key_idx]})
            with pytest.raises(RuntimeError, match="tree_crawl before tree_init"):
                await clients[0].call("tree_crawl", {"level": 0})
            k0, k1 = _keys(1)
            lead = tleader.RpcLeader(cfg, *clients)
            await lead.upload_keys(k0, k1)
            await lead._both("tree_init", {"root_bucket": 1})
            # a fused prune on a server that crawls one bit per round
            with pytest.raises(RuntimeError, match="prune pattern carries 2 step bit\\(s\\) "
                               "where this session's level-0 round fuses 1"):
                await clients[0].call("tree_prune", {
                    "level": 0, "parent_idx": np.zeros(1, np.int32),
                    "pattern_bits": np.zeros((1, 2, 1), bool), "n_alive": 1})
            # a prune with no crawl before it re-expands: the same frontier
            # as after a crawl
            prune = {"level": 0, "parent_idx": np.zeros(1, np.int32),
                     "pattern_bits": np.ones((1, 1), bool), "n_alive": 1}
            assert await clients[0].call("tree_prune", prune) is True
        finally:
            await _close(clients, servers)

    asyncio.run(flow())


@pytest.mark.parametrize("opt,path", [("server_data_devices", "several cards")])
def test_unported_options_are_refused(opt, path):
    cfg = tconfig.Config(**_cfg_kw(1, "trusted"), **{opt: 2})
    with pytest.raises(NotImplementedError, match=f"{opt}=2: .*{path}"):
        tleader.RpcLeader(cfg, None, None)
    if opt == "server_data_devices":
        with pytest.raises(NotImplementedError, match=path):
            trpc.CollectorServer(0, cfg, "cpu")


def test_wire_refuses_tensors_and_binaries_refuse_unported_modes(monkeypatch):
    with pytest.raises(TypeError, match="torch.Tensor"):
        trpc._check_wire((1, {"shares": [np.zeros(2), torch.zeros(2)]}))
    trpc._check_wire(("default", {"keys": (np.zeros(2, np.uint32), b"x", 3)}))
    for var in ("FHH_SUPERVISE", "FHH_WINDOWS", "FHH_WARMUP", "FHH_COLLECTION",
                "FHH_CKPT_EVERY"):
        monkeypatch.delenv(var, raising=False)
    # nothing set asks for the JAX leader's default, the supervised crawl: ported
    tleader_bin.refuse_unported_env()
    for val in ("1", "0"):  # supervised, and the JAX leader's own opt-out
        monkeypatch.setenv("FHH_SUPERVISE", val)
        tleader_bin.refuse_unported_env()
    for var, val in (("FHH_WINDOWS", "4"), ("FHH_COLLECTION", "tenant-a")):
        monkeypatch.setenv(var, val)
        with pytest.raises(NotImplementedError, match=f"{var}={val}: .*one bulk upload"):
            tleader_bin.refuse_unported_env()
        monkeypatch.delenv(var)
    for val in ("0", "1"):  # the warmup is ported: either value runs
        monkeypatch.setenv("FHH_WARMUP", val)
        tleader_bin.refuse_unported_env()
    tserver_bin.refuse_unported_env()
    # the server's checkpoint directory is ported
    assert "FHH_CKPT_DIR" not in tserver_bin.UNPORTED_ENV
    monkeypatch.setenv("FHH_CKPT_DIR", "ckpt")
    tserver_bin.refuse_unported_env()
    monkeypatch.delenv("FHH_CKPT_DIR")
    for var, path in tserver_bin.UNPORTED_ENV.items():
        monkeypatch.setenv(var, "x")
        with pytest.raises(NotImplementedError, match=f"{var}: {path} is not ported"):
            tserver_bin.refuse_unported_env()
        monkeypatch.delenv(var)
