"""The socket deployment of the PyTorch port at radix-2^k level fusion, and
its ``warmup`` verb, against the JAX package over localhost TCP, tolerance
zero (the harness is ``test_torch_rpc``'s):

(a) port pairs at k = 2 and 3 (d = 1, ot2s at S' = 4 and 6) and at d = 2,
    k = 2 (``ot_path: "auto"`` takes the garbled circuit at S' = 8), trusted
    and secure, give the hitters of k = 1; each server runs ceil(L/k) crawl
    verbs;
(b) mixed JAX/port pairs in both roles at k = 2, trusted and secure, give
    the JAX driver's hitters: the ``[F', r, d]`` prune and the ``(level //
    k) % 2`` garbler cross the package boundary;
(c) a node-span crawl at k = 2;
(d) a prune of the wrong radix is refused; a prune with no crawl before it
    re-expands its round;
(e) ``warmup`` answers the port and the JAX ``RpcLeader``, trusted and
    secure, at k = 1 and 2, and the crawl after it gives the same hitters."""

import asyncio

import numpy as np
import pytest
import torch

import test_torch_rpc as rpct
import torch_ref
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import config as tconfig

L, N = rpct.L, rpct.N
SECURE = {"ot2s": dict(secure_exchange=True, ot_path="ot2s"),
          "auto": dict(secure_exchange=True, ot_path="auto")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(kinds, leader, d, k, secure=None, extra=None, seen=None):
    """A crawl at radix ``k`` (``secure``: a key of SECURE, or None)."""
    cfg = dict(SECURE.get(secure, {}), crawl_radix_bits=k, **(extra or {}))
    return rpct._run(kinds, leader, d, "trusted", rpct._keys(d), cfg, seen)


# -- (a) port pairs -----------------------------------------------------------------


@pytest.mark.parametrize("d,k,secure", [(1, 2, None), (1, 2, "ot2s"), (1, 3, None),
                                        (1, 3, "ot2s"), (2, 2, None), (2, 2, "auto")])
def test_port_pair_at_radix_matches_radix1(d, k, secure, monkeypatch):
    paths = []
    real = {name: getattr(tsecure, name) for name in ("ot2s_encrypt_packed",
                                                      "ot2s_decrypt_packed")}
    for name, fn in real.items():  # which engine each fused level took
        monkeypatch.setattr(tsecure, name, lambda *a, _fn=fn, _n=name: (paths.append(_n),
                                                                        _fn(*a))[1])
    garbles = []
    real_gc = tsecure.gc.garble_equality_payload_packed
    monkeypatch.setattr(tsecure.gc, "garble_equality_payload_packed",
                        lambda *a: (garbles.append(a[3].shape[1]), real_gc(*a))[1])
    seen = {}
    res, finals = _run(("port", "port"), "port", d, k, secure, seen=seen)
    got = rpct._hitters(res)
    assert got and got == rpct._port_driver_hitters(d, rpct._keys(d))
    rounds = -(-L // k)
    for s in seen["servers"]:
        assert s.stats["levels"] == rounds
    assert len(seen["leader"].buckets) == rounds
    v = rpct.tfields.F255.np_sub(*(np.asarray(f["shares"], np.uint32) for f in finals))
    np.testing.assert_array_equal(v[:, 0], np.asarray(res.counts))
    if secure:  # S' = 2·d·r: the garbled circuit past OT2S_MAX_S on the auto path
        widths = [2 * d * min(k, L - lv) for lv in range(0, L, k)]
        gc_widths = [S for S in widths if secure == "auto" and S > tsecure.OT2S_MAX_S]
        assert garbles == gc_widths and len(paths) == 2 * (len(widths) - len(gc_widths))
        assert gc_widths or secure == "ot2s"


# -- (b) mixed pairs ----------------------------------------------------------------


@pytest.mark.parametrize("kinds,leader", [(("jax", "port"), "port"), (("port", "jax"), "jax")],
                         ids=["jax0-port1-portleader", "port0-jax1-jaxleader"])
@pytest.mark.parametrize("secure", [None, "ot2s"])
def test_mixed_pair_at_radix2_matches_jax_driver(kinds, leader, secure):
    seen = {}
    res, finals = _run(kinds, leader, 1, 2, secure, seen=seen)
    got = rpct._hitters(res)
    assert got and got == rpct._jax_driver_hitters(1, rpct._keys(1))
    port = seen["servers"][kinds.index("port")]
    assert port.stats["levels"] == -(-L // 2)
    v = rpct.tfields.F255.np_sub(*(np.asarray(f["shares"], np.uint32) for f in finals))
    assert not v[:, 1:].any()
    np.testing.assert_array_equal(v[:, 0], np.asarray(res.counts))


def test_garbler_flips_per_round(monkeypatch):
    """Bases 0, 2, 4 at k = 2: the garbler is 0, 1, 0 (``level % 2`` would
    pin server 0)."""
    sent = []
    real = tleader.RpcLeader._both

    async def spy(self, verb, req=None):
        if verb.startswith("tree_crawl"):
            sent.append((req["level"], req["garbler"]))
        return await real(self, verb, req)

    monkeypatch.setattr(tleader.RpcLeader, "_both", spy)
    res, _ = _run(("port", "port"), "port", 1, 2, "ot2s")
    assert rpct._hitters(res)
    assert sent == [(0, 0), (2, 1), (4, 0)]


# -- (c) node spans -------------------------------------------------------------------


@pytest.mark.parametrize("kinds,secure", [(("port", "port"), None), (("port", "port"), "ot2s"),
                                          (("jax", "port"), None)],
                         ids=["port-trusted", "port-ot2s", "jax0-port1-trusted"])
def test_span_crawl_at_radix2(kinds, secure):
    spans = dict(crawl_shard_nodes=1, crawl_pipeline_depth=2, secure_whole_level=False)
    seen = {}
    res, _ = _run(kinds, "port", 1, 2, secure, spans, seen)
    got = rpct._hitters(res)
    assert got and got == rpct._jax_driver_hitters(1, rpct._keys(1))
    lead = seen["leader"]
    assert max(lead.buckets) > 1  # a round ran in several spans
    port = seen["servers"][kinds.index("port")]
    assert port.stats["levels"] == sum(lead.buckets)


# -- (d) the prune's radix ----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_prune_radix_mismatch_is_refused_and_uncached_prune_reexpands(k):
    async def flow():
        cfg = tconfig.Config(**rpct._cfg_kw(1, "trusted"), crawl_radix_bits=k)
        servers, p0, p1 = await rpct._port_pair_clients(cfg)
        clients = [await trpc.CollectorClient.connect("127.0.0.1", p) for p in (p0, p1)]
        try:
            lead = tleader.RpcLeader(cfg, *clients)
            await lead.upload_keys(*rpct._keys(1))
            await lead._both("tree_init", {"root_bucket": 1})
            wrong = 2 if k == 1 else 1
            bad = {"level": 0, "parent_idx": np.zeros(1, np.int32),
                   "pattern_bits": np.zeros((1, wrong, 1), bool), "n_alive": 1}
            with pytest.raises(RuntimeError, match=f"prune pattern carries {wrong} step bit\\(s\\) "
                               f"where this session's level-0 round fuses {k}"):
                await clients[0].call("tree_prune", bad)
            wrong = 2 if k == 1 else 3  # L = 5: the tail round of k = 2 is 1 level
            servers[0].last_shares = np.zeros((1, 1 << wrong, 8), np.uint32)
            with pytest.raises(RuntimeError, match=f"leaf prune pattern carries {wrong} step "
                               f"bit\\(s\\) where this session's tail round fuses {min(k, 2)}"):
                await clients[0].call("tree_prune_last", dict(
                    bad, pattern_bits=np.zeros((1, wrong, 1), bool)))
            # both servers crawl round 0; server 1 then prunes with no cache,
            # so it re-expands the round: the frontier its cache would give
            s1 = servers[1]
            crawl = {"level": 0, "garbler": 0, "ot_path": "auto"}
            await lead._both("tree_crawl", crawl)
            cached, s1.children = s1.children, None
            parent = np.array([0, 0], np.int32)
            pat = np.array([[[1]] * k, [[0]] * k], bool).reshape(2, k, 1)
            await lead._both("tree_prune", {"level": 0, "parent_idx": parent,
                                            "pattern_bits": pat, "n_alive": 2})
            want = tcollect.advance_from_children_radix(
                cached, torch.from_numpy(parent.astype(np.int64)), torch.from_numpy(pat), 2, k)
            for a, b in zip(s1.frontier.states, want.states):
                assert torch.equal(a, b)
        finally:
            await rpct._close(clients, servers)

    asyncio.run(flow())


# -- (e) warmup -------------------------------------------------------------------------


@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("secure", [None, "auto"])
@pytest.mark.parametrize("k", [1, 2])
def test_warmup_answers_both_leaders(leader, secure, k):
    async def flow():
        kw = dict(rpct._cfg_kw(1, "trusted"), **SECURE.get(secure, {}), crawl_radix_bits=k,
                  f_max=8)
        tcfg, jcfg = tconfig.Config(**kw), rpct.jconfig.Config(**kw)
        servers, p0, p1 = await rpct._port_pair_clients(tcfg)
        rpc, lrpc, cfg = ((trpc, tleader, tcfg) if leader == "port"
                          else (rpct.jrpc, rpct.jleader, jcfg))
        clients = []
        try:
            for p in (p0, p1):
                clients.append(await rpc.CollectorClient.connect("127.0.0.1", p))
            lead = lrpc.RpcLeader(cfg, *clients)
            await asyncio.gather(*(c.call("reset") for c in clients))
            await lead.upload_keys(*rpct._keys(1))
            frontiers = [s.frontier for s in servers]
            info = await lead.warmup()
            assert info["f_buckets"] == [1, 2, 4, 8]
            for r in (info["s0"], info["s1"]):
                assert r == {"shapes": 4, "ladder_hits": 0}
            # no live state moved: no frontier, no OT session, no crawl verb
            assert [s.frontier for s in servers] == frontiers == [None, None]
            for s in servers:
                assert s.stats["levels"] == 0 and s.stats["data_bytes_sent"] == 0
                assert s._ot_snd is None and not s._plane_keyed
            res = await asyncio.wait_for(lead.run(N), 300)
            return rpct._hitters(res)
        finally:
            await rpct._close(clients, servers)

    with torch_ref.installed():
        got = asyncio.run(flow())
    assert got and got == rpct._port_driver_hitters(1, rpct._keys(1))
