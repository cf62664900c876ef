"""The node-span socket crawl of the PyTorch port (``collect.shard_spans``/
``frontier_slice``/``children_cat``, the span verbs of ``protocol/rpc.py``
and the span loop of ``protocol/leader_rpc.py``) against the JAX package,
tolerance zero:

(a) the span helpers equal the JAX package's and round-trip;
(b) mixed pairs — a JAX ``CollectorServer`` with a port server, in both
    roles, under both leaders — crawl in spans of one node, trusted, ot2s
    and GC (``secure_whole_level: false``), at ``crawl_pipeline_depth`` 1 and
    3, and give the JAX driver's hitters; a port pair gives the port
    driver's, with the leader's pipeline figures and smaller frames;
(c) a torn level (a span missing at the prune) raises.

The harness is ``test_torch_rpc``'s (ports from ``chip_smoke.free_ports``)."""

import asyncio

import numpy as np
import pytest
import torch

import test_torch_rpc as rpct
import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.utils import config as tconfig

jcollect, jibdcf = torch_ref.reference("fuzzyheavyhitters_tpu.protocol.collect",
                                       "fuzzyheavyhitters_tpu.ops.ibdcf")

SPANS = {"crawl_shard_nodes": 1, "secure_whole_level": False}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the span helpers -----------------------------------------------------


@pytest.mark.parametrize("f_bucket,nodes", [(1, 0), (1, 4), (8, 0), (8, 3), (8, 8), (16, 4),
                                            (32, 5), (4, 1)])
def test_shard_spans_match_jax(f_bucket, nodes):
    got = tcollect.shard_spans(f_bucket, nodes)
    assert got == jcollect.shard_spans(f_bucket, nodes)
    assert got[0][0] == 0 and got[-1][1] == f_bucket
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def _frontier(d, F, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    st = tibdcf.EvalState(
        seed=torch.randint(-2**31, 2**31, (4, d, 2, F, N), dtype=torch.int32, generator=g),
        bit=torch.randint(0, 2, (d, 2, F, N), generator=g).bool(),
        y_bit=torch.randint(0, 2, (d, 2, F, N), generator=g).bool())
    return tcollect.Frontier(states=st, alive=torch.arange(F) < F - 1)


@pytest.mark.parametrize("d", [1, 2])
def test_frontier_slice_and_children_cat_round_trip(d):
    F, N = 8, 5
    fr = _frontier(d, F, N)
    cw = tuple(a[0] for a in tibdcf.cw_level_major(tibdcf.gen_l_inf_ball(
        np.zeros((N, d, 4), bool), 1, np.random.default_rng(1), device="cpu")[0], 2, 3))
    _, whole = tcollect.expand_share_bits_from_cw(cw, fr)
    spans = tcollect.shard_spans(F, 3)
    parts = []
    for lo, hi in reversed(spans):  # any order
        view = tcollect.frontier_slice(fr, lo, hi)
        jview = jcollect.frontier_slice(
            jcollect.Frontier(states=jibdcf.EvalState(*(a.numpy() for a in fr.states)),
                              alive=fr.alive.numpy()), lo, hi, planar=True)
        for a, b in zip(view.states, jview.states):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(view.alive.numpy(), np.asarray(jview.alive))
        parts.append((lo, tcollect.expand_share_bits_from_cw(cw, view)[1]))
    cat = tcollect.children_cat(parts)
    assert torch.equal(cat.seed, whole.seed) and torch.equal(cat.flags, whole.flags)


# -- (b) span crawls over sockets ----------------------------------------------


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("kinds", [("jax", "port"), ("port", "jax")],
                         ids=["jax0-port1", "port0-jax1"])
@pytest.mark.parametrize("mode", ["trusted", "ot2s", "gc"])
def test_mixed_span_pair_matches_jax_driver(mode, kinds, leader, depth):
    keys = rpct._keys(1)
    res, finals = rpct._run(kinds, leader, 1, mode, keys,
                            dict(SPANS, crawl_pipeline_depth=depth))
    got = rpct._hitters(res)
    assert got and got == rpct._jax_driver_hitters(1, keys)
    v = rpct.tfields.F255.np_sub(*(np.asarray(f["shares"], np.uint32) for f in finals))
    assert not v[:, 1:].any()
    np.testing.assert_array_equal(v[:, 0], np.asarray(res.counts))


@pytest.mark.parametrize("d,mode", [(2, "trusted"), (1, "ot2s")])
def test_port_span_pair_matches_port_driver(d, mode):
    keys = rpct._keys(d)
    seen_w = {}
    res_w, _ = rpct._run(("port", "port"), "port", d, mode, keys, None, seen_w)
    seen = {}
    res, _ = rpct._run(("port", "port"), "port", d, mode, keys,
                       dict(SPANS, crawl_pipeline_depth=3), seen)
    got = rpct._hitters(res)
    assert got and got == rpct._hitters(res_w) == rpct._port_driver_hitters(d, keys)
    lead = seen["leader"]
    assert max(lead.buckets) > 1  # some level ran in spans
    assert lead.pipeline["depth"] == min(3, max(lead.buckets))
    assert lead.pipeline["overlap_s"] >= 0.0 and lead.pipeline["stalls"] >= 0
    for s, w in zip(seen["servers"], seen_w["servers"]):
        # one verb per span: more crawl verbs, the largest frame no larger
        assert s.summary()["levels"] == sum(lead.buckets) > w.summary()["levels"]
        assert s.summary()["data_frame_max"] <= w.summary()["data_frame_max"]


# -- (c) a torn level -----------------------------------------------------------


@pytest.mark.parametrize("last", [False, True], ids=["inner", "last"])
def test_torn_level_raises(last):
    L = rpct.L

    async def flow():
        cfg = tconfig.Config(**rpct._cfg_kw(1, "trusted"), **SPANS)
        servers, p0, p1 = await rpct._port_pair_clients(cfg)
        clients = [await trpc.CollectorClient.connect("127.0.0.1", p) for p in (p0, p1)]
        try:
            lead = tleader.RpcLeader(cfg, *clients)
            await lead.upload_keys(*rpct._keys(1))
            await lead._both("tree_init", {"root_bucket": 1})
            lead.paths, lead.n_nodes, lead.buckets = np.zeros((1, 1, 0), bool), 1, [1]
            thresh = max(1, int(cfg.threshold * rpct.N))
            level = 0  # crawl on until a level of several spans (the last one)
            while lead.buckets[-1] < 2 or (last and level < L - 1):
                kept, _ = await lead._run_one_level(level, rpct.N, thresh)
                assert kept is not None
                level += 1
            verb = "tree_crawl_last" if level == L - 1 else "tree_crawl"
            spans = tcollect.shard_spans(lead.buckets[-1], 1)
            req = {"level": level, "garbler": 0, "ot_path": "auto"}
            for span in spans[:-1]:  # the last span never runs
                await lead._both(verb, dict(req, shard=list(span)))
            F = lead.buckets[-1]
            prune = {"parent_idx": np.zeros(F, np.int32), "pattern_bits": np.zeros((F, 1), bool),
                     "n_alive": 1}
            if verb == "tree_crawl_last":
                with pytest.raises(RuntimeError, match=f"sharded last crawl incomplete: shares "
                                   f"cover {F - 1} of {F} slots"):
                    await clients[0].call("tree_prune_last", prune)
            else:
                with pytest.raises(RuntimeError, match=f"sharded crawl incomplete: child "
                                   f"caches cover {F - 1} of {F} frontier slots"):
                    await clients[0].call("tree_prune", dict(prune, level=level))
        finally:
            await rpct._close(clients, servers)

    asyncio.run(flow())

