"""The collector fleet's end-to-end flows, shared by
``test_torch_fleet_rpc.py`` and ``test_torch_fleet_secure.py``: a windowed
collection moved between two server pairs in one event loop on the CPU,
either package's servers on each side and either package's leader driving
(the JAX test_fleet.py shapes: L = 5, d = 1, N = 12, one key a submission).

A pair's two servers share one checkpoint directory with the other pair's
(server i of either pair writes ``fhh_server{i}_l...``), as a fleet's shared
store does; the destination pair is never reset, since a reset clears the
namespace the transfer is about to import from.  Ports come from the OS
(``chip_smoke.free_ports``); every flow runs under its own
``asyncio.wait_for``.  A killed pair is its servers closed in process, the
stand-in for a host's death."""

import asyncio
import os

import numpy as np

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import fleet as tfleet
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sketch as tsketch
from fuzzyheavyhitters_torch.resilience.chaos import HostChaos, parse_host_faults
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jconfig, jfleet) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.utils.config", "fuzzyheavyhitters_tpu.protocol.fleet")

L, N, FORGER = 5, 12, 3
FLOW_S = 240
PROBE_S = 2.0  # a probe's whole budget: a dead pair must not wait for TCP keepalive
MODES = {"trusted": {}, "ot2s": dict(secure_exchange=True, ot_path="ot2s"),
         "malicious": dict(malicious=True, threshold=0.5, addkey_batch_size=12)}
# two windows of six clients, each with a cluster at 11; malicious: one
# window of all twelve (the JAX test's), client FORGER's sketch forged
POINTS = [[11]] * 4 + [[25], [2]] + [[11]] * 4 + [[30], [7]]
# (window 0, window 1 before the move, window 1 after it, windows crawled):
# two windows of six, or one window of all twelve with three more in flight
PLANS = {"two": (range(0, 6), range(6, 9), range(9, 12), (0, 1)),
         "one": (range(0, 12), range(0, 3), (), (0,))}


def cfg_kw(mode="trusted", **extra):
    return dict(dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=8, num_sites=4,
                     threshold=0.2, zipf_exponent=1.03, server0="127.0.0.1:1",
                     server1="127.0.0.1:2", distribution="zipf", f_max=32),
                **MODES[mode], **extra)


def _make_keys():
    """Both parties' ibDCF keys and sketch keys in wire form, made by the
    port from a seed; the sketch of client FORGER off by one at level 2."""
    rng = np.random.default_rng(13)
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in POINTS])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    seeds = rng.integers(0, 2**32, size=(N, 1, 2, 4), dtype=np.uint32)
    cseed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    sk = [tsketch.sketch_to_numpy(s) for s in tsketch.gen(seeds, bits, tfields.FE62,
                                                         tfields.F255, cseed, device="cpu")]
    for leaves in sk:
        leaves[4] = leaves[4].copy()  # cw_val uint64[N, d, L-1, 2]
        leaves[4][FORGER, 0, 2, 0] = (int(leaves[4][FORGER, 0, 2, 0]) + 1) % tfields.FE62.P
    return (tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)), sk


KEYS, SKETCH = _make_keys()


def chunk(which, i):
    return tuple(leaf[i:i + 1] for leaf in KEYS[which])


def sk_chunk(which, i):
    return [leaf[i:i + 1] for leaf in SKETCH[which]]


def result(res):
    hitters = {tuple(int(v) for v in r): int(c) for r, c in zip(res.decode_ints(), res.counts)}
    return hitters, np.asarray(res.paths).tolist(), np.asarray(res.counts).tolist()


def new_server(kind, sid, kw, ckpt_dir):
    if kind == "port":
        return trpc.CollectorServer(sid, tconfig.Config(**kw), "cpu", ckpt_dir=ckpt_dir)
    return jrpc.CollectorServer(sid, jconfig.Config(**kw), ckpt_dir=ckpt_dir)


def boot_id(server) -> str:
    return server.boot_id if isinstance(server, trpc.CollectorServer) else server._boot_id


def pools(server, key="default") -> dict:
    cs = server._table.peek(key)
    return {} if cs is None else cs._ingest_pools


def stat(server, name, key="default") -> int:
    cs = server._table.peek(key)
    if isinstance(server, trpc.CollectorServer):
        return cs.stats[name]
    return int(cs.obs.counter_value(name))


async def start_pair(kinds, kw, ckpt_dir):
    """Two servers of ``kinds`` on fresh ports, both on ``ckpt_dir``.
    -> ({"s0", "s1"}, (port0, port1))."""
    p0, p1 = chip_smoke.free_ports()
    s1 = new_server(kinds[1], 1, kw, ckpt_dir)
    t1 = asyncio.ensure_future(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    s0 = new_server(kinds[0], 0, kw, ckpt_dir)
    await s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1)
    await asyncio.wait_for(t1, 60)
    return {"s0": s0, "s1": s1}, (p0, p1)


async def kill(server):
    """Close a server as a dead host's: its transports first (a listener's
    close waits for them)."""
    for w in list(server._ctl_writers):
        w.close()
    if server._peer_writer is not None:
        server._peer_writer.close()
    await asyncio.wait_for(server.aclose(), 30)


class Pkg:
    """One package's leader side: its client, leader, ingest driver and
    fleet classes."""

    def __init__(self, leader):
        self.rpc, self.lrpc, self.cfg, self.fleet = (
            (trpc, tleader, tconfig, tfleet) if leader == "port"
            else (jrpc, jleader, jconfig, jfleet))

    async def lead(self, kw, ports, collection=None, reset=True):
        extra = {} if collection is None else {"collection": collection}
        c0 = await self.rpc.CollectorClient.connect("127.0.0.1", ports[0], **extra)
        c1 = await self.rpc.CollectorClient.connect("127.0.0.1", ports[1], **extra)
        lead = self.lrpc.RpcLeader(self.cfg.Config(**kw), c0, c1)
        if reset:
            await lead._both("reset")
        return lead

    def counter(self, wi, name) -> int:
        if isinstance(wi, tleader.WindowedIngest):
            return wi.counters[name]
        return int(wi.obs.counter_value(name))


async def submit(wi, ids, malicious):
    for i in ids:
        sk = ({"sk0_chunk": sk_chunk(0, i), "sk1_chunk": sk_chunk(1, i)} if malicious
              else {})
        await wi.submit(f"c{i}", chunk(0, i), chunk(1, i), **sk)


async def _move_flow(tmp, kinds_a, kinds_b, leader, kw, plan, move, collection=None,
                     neighbour=None):
    """Window 0 submitted and sealed on pair A, window 1's first part
    submitted there, the collection moved to pair B (``move``: "migrate",
    or "failover" after a ``host:kill`` clause kills A), window 1's rest
    submitted to B, then the windows of ``plan`` crawled on B.  With
    ``collection`` the moved collection is that named one, and
    ``neighbour`` another named collection whose windowed crawl runs on A
    alongside the move.  -> (results by window, figures)."""
    w0, w1a, w1b, crawl = plan
    malicious = bool(kw.get("malicious"))
    ck = str(tmp / "ck")
    os.makedirs(ck, exist_ok=True)
    pkg = Pkg(leader)
    live_a, ports_a = await start_pair(kinds_a, kw, ck)
    live_b, ports_b = await start_pair(kinds_b, kw, ck)
    leads, fig, results = [], {}, {}
    key = collection or "default"
    try:
        lead_a = await pkg.lead(kw, ports_a, collection)
        leads.append(lead_a)
        directory = pkg.fleet.FleetDirectory()
        pairs = {}
        for name, live, ports in (("A", live_a, ports_a), ("B", live_b, ports_b)):
            pairs[name] = pkg.fleet.HostPair(
                name=name, host0="127.0.0.1", port0=ports[0], host1="127.0.0.1",
                port1=ports[1], boot0=boot_id(live["s0"]), boot1=boot_id(live["s1"]))
            await directory.register(pairs[name])
        placer = pkg.fleet.FleetPlacer(directory)
        fig["placed"] = (await placer.place(key)).name
        wi = pkg.lrpc.WindowedIngest(lead_a)
        side = None
        if neighbour is not None:  # a second collection crawling on A meanwhile
            lead_n = await pkg.lead(kw, ports_a, neighbour)
            leads.append(lead_n)
            wn = pkg.lrpc.WindowedIngest(lead_n, checkpoint=False)
            await submit(wn, range(N), malicious)
            await wn.seal_window()
            side = asyncio.ensure_future(wn.crawl_window(0))
        await submit(wi, w0, malicious)
        fig["seal0"] = await wi.seal_window()
        await submit(wi, w1a, malicious)
        if move == "migrate":
            lead_b = await pkg.lead(kw, ports_b, collection, reset=False)
            leads.append(lead_b)
            fig["stats"] = await placer.migrate(wi, lead_b, session=key, dest="B")
            fig["src_status"] = [await c.call("status") for c in (lead_a.c0, lead_a.c1)]
        else:
            hc = HostChaos(parse_host_faults("host:kill@window=0"))
            if hc.before_window(0):
                for s in live_a.values():
                    await kill(s)
            fig["fired"] = list(hc.fired)
            fig["died"] = await directory.probe(tfleet.status_probe(pairs, PROBE_S))

            async def make_ingest(session, dest):
                assert session == key and dest.name == "B"
                lead_b = await pkg.lead(kw, dest_ports[dest.name], collection, reset=False)
                leads.append(lead_b)
                return wi, lead_b

            dest_ports = {"B": ports_b}
            fig["stats"] = (await placer.recover_dead_pair("A", make_ingest))[key]
        await submit(wi, w1b, malicious)
        results[0] = result(await wi.crawl_window(0))
        if 1 in crawl:
            await wi.seal_window()
            results[1] = result(await wi.crawl_window(1))
        if side is not None:
            fig["neighbour"] = result(await side)
            fig["neighbour_pools"] = [sorted(pools(s, neighbour)) for s in live_a.values()]
        fig["dest_status"] = [await c.call("status") for c in (wi.lead.c0, wi.lead.c1)]
        fig["dup_submits"] = [stat(s, "pool_dup_submits", key) for s in live_b.values()]
        fig["src_pools"] = [dict(pools(s, key)) for s in live_a.values()]
        fig["replays"] = pkg.counter(wi, "ingest_journal_replays")
        fig["placer"] = placer.status()
        fig["directory"] = await directory.status()
        if malicious:
            fig["roots"] = [np.asarray(s._table.peek(key)._sketch_root).tolist()
                            for s in live_b.values()]
            fig["alive"] = [np.asarray(s._table.peek(key).alive_keys).tolist()
                            for s in live_b.values()]
        return results, fig
    finally:
        for lead in leads:
            for c in (lead.c0, lead.c1):
                await c.aclose()
        for live in (live_a, live_b):
            for s in live.values():
                if move == "migrate" or live is live_b:
                    await kill(s)


async def _control_flow(tmp, kw, plan, collection=None):
    """The never-migrated run: the same submissions and seals on one port
    pair under the port leader."""
    w0, w1a, w1b, crawl = plan
    malicious = bool(kw.get("malicious"))
    live, ports = await start_pair(("port", "port"), kw, None)
    pkg = Pkg("port")
    lead = await pkg.lead(kw, ports, collection)
    try:
        wi = tleader.WindowedIngest(lead, checkpoint=False)
        await submit(wi, w0, malicious)
        await wi.seal_window()
        await submit(wi, list(w1a) + list(w1b), malicious)
        out = {0: result(await wi.crawl_window(0))}
        if 1 in crawl:
            await wi.seal_window()
            out[1] = result(await wi.crawl_window(1))
        return out
    finally:
        for c in (lead.c0, lead.c1):
            await c.aclose()
        for s in live.values():
            await kill(s)


def run(coro):
    with torch_ref.installed():
        return asyncio.run(asyncio.wait_for(coro, FLOW_S))


def move_flow(tmp, kinds_a, kinds_b, leader, kw, plan, move, **extra):
    return run(_move_flow(tmp, kinds_a, kinds_b, leader, kw, plan, move, **extra))


_CONTROL = {}


def control(kw, plan_name, collection=None):
    """The never-migrated run's results, once per config and plan."""
    key = (tuple(sorted(kw.items())), plan_name, collection)
    if key not in _CONTROL:
        import pathlib
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            _CONTROL[key] = run(_control_flow(pathlib.Path(d), kw, PLANS[plan_name],
                                              collection))
    return _CONTROL[key]
