"""The PyTorch port's malicious sketch on the socket deployment
(``protocol/rpc.py`` ``sketch_verify``, ``protocol/leader_rpc.py``'s gates)
against the JAX package, over localhost TCP in one event loop, tolerance
zero.

Every run crawls the keys of ``tests/test_sketch.py``'s end-to-end setups
(8 clients at one point, 4 elsewhere, one client's sketch payload forged
at level 2 in both parties' copies) and must give the JAX pair's liveness
vector — the forger alone excluded — and hitters: a port pair under the
port leader and under the JAX leader, and mixed pairs (a JAX server with a
port server, in both roles, under both leaders), trusted and ot2s, d = 1
and 2, radix 2 and in node spans.  With the coin flip fixed in both
packages, the whole data-plane transcript — the share bits, and each
checked depth's cor stack and out shares — of a port or mixed pair is
byte-equal to the JAX pair's.

Ports come from the OS (``chip_smoke.free_ports``); the JAX package's
functions run inside ``torch_ref.installed()``."""

import asyncio
import secrets

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sketch as tsketch
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jconfig, jsketch, jdpf, jmpc) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.utils.config", "fuzzyheavyhitters_tpu.protocol.sketch",
    "fuzzyheavyhitters_tpu.ops.dpf", "fuzzyheavyhitters_tpu.protocol.mpc")

L, N, FORGER = 5, 12, 3
RUN_S = 240  # each run's own limit
MODES = {"trusted": {}, "ot2s": dict(secure_exchange=True, ot_path="ot2s")}
POINTS = {1: [[11]] * 8 + [[25], [2], [30], [7]],
          2: [[11, 20]] * 8 + [[25, 3], [2, 9], [30, 30], [7, 18]]}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_kw(d=1, mode="trusted", **extra):
    return dict(data_len=L, n_dims=d, ball_size=1, addkey_batch_size=5, num_sites=4,
                threshold=0.5, zipf_exponent=1.03, server0="127.0.0.1:1",
                server1="127.0.0.1:2", distribution="zipf", f_max=32, malicious=True,
                **MODES[mode], **extra)


def make_keys(d=1, forge=True, seed=5):
    """(ibDCF keys, sketch keys) of both parties in wire form, made by the
    port (byte-equal to the JAX package's, ``test_torch_sketch.py``); with
    ``forge`` client FORGER's level-2 payload is off by one in both copies."""
    rng = np.random.default_rng(seed)
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in POINTS[d]])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    seeds = rng.integers(0, 2**32, size=(N, d, 2, 4), dtype=np.uint32)
    cseed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s0, s1 = tsketch.gen(seeds, bits, tfields.FE62, tfields.F255, cseed, device="cpu")
    sk = [tsketch.sketch_to_numpy(s) for s in (s0, s1)]
    if forge:
        for leaves in sk:
            leaves[4] = leaves[4].copy()  # cw_val uint64[N, d, L-1, 2]
            leaves[4][FORGER, d - 1, 2, 0] = (int(leaves[4][FORGER, d - 1, 2, 0]) + 1) % (
                tfields.FE62.P)
    return (tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1)), sk


KEYS = {d: make_keys(d) for d in (1, 2)}


def jax_sketch(leaves):
    """Wire leaves -> the JAX package's SketchKeyBatch (of numpy arrays)."""
    return jsketch.SketchKeyBatch(jdpf.DpfKeyBatch(*leaves[:6]), *leaves[6:10],
                                  jmpc.TripleBatch(*leaves[10:13]),
                                  jmpc.TripleBatch(*leaves[13:16]))


class FixedCoin:
    """``secrets.token_bytes`` with the 16-byte draws (the coin flips, in
    trusted mode the only ones) fixed, so both packages' pairs derive one
    challenge sequence; every other draw stays random."""

    def __init__(self, monkeypatch):
        real = secrets.token_bytes
        monkeypatch.setattr(secrets, "token_bytes",
                            lambda n=None: bytes(range(16)) if n == 16 else real(n))


def _tap(server, sent):
    """Record every data-plane swap ``server`` sends, in order."""
    swap = server._swap

    async def tapped(*args):
        obj = args[-1]
        sent.append(np.asarray(obj).copy() if isinstance(obj, np.ndarray) else obj)
        return await swap(*args)

    server._swap = tapped


async def _close(clients, servers):
    for c in clients:
        await c.aclose()
    for s in servers:
        if s._peer_writer is not None:
            s._peer_writer.close()
    for s in servers:
        await asyncio.wait_for(s.aclose(), 30)


def alive_of(server) -> np.ndarray:
    a = server.alive_keys
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


async def _socket(kinds, leader, kw, keys, sketch_keys, taps=None):
    """Servers of ``kinds`` and a ``leader`` of either package run the
    unsupervised malicious crawl; -> (hitters, both servers' liveness,
    the leader)."""
    tcfg, jcfg = tconfig.Config(**kw), jconfig.Config(**kw)
    make = {"port": lambda sid: trpc.CollectorServer(sid, tcfg, "cpu"),
            "jax": lambda sid: jrpc.CollectorServer(sid, jcfg)}
    s0, s1 = make[kinds[0]](0), make[kinds[1]](1)
    if taps is not None:
        for s, sent in zip((s0, s1), taps):
            _tap(s, sent)
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
        await asyncio.gather(*(c.call("reset") for c in clients))
        if leader == "port":
            await lead.upload_keys(*keys, *sketch_keys)
        else:
            await lead.upload_keys(*(jrpc.IbDcfKeyBatch(*k) for k in keys),
                                   *(jax_sketch(s) for s in sketch_keys))
        res = await lead.run(N)
        hitters = {tuple(int(v) for v in r): int(c)
                   for r, c in zip(res.decode_ints(), res.counts)}
        return hitters, [alive_of(s0), alive_of(s1)], lead
    finally:
        await _close(clients, (s0, s1))


def run(kinds, leader, kw, keys=None, taps=None):
    keys = keys or KEYS[kw["n_dims"]]
    with torch_ref.installed():
        return asyncio.run(asyncio.wait_for(
            _socket(kinds, leader, kw, keys[0], keys[1], taps), RUN_S))


_REF = {}


def reference(kw_items):
    """The JAX pair under the JAX leader."""
    if kw_items not in _REF:
        _REF[kw_items] = run(("jax", "jax"), "jax", dict(kw_items))[:2]
    return _REF[kw_items]


def _want_alive():
    want = np.ones(N, bool)
    want[FORGER] = False
    return want


CASES = [
    # (server kinds, leader, config) — each held against the JAX pair
    (("port", "port"), "port", cfg_kw()),
    (("port", "port"), "jax", cfg_kw()),
    (("jax", "port"), "port", cfg_kw()),
    (("port", "jax"), "jax", cfg_kw()),
    (("port", "port"), "port", cfg_kw(mode="ot2s")),
    (("jax", "port"), "jax", cfg_kw(mode="ot2s")),
    (("port", "jax"), "port", cfg_kw(mode="ot2s")),
    (("port", "port"), "port", cfg_kw(d=2)),
    (("port", "jax"), "port", cfg_kw(d=2)),
    (("jax", "port"), "jax", cfg_kw(d=2, mode="ot2s")),
    (("port", "port"), "port", cfg_kw(crawl_radix_bits=2)),
    (("jax", "port"), "port", cfg_kw(crawl_radix_bits=2)),
    (("port", "jax"), "jax", cfg_kw(crawl_radix_bits=2)),
    (("port", "port"), "port", cfg_kw(crawl_shard_nodes=1)),
]


@pytest.mark.parametrize("kinds,leader,kw", CASES, ids=[
    f"{k[0]}-{k[1]}-{ld}-d{kw['n_dims']}-{'ot2s' if kw.get('secure_exchange') else 'trusted'}"
    f"-r{kw.get('crawl_radix_bits', 1)}-s{kw.get('crawl_shard_nodes', 0)}"
    for k, ld, kw in CASES])
def test_pairs_give_the_jax_pairs_liveness_and_hitters(kinds, leader, kw):
    want_hitters, want_alive = reference(tuple(sorted(kw.items())))
    for a in want_alive:
        np.testing.assert_array_equal(a, _want_alive())
    hitters, alive, lead = run(kinds, leader, kw)
    assert hitters and hitters == want_hitters
    for got, want in zip(alive, want_alive):
        np.testing.assert_array_equal(got, want)
    if leader == "port":
        np.testing.assert_array_equal(lead.alive, _want_alive())


@pytest.mark.parametrize("d,radix", [(1, 1), (2, 1), (1, 2)])
def test_data_plane_transcript_is_the_jax_pairs(monkeypatch, d, radix):
    """With the coin flip fixed, every frame each server sends on the data
    plane — the coin flip, the share bits, and every checked depth's cor
    stack and out shares — is byte-equal across the JAX pair, the port pair
    and the mixed pairs."""
    FixedCoin(monkeypatch)
    kw = cfg_kw(d=d, crawl_radix_bits=radix)
    sent = {}
    for kinds in (("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")):
        taps = ([], [])
        hitters, alive, _ = run(kinds, "port", kw, taps=taps)
        np.testing.assert_array_equal(alive[0], _want_alive())
        sent[kinds] = taps
    ref = sent[("jax", "jax")]
    sketch_frames = [f for f in ref[0] if isinstance(f, np.ndarray) and f.dtype == np.uint64]
    assert sketch_frames  # the FE62 cor/out frames of the inner depths
    for kinds, taps in sent.items():
        for sid in (0, 1):
            assert len(taps[sid]) == len(ref[sid]), (kinds, sid)
            for i, (a, b) in enumerate(zip(taps[sid], ref[sid])):
                if isinstance(b, np.ndarray):
                    assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (kinds, sid, i)
                    assert a.shape == b.shape and a.tobytes() == b.tobytes(), (kinds, sid, i)
                else:
                    assert a == b, (kinds, sid, i)
