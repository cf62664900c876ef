"""The PyTorch port's collector servers with data shards (``Config.
server_data_devices`` > 1: ``parallel/server_mesh.py``, ``kernel_shard.py``,
``sketch_shard.py`` under ``protocol/rpc.py``) on the socket deployment,
in one event loop, against unsharded port servers and the JAX package's
sharded servers (its meshes on the conftest's virtual CPU devices),
tolerance zero:

- port pairs at k = 2 and 4 give the hitters of the unsharded pair and of
  the JAX pair at k = 4, trusted, ot2s, GC, radix 2 and with the sketch
  (a forger excluded), and with the coin flip and the base-OT randomness
  fixed every frame either server sends on the data plane is byte-equal
  across all of them;
- mixed pairs, a JAX sharded server with a port sharded one, in both roles;
- a level batch of several planar blocks runs the row-sharded kernel stage
  (``kernel_shards_max`` 2) on the same wire; ``secure_kernel_shards: 1``
  pins the gather path (``kernel_gathers`` a level);
- a device killed at a crawl verb re-shards inside the verb from the
  checkpoint before it (``levels_rerun`` 0, no leader recovery); without
  that checkpoint it escalates: the unsupervised leader raises, the
  supervised one recovers and classifies the loss (``device_loss`` [1]);
- a sharded server's checkpoint blob is the unsharded one's and restores
  under either package, sharded or not;
- a leader whose ``data_shards`` differs from the server's gets
  ``warmup.shard_mismatch``.

Ports come from the OS (``chip_smoke.free_ports``); the JAX package's
functions run inside ``torch_ref.installed()``."""

import asyncio
import os
import random
import secrets

import numpy as np
import pytest
import torch

import chip_smoke
import fuzzyheavyhitters_tpu.ops.fields  # noqa: F401  (one fields module under every torch_ref
# load, whatever other files a worker collects: the JAX functions compare field classes by
# identity, and tests/test_fields.py imports it so in a whole run)
import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import leader_rpc as tleader
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sketch as tsketch
from fuzzyheavyhitters_torch.resilience.chaos import MeshChaos, parse_mesh_faults
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jleader, jconfig, jsketch, jdpf, jmpc) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.leader_rpc",
    "fuzzyheavyhitters_tpu.utils.config", "fuzzyheavyhitters_tpu.protocol.sketch",
    "fuzzyheavyhitters_tpu.ops.dpf", "fuzzyheavyhitters_tpu.protocol.mpc")

L, N, FORGER = 5, 12, 3
RUN_S = 240
MODES = {"trusted": {}, "ot2s": dict(secure_exchange=True, ot_path="ot2s"),
         "gc": dict(secure_exchange=True, ot_path="gc"), "radix2": dict(crawl_radix_bits=2),
         "sketch": dict(malicious=True)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_kw(mode="trusted", **extra):
    return dict(data_len=L, n_dims=1, ball_size=1, addkey_batch_size=5, num_sites=4,
                threshold=0.3, zipf_exponent=1.03, server0="127.0.0.1:1",
                server1="127.0.0.1:2", distribution="zipf", f_max=8, **MODES[mode],
                **extra)


def make_keys(n=N, data_len=L, seed=7, sketch=False):
    """Both parties' ibDCF keys in wire form (and, with ``sketch``, their
    sketch keys, client FORGER's level-2 payload off by one): most clients
    at 11, the rest random."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.full((n - n // 3, 1), 11),
                          rng.integers(0, 1 << data_len, size=(n // 3, 1))])
    bits = np.array([[tbits.int_to_bits(data_len, int(v)) for v in row] for row in pts])
    k0, k1 = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    keys = (tibdcf.keys_to_numpy(k0), tibdcf.keys_to_numpy(k1))
    if not sketch:
        return keys, None
    seeds = rng.integers(0, 2**32, size=(n, 1, 2, 4), dtype=np.uint32)
    cseed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    sk = [tsketch.sketch_to_numpy(s) for s in tsketch.gen(seeds, bits, tfields.FE62,
                                                           tfields.F255, cseed, device="cpu")]
    for leaves in sk:
        leaves[4] = leaves[4].copy()
        leaves[4][FORGER, 0, 2, 0] = (int(leaves[4][FORGER, 0, 2, 0]) + 1) % tfields.FE62.P
    return keys, sk


KEYS = make_keys()
SKETCH_KEYS = make_keys(sketch=True)


def fix_randomness(monkeypatch):
    """The coin flips and GC/b2a seeds (16-byte draws) and every base-OT
    and OT-extension choice (``secrets.SystemRandom``) fixed in both
    packages, so two runs send the same data-plane bytes."""
    real = secrets.token_bytes
    monkeypatch.setattr(secrets, "token_bytes",
                        lambda n=None: bytes(range(16)) if n == 16 else real(n))
    monkeypatch.setattr(secrets, "SystemRandom", lambda: random.Random(1234))


def _tap(server, sent):
    """Record every data-plane frame ``server`` sends, in order."""
    send = server._dp_send

    async def tapped(*args):
        obj = args[-1]
        sent.append(np.asarray(obj).copy() if isinstance(obj, np.ndarray) else obj)
        return await send(*args)

    server._dp_send = tapped


def _jax_sketch(leaves):
    return jsketch.SketchKeyBatch(jdpf.DpfKeyBatch(*leaves[:6]), *leaves[6:10],
                                  jmpc.TripleBatch(*leaves[10:13]),
                                  jmpc.TripleBatch(*leaves[13:16]))


async def _close(clients, servers):
    for c in clients:
        await c.aclose()
    for s in servers:  # the data plane first: a listener waits for its transports
        if s._peer_writer is not None:
            s._peer_writer.close()
    for s in servers:
        await asyncio.wait_for(s.aclose(), 30)


def _make(kind, sid, kw, shards, ckpt_dir=None, chaos=None, events=None):
    if kind == "port":
        emit = None if events is None else (lambda ev, **f: events.append((sid, ev, f)))
        return trpc.CollectorServer(sid, tconfig.Config(**kw, server_data_devices=shards),
                                    "cpu", ckpt_dir=ckpt_dir, emit=emit, mesh_chaos=chaos)
    return jrpc.CollectorServer(sid, jconfig.Config(**kw, server_data_devices=shards),
                                ckpt_dir=ckpt_dir, _mesh_chaos=chaos)


async def _socket(kinds, shards, kw, keys=KEYS, *, n=N, taps=None, chaos=None, ckpt=None,
                  supervised=False, every=1, events=None, leader="port"):
    """A pair of ``kinds`` with ``shards`` data shards each, a ``leader`` of
    either package.  -> (hitters, both servers' status, the leader, the
    servers' liveness)."""
    (k0, k1), sk = keys
    s0 = _make(kinds[0], 0, kw, shards[0], ckpt and ckpt[0], None, events)
    s1 = _make(kinds[1], 1, kw, shards[1], ckpt and ckpt[1], chaos, events)
    if taps is not None:
        for s, sent in zip((s0, s1), taps):
            _tap(s, sent)
    p0, p1 = chip_smoke.free_ports()
    t1 = asyncio.create_task(s1.start("127.0.0.1", p1, "127.0.0.1", p1 + 1))
    await asyncio.sleep(0.05)
    t0 = asyncio.create_task(s0.start("127.0.0.1", p0, "127.0.0.1", p1 + 1))
    await asyncio.wait_for(asyncio.gather(t0, t1), 60)
    rpc, lrpc, ccls = ((trpc, tleader, tconfig) if leader == "port"
                       else (jrpc, jleader, jconfig))
    clients = []
    try:
        for p in (p0, p1):
            clients.append(await rpc.CollectorClient.connect("127.0.0.1", p))
        emit = None if events is None else (lambda ev, **f: events.append(("leader", ev, f)))
        cfg = ccls.Config(**kw)
        lead = lrpc.RpcLeader(cfg, *clients, emit=emit) if leader == "port" else \
            lrpc.RpcLeader(cfg, *clients)
        sk0, sk1 = sk if sk is not None else (None, None)
        if leader == "jax":
            k0, k1 = jrpc.IbDcfKeyBatch(*k0), jrpc.IbDcfKeyBatch(*k1)
            if sk is not None:
                sk0, sk1 = _jax_sketch(sk0), _jax_sketch(sk1)
        if supervised:
            res = await lead.run_supervised(n, k0, k1, sk0, sk1, checkpoint_every=every)
        else:
            await asyncio.gather(*(c.call("reset") for c in clients))
            await lead.upload_keys(k0, k1, sk0, sk1)
            res = await lead.run(n)
        hitters = {tuple(int(v) for v in r): int(c)
                   for r, c in zip(res.decode_ints(), res.counts)}
        status = await asyncio.gather(*(c.call("status") for c in clients))
        alive = [np.asarray(s.alive_keys.cpu() if isinstance(s.alive_keys, torch.Tensor)
                            else s.alive_keys) for s in (s0, s1)]
        return hitters, status, lead, alive
    finally:
        await _close(clients, (s0, s1))


def run(*args, **kw):
    with torch_ref.installed():
        return asyncio.run(asyncio.wait_for(_socket(*args, **kw), RUN_S))


def _same_frames(got, want, what):
    for sid in (0, 1):
        assert len(got[sid]) == len(want[sid]), (what, sid)
        for i, (a, b) in enumerate(zip(got[sid], want[sid])):
            if isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (what, sid, i)
                assert a.shape == b.shape and a.tobytes() == b.tobytes(), (what, sid, i)
            else:
                assert a == b, (what, sid, i)


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_pairs_are_the_unsharded_and_the_jax_pairs(mode, monkeypatch):
    """Hitters and the whole data-plane transcript of port pairs at k = 2
    and 4 equal the unsharded port pair's and the JAX pair's at k = 4."""
    fix_randomness(monkeypatch)
    kw = cfg_kw(mode)
    keys = SKETCH_KEYS if mode == "sketch" else KEYS
    ref_taps = ([], [])
    want, _, _, want_alive = run(("port", "port"), (1, 1), kw, keys, taps=ref_taps)
    assert want
    if mode == "sketch":
        assert not want_alive[0][FORGER] and want_alive[0].sum() == N - 1
    for kinds, k in ((("port", "port"), 2), (("port", "port"), 4), (("jax", "jax"), 4)):
        taps = ([], [])
        got, status, _, alive = run(kinds, (k, k), kw, keys, taps=taps)
        assert got == want, (kinds, k)
        _same_frames(taps, ref_taps, (kinds, k))
        for a in alive:
            np.testing.assert_array_equal(a, want_alive[0])
        for st in status:
            m = st["mesh"]
            assert m["data_shards"] == k and m["shard_clients"] == [N // k] * k
            assert m["faults"] == m["reshards"] == 0
            if mode == "sketch":
                assert m["sketch_shards"] == k
            if kw.get("secure_exchange"):  # one planar block a level: the gather path
                assert m["kernel_shards"] == 1 and m["kernel_gathers"] == L


@pytest.mark.parametrize("mode", ["trusted", "ot2s", "sketch"])
@pytest.mark.parametrize("kinds", [("jax", "port"), ("port", "jax")],
                         ids=["jax0-port1", "port0-jax1"])
def test_mixed_sharded_pairs(mode, kinds):
    """A JAX sharded server with a port sharded one, in both roles, under
    the port and the JAX leader: the unsharded port pair's hitters."""
    kw = cfg_kw(mode)
    keys = SKETCH_KEYS if mode == "sketch" else KEYS
    want = run(("port", "port"), (1, 1), kw, keys)[0]
    for leader in ("port", "jax"):
        got, status, _, alive = run(kinds, (4, 2), kw, keys, leader=leader)
        assert got == want, leader
        assert [st["mesh"]["data_shards"] for st in status] == [4, 2]
        if mode == "sketch":
            assert not alive[0][FORGER] and alive[0].sum() == N - 1


KN, KL = 1024, 4  # a last level of 8 × 2 × 1,024 = 2 planar blocks
KERNEL_KEYS = make_keys(n=KN, data_len=KL, seed=9)


def _kernel_kw(path, **extra):
    return dict(cfg_kw(), data_len=KL, threshold=0.02, f_max=16, secure_exchange=True,
                ot_path=path, addkey_batch_size=256, **extra)


@pytest.mark.parametrize("path", ["ot2s", "gc"])
def test_row_sharded_kernel_stage_keeps_the_wire(path, monkeypatch):
    """The deep levels fill two planar blocks and run the row-sharded
    kernel stage, the shallow ones gather: the transcript of the unsharded
    pair either way; ``secure_kernel_shards: 1`` gathers every level."""
    fix_randomness(monkeypatch)
    ref_taps = ([], [])
    want = run(("port", "port"), (1, 1), _kernel_kw(path), KERNEL_KEYS, n=KN,
               taps=ref_taps)[0]
    assert want
    for extra, kmax in (({}, 2), ({"secure_kernel_shards": 1}, 1)):
        taps = ([], [])
        got, status, _, _ = run(("port", "port"), (4, 4), _kernel_kw(path, **extra),
                                KERNEL_KEYS, n=KN, taps=taps)
        assert got == want
        _same_frames(taps, ref_taps, extra)
        for st in status:
            m = st["mesh"]
            assert m["kernel_shards_max"] == kmax and m["data_shards"] == 4
            if kmax == 1:
                assert m["kernel_gathers"] == KL
            else:  # the shallow levels fill one block each
                assert 0 < m["kernel_gathers"] < KL and m["kernel_shards"] == 2


@pytest.mark.parametrize("mode", ["trusted", "ot2s"])
def test_device_kill_reshards_inside_the_verb(mode, tmp_path):
    """``mesh:kill`` at level 3 on server 1: it restores level 2's blob on
    its shards and re-runs the level inside the verb; the leader sees no
    fault, and nothing classifies a loss."""
    kw = cfg_kw(mode)
    want = run(("port", "port"), (1, 1), kw)[0]
    chaos = MeshChaos(parse_mesh_faults("mesh:kill@level=3"))
    events = []
    ckpt = [str(tmp_path / f"s{i}") for i in (0, 1)]
    for d in ckpt:
        os.makedirs(d)
    got, status, lead, _ = run(("port", "port"), (2, 2), kw, chaos=chaos, ckpt=ckpt,
                               supervised=True, every=1, events=events)
    assert got == want
    assert chaos.fired == [("kill", 3)]
    assert lead.counters["levels_rerun"] == 0 and lead.counters["recoveries"] == 0
    m = status[1]["mesh"]
    assert (m["faults"], m["reshards"]) == (1, 1) and status[0]["mesh"]["faults"] == 0
    reshard = [f for sid, ev, f in events if ev == "resilience.mesh_reshard"]
    assert len(reshard) == 1 and reshard[0]["level"] == 3 and reshard[0]["state_lost"]
    restores = [f for sid, ev, f in events if ev == "resilience.server_restore"]
    assert [r["level"] for r in restores] == [2]
    assert not [e for e in events if e[1] == "resilience.loss_classified"]


def test_device_kill_without_a_checkpoint_escalates(tmp_path):
    """No level-1 blob: the unsupervised leader gets the server's error; a
    supervised one recovers (from scratch: no checkpoint yet) and
    classifies a device loss on server 1, not a server loss."""
    kw = cfg_kw()
    want = run(("port", "port"), (1, 1), kw)[0]
    with pytest.raises(RuntimeError, match="no level-1 checkpoint to re-shard from"):
        run(("port", "port"), (2, 2), kw, chaos=MeshChaos(parse_mesh_faults(
            "mesh:kill@level=2")))
    events = []
    ckpt = [str(tmp_path / f"s{i}") for i in (0, 1)]
    for d in ckpt:
        os.makedirs(d)
    got, status, lead, _ = run(("port", "port"), (2, 2), kw, ckpt=ckpt, supervised=True,
                               every=4, events=events,
                               chaos=MeshChaos(parse_mesh_faults("mesh:kill@level=2")))
    assert got == want
    assert lead.counters["recoveries"] == 1 and lead.counters["levels_rerun"] == 1
    classified = [f for _, ev, f in events if ev == "resilience.loss_classified"]
    assert classified == [{"server_loss": [], "device_loss": [1]}]
    # the recovery from scratch reset the collection, and a reset clears its
    # telemetry, as the JAX server's does: the fault was counted (classified
    # above from the probe before the reset), its count is gone after
    assert status[1]["mesh"]["faults"] == 0 and status[1]["mesh"]["reshards"] == 0


def _planar(states, planar):
    """Frontier states (numpy, either layout) in the port's plane-major one."""
    seed, bit, y_bit = (np.asarray(states[k]) for k in ("seed", "bit", "y_bit"))
    if planar:
        return [seed, bit, y_bit]
    st = tcollect.states_from_numpy(tibdcf.EvalState(seed, bit, y_bit), "cpu")
    return [st.seed.numpy().view(np.uint32), st.bit.numpy(), st.y_bit.numpy()]


def _blob(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_sharded_blobs_restore_across_packages(tmp_path):
    """A level's checkpoint blob from a sharded port server equals the
    unsharded port server's and the JAX sharded server's (the frontier
    fields), and each package's sharded server restores the other's blob
    into the frontier the unsharded restore gives."""
    kw = cfg_kw()
    dirs = {}
    for name, kinds, shards in (("flat", ("port", "port"), (1, 1)),
                                ("port4", ("port", "port"), (4, 4)),
                                ("jax4", ("jax", "jax"), (4, 4))):
        dirs[name] = [str(tmp_path / name / f"s{i}") for i in (0, 1)]
        for d in dirs[name]:
            os.makedirs(d)
        run(kinds, shards, kw, ckpt=dirs[name], supervised=True, every=1)
    names = {n: _make("port", 1, kw, 1, ckpt_dir=d[1]) for n, d in dirs.items()}
    lv = max(names["flat"]._ckpt_levels())
    blobs = {n: _blob(srv._ckpt_path(lv)) for n, srv in names.items()}
    for key in ("seed", "bit", "y_bit", "alive", "alive_keys", "keys_fp"):
        assert blobs["port4"][key].tobytes() == blobs["flat"][key].tobytes(), key
    for k, v in zip(("seed", "bit", "y_bit"), _planar(blobs["jax4"], bool(
            blobs["jax4"]["planar"]))):
        np.testing.assert_array_equal(v, blobs["flat"][k])

    async def restore(kind, shards, src):
        s = _make(kind, 1, kw, shards, ckpt_dir=src)
        for lo in range(0, N, 5):
            await s.add_keys({"keys": tuple(a[lo:lo + 5] for a in KEYS[0][1])})
        await s.tree_restore({"level": lv})
        if kind == "jax":
            cs = s._default()
            st = cs.frontier.states
            return _planar({"seed": st.seed, "bit": st.bit, "y_bit": st.y_bit}, cs.planar())
        fr = s.frontier if s._mesh is None else s._mesh.gather_frontier(s.frontier)
        return [a.cpu().numpy() for a in fr.states]

    with torch_ref.installed():
        want = asyncio.run(restore("port", 1, dirs["flat"][1]))
        for kind, src in (("port", "jax4"), ("jax", "port4"), ("port", "port4")):
            got = asyncio.run(restore(kind, 4, dirs[src][1]))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.view(b.dtype) if a.dtype != b.dtype else a, b)


def test_warmup_shard_mismatch_is_reported():
    """The leader names its shard budget; a server whose own shards differ
    emits ``warmup.shard_mismatch`` and warms its own; equal, nothing."""
    async def flow(server_k, leader_k):
        events = []
        s = _make("port", 0, cfg_kw(), server_k, events=events)
        for lo in range(0, N, 5):
            await s.add_keys({"keys": tuple(a[lo:lo + 5] for a in KEYS[0][0])})
        out = await s.warmup({"f_buckets": [1, 2], "data_shards": leader_k})
        return out, [f for _, ev, f in events if ev == "warmup.shard_mismatch"]

    out, ev = asyncio.run(flow(4, 2))
    assert out["shapes"] == 2
    assert ev == [{"server": 0, "leader_data_shards": 2, "server_data_shards": 4}]
    assert asyncio.run(flow(4, 4))[1] == []
    assert asyncio.run(flow(4, 0))[1] == []  # auto: no budget named
    assert asyncio.run(flow(1, 4))[1] == [{"server": 0, "leader_data_shards": 4,
                                           "server_data_shards": 1}]
