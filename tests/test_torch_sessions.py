"""The PyTorch port's per-collection session units (``protocol/sessions.py``:
``SessionTable``, ``PlaneMux``, the checkpoint namespace; ``protocol/
tenancy.py``: ``TenantScheduler`` and the warm ladder) against the JAX
package's, on the CPU, tolerance zero:

- the session table's bound, idle eviction (oldest first, never a bound or
  stateful session) and bad keys, each outcome and error text equal to the
  JAX table's on the same calls;
- the scheduler's device turns and stall fills on the same call sequence as
  the JAX scheduler, ``stats()`` equal;
- the warm ladder, and a second collection's warmup answered from it, as
  the JAX server answers it;
- the plane mux: FIFO per channel, a dead transport delivered to every
  blocked receiver on every channel, re-attach; the JAX mux on the same
  frames;
- namespaced checkpoints: the port's file names equal the JAX server's for
  the same collection, a blob a JAX server wrote under a named collection
  restores in a port server, a blob renamed into another collection's
  namespace is refused, and a torn ingest tail is refused, each refusal
  before any state changes;
- four secure collections crawled at once under the JAX
  ``MultiCollectionDriver``, on a port pair and on a JAX server 0 beside a
  port server 1 (``test_torch_tenants_rpc.py``'s check; its other cases run
  there, so that each file stays near a minute on one worker).

The shapes are ``tests/test_sessions.py``'s (L = 5, d = 1)."""

import asyncio
import os

import numpy as np
import pytest
import torch

import test_torch_tenants_rpc as tt
import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.protocol import sessions as tsessions
from fuzzyheavyhitters_torch.protocol import tenancy as ttenancy
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig

(jrpc, jsessions, jtenancy, jconfig, jcollect) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.rpc", "fuzzyheavyhitters_tpu.protocol.sessions",
    "fuzzyheavyhitters_tpu.protocol.tenancy", "fuzzyheavyhitters_tpu.utils.config",
    "fuzzyheavyhitters_tpu.protocol.collect")

L = 5


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


def _outcome(fn):
    """(kind, value): a call's result, or its exception's type and text."""
    try:
        return "ok", fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)


def _table_script(table, stateful):
    """``tests/test_sessions.py``'s table sequence -> every outcome.
    ``stateful(session)`` gives a session state, so that it is not idle."""
    out = [_outcome(lambda: table.get("a").key), _outcome(lambda: table.get("b").key),
           _outcome(lambda: table.get("c").key), ("keys", sorted(table.keys()))]
    stateful(table.get("b"))
    stateful(table.get("c"))
    out.append(_outcome(lambda: table.get("d").key))
    for bad in ("a/b", "x" * 65, "sp ace", "tab\t"):
        out.append(_outcome(lambda: table.get(bad).key))
    out.append(_outcome(lambda: table.get("").key))  # "" is the default collection
    out.append(("keys", sorted(table.keys())))
    return out


def test_session_table_bound_eviction_and_bad_keys_match_jax():
    port = tsessions.SessionTable(0, tconfig.Config(**_cfg_kw(collection_sessions_max=2)),
                                  torch.device("cpu"), None)

    def port_state(cs):
        cs.keys_parts.append("x")

    got = _table_script(port, port_state)
    with torch_ref.installed():
        jtable = jsessions.SessionTable(
            0, jconfig.Config(**_cfg_kw(collection_sessions_max=2)), None, None)
        want = _table_script(jtable, lambda cs: cs.keys_parts.append("x"))
    assert got == want
    assert [o for o in got if o[0] == "ValueError"][0][1] == (
        "collection key 'a/b' is invalid (want [A-Za-z0-9._-]{1,64}: it names checkpoint "
        "files and wire channels)")
    assert got[4] == ("RuntimeError", "collection 'd' would exceed the 2-session bound and no "
                      "live session is idle (live: ['b', 'c'])")
    # a bound session is never evicted, even with no state; unbound and
    # stateless again, it is
    port.get("b").keys_parts.clear()
    port.get("c").keys_parts.clear()
    port.get("b").bound += 1
    port.get("c").bound += 1
    with pytest.raises(RuntimeError, match="session bound"):
        port.get("e")
    port.get("b").bound -= 1
    assert port.get("e").key == "e" and "b" not in port.keys()
    # a session mid-verb is not idle either
    port.get("c").bound -= 1

    async def locked():
        async with port.get("c")._verb_lock:
            assert not port.get("c").idle()
        assert port.get("c").idle()

    asyncio.run(locked())


def _scheduler_script(sched):
    async def run():
        async with sched.device_turn("a"):
            pass  # nobody on the wire: a plain turn
        with sched.wire_wait("a"):
            async with sched.device_turn("b"):
                pass  # b's turn while a waits: a stall fill
            with sched.wire_wait("b"):
                async with sched.device_turn("a"):
                    pass  # and the other way round
                async with sched.device_turn("c", count=False):
                    pass  # serialized, not counted
            sched.note_dispatch("c")  # a pre-expand while a waits: a fill
        sched.note_dispatch("c")  # nobody waiting any more
        sched.forget("zz")

    asyncio.run(run())
    return sched.stats()


def test_tenant_scheduler_stall_fills_match_jax():
    got = _scheduler_script(ttenancy.TenantScheduler())
    with torch_ref.installed():
        want = _scheduler_script(jtenancy.TenantScheduler())
    assert got == want
    assert got["device_turns"] == 5 and got["stall_fills"] == 3
    assert got["fills_by_session"] == {"a": 1, "b": 1, "c": 1}
    assert got["fill_ratio"] == pytest.approx(0.6) and got["wire_waiting"] == []
    sched = ttenancy.TenantScheduler()
    _scheduler_script(sched)
    load = sched.fleet_load()
    assert load["stall_fill_ratio"] == 0.6 and load["max_progress_age_s"] >= 0
    sched.forget("a")
    assert "a" not in sched.stats()["turns_by_session"]


def test_warm_ladder_marks_and_skips():
    ttenancy.ladder_reset()
    key = ("warm", "0123abcd", "cpu", (4, 1, 5, 2, 4), 4, 2, 5, False, "auto", 1, 1, 0)
    assert not ttenancy.warmed(key) and ttenancy.ladder_size() == 0
    ttenancy.mark_warmed(key)
    assert ttenancy.warmed(key) and ttenancy.ladder_size() == 1
    ttenancy.ladder_reset()
    assert not ttenancy.warmed(key)


def test_warmup_ladder_shared_across_collections_as_the_jax_server():
    """A second collection of the same batch shape warms nothing: every
    shape is a ladder hit, as the JAX server answers; the ladder is keyed by
    the shape (another batch size warms again)."""
    k0, _ = _keys(41, 8)
    small, _ = _keys(42, 6)

    async def script(s, jax_side):
        out = []
        for name, keys in (("wa", k0), ("wb", k0), ("wc", small)):
            cs = s._table.get(name)
            await s.add_keys({"keys": tuple(a[:keys.cw_seed.shape[0]] for a in keys)}, cs)
            out.append(await s.warmup({"f_buckets": [1, 2]}, cs))
        return out

    ttenancy.ladder_reset()
    got = asyncio.run(script(trpc.CollectorServer(0, tconfig.Config(**_cfg_kw()), "cpu"),
                             False))
    with torch_ref.installed():
        jtenancy.ladder_reset()
        want = asyncio.run(script(jrpc.CollectorServer(0, jconfig.Config(**_cfg_kw())), True))
        jtenancy.ladder_reset()
    ttenancy.ladder_reset()
    assert got == want
    assert got[0]["shapes"] > 0 and got[0]["ladder_hits"] == 0
    assert got[1] == {"shapes": 0, "ladder_hits": got[0]["shapes"]}
    assert got[2]["shapes"] == got[0]["shapes"]


def _mux_script(mux):
    async def run():
        reader = asyncio.StreamReader()

        async def read_frame(r):
            line = await r.readexactly(4)
            # fake framing: b"Axy1" -> channel "Axy", payload the int of "1"
            return 4, (line[:3].decode(), line[3])

        out = [mux.attach(reader, read_frame)]
        reader.feed_data(b"Axy1Bzz9Axy2")
        out += [await mux.recv("Axy"), await mux.recv("Bzz"), await mux.recv("Axy")]
        # two receivers blocked on two channels both learn of the death
        waiters = [asyncio.ensure_future(mux.recv(ch)) for ch in ("Axy", "Czz")]
        await asyncio.sleep(0)
        reader.feed_eof()
        for w in waiters:
            try:
                await w
                out.append("no error")
            except ConnectionError:
                out.append("ConnectionError")
        try:  # and later receivers on any channel, until a re-attach
            await mux.recv("Bzz")
        except ConnectionError:
            out.append("ConnectionError")
        r2 = asyncio.StreamReader()
        out.append(mux.attach(r2, read_frame))
        r2.feed_data(b"Axy7")
        out.append(await mux.recv("Axy"))
        mux.close()
        try:
            await mux.recv("Axy")
        except ConnectionError:
            out.append("closed")
        return out

    return asyncio.run(run())


def test_plane_mux_fifo_per_channel_and_failure_to_every_waiter_match_jax():
    got = _mux_script(tsessions.PlaneMux())
    with torch_ref.installed():
        want = _mux_script(jsessions.PlaneMux())
    assert got == want == [1, ord("1"), ord("9"), ord("2"), "ConnectionError",
                           "ConnectionError", "ConnectionError", 2, ord("7"), "closed"]


def test_plane_mux_routes_bytes_and_fails_a_diverged_channel():
    """The route hook sees each frame's channel and bytes; a channel past
    ``MAX_DEPTH`` frames fails the whole plane, never a silent drop."""

    async def run():
        seen = []
        mux = tsessions.PlaneMux(route_count=lambda ch, n: seen.append((ch, n)))
        mux.MAX_DEPTH = 2
        reader = asyncio.StreamReader()

        async def read_frame(r):
            b = await r.readexactly(2)
            return 10, (b[:1].decode(), b[1])

        mux.attach(reader, read_frame)
        reader.feed_data(b"A1B2A3A4")
        await asyncio.sleep(0.01)
        with pytest.raises(ConnectionError, match="data plane down"):
            await mux.recv("B")
        return seen

    assert asyncio.run(run()) == [("A", 10), ("B", 10), ("A", 10), ("A", 10)]


# -- namespaced checkpoints ------------------------------------------------------


def test_checkpoint_names_equal_the_jax_servers(tmp_path):
    ps = trpc.CollectorServer(1, tconfig.Config(**_cfg_kw()), "cpu", ckpt_dir=str(tmp_path))
    with torch_ref.installed():
        js = jrpc.CollectorServer(1, jconfig.Config(**_cfg_kw()), ckpt_dir=str(tmp_path))
        for key in ("default", "tenA", "t.0-x_1"):
            for level in (-1, 3, 12):
                assert (ps._table.get(key).ckpt_path(level)
                        == js._table.get(key).ckpt_path(level))
    assert ps._table.get("tenA").ckpt_path(3) == str(tmp_path / "fhh_server1_ctenA_l3.npz")
    assert ps._ckpt_path(3) == str(tmp_path / "fhh_server1_l3.npz")
    # a collection's levels and prunes see its own namespace only
    for name in ("fhh_server1_l2.npz", "fhh_server1_ctenA_l5.npz", "fhh_server1_ctenA_l9.npz",
                 "fhh_server1_ctenA_l11.npz", "fhh_server1_ctenB_l4.npz"):
        (tmp_path / name).write_bytes(b"x")
    ta = ps._table.get("tenA")
    assert ta.ckpt_levels() == [5, 9, 11] and ps._ckpt_levels() == [2]
    ta.ckpt_prune(keep=2)
    assert ta.ckpt_levels() == [9, 11] and ps._table.get("tenB").ckpt_levels() == [4]


def test_jax_blob_of_a_named_collection_restores_in_a_port_server(tmp_path):
    """A JAX server checkpoints two collections' root frontiers; the port
    server restores ``tenA``'s blob under ``tenA`` (the frontier equals its
    own ``tree_init``), and refuses it renamed into ``tenB``'s namespace,
    and a ``tenB`` blob with a torn ingest tail, before any state changes."""
    k0, _ = _keys(11, 6)
    chunk = tuple(np.asarray(a) for a in k0)

    async def jax_side():
        s = jrpc.CollectorServer(0, jconfig.Config(**_cfg_kw()), ckpt_dir=str(tmp_path))
        for name in ("tenA", "tenB"):
            cs = s._table.get(name)
            await s.add_keys({"keys": chunk}, cs)
            cs.concat_keys()
            cs.alive_keys = np.ones(6, bool)
            cs.frontier = jcollect.tree_init(cs.keys, 1)
            await s.tree_checkpoint({"level": 1}, cs)
        await s.aclose()

    with torch_ref.installed():
        asyncio.run(jax_side())
    assert sorted(os.listdir(tmp_path)) == ["fhh_server0_ctenA_l1.npz",
                                            "fhh_server0_ctenB_l1.npz"]

    async def port_side():
        s = trpc.CollectorServer(0, tconfig.Config(**_cfg_kw()), "cpu", ckpt_dir=str(tmp_path))
        ca, cb = s._table.get("tenA"), s._table.get("tenB")
        for cs in (ca, cb):
            await s.add_keys({"keys": chunk}, cs)
        assert await s.tree_restore({"level": 1}, ca) == {"level": 1}
        want = tcollect.tree_init(tibdcf.keys_from_numpy(tibdcf.IbDcfKeyBatch(*chunk), "cpu"), 1)
        for a, b in zip(ca.frontier.states, want.states):
            assert torch.equal(a, b)
        assert torch.equal(ca.frontier.alive, want.alive) and bool(ca.alive_keys.all())
        assert s.frontier is None  # the default collection is untouched
        # tenA's blob renamed into tenB's namespace: refused at the stamp
        os.replace(tmp_path / "fhh_server0_ctenA_l1.npz", tmp_path / "fhh_server0_ctenB_l1.npz")
        with pytest.raises(RuntimeError, match="stamped for collection 'tenA', not 'tenB'"):
            await s.tree_restore({"level": 1}, cb)
        assert cb.frontier is None and cb.stats["restores"] == 0
        # a port blob of tenB with a torn ingest tail: refused, pools intact
        cb._concat_keys("test")
        cb.alive_keys = torch.ones(6, dtype=torch.bool)
        cb.frontier = want
        pool = cb.ingest_pool(0)
        pool.apply("sub1", tuple(a[:2] for a in chunk), cb._admission.admit(pool.wa, "c", 2))
        await s.tree_checkpoint({"level": 2}, cb)
        path = cb.ckpt_path(2)
        assert path.endswith("fhh_server0_ctenB_l2.npz")
        with np.load(path) as z:
            blob = {k: z[k] for k in z.files}
        assert str(blob["sess"]) == "tenB"
        del blob["ing0_lens"]
        with open(path, "wb") as f:
            np.savez(f, **blob)
        before = dict(cb._ingest_pools)
        with pytest.raises(RuntimeError, match="missing ingest fields"):
            await s.tree_restore({"level": 2}, cb)
        assert cb._ingest_pools == before and cb.frontier is want
        assert s.stats["restores"] == ca.stats["restores"] == 1
        await s.aclose()

    asyncio.run(port_side())


@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port")],
                         ids=["port-pair", "jax0-port1"])
def test_four_secure_collections_under_the_jax_driver_equal_their_solo_runs(tmp_path, kinds):
    tt.four_collections(tmp_path, "secure", kinds, "jax")
