"""The PyTorch port's retry policy (``resilience/policy.py``) and its copy
of the frame-level chaos proxy (``resilience/chaos.py``): the JAX
package's grammar and semantics, case for case (its
``tests/test_resilience.py``), on ports from the OS
(``chip_smoke.free_ports``), each drill under ``asyncio.wait_for``."""

import asyncio

import pytest

import chip_smoke
from fuzzyheavyhitters_torch.protocol import rpc as trpc
from fuzzyheavyhitters_torch.resilience import policy as respolicy
from fuzzyheavyhitters_torch.resilience.chaos import ChaosProxy, FaultSpec, parse_faults

LIMIT_S = 30  # each drill's own limit: a wedged socket fails its test


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


# -- policy -------------------------------------------------------------------


def test_deadline_remaining_and_expiry():
    d = respolicy.Deadline(100.0)
    assert 0 < d.remaining() <= 100.0 and not d.expired()
    assert respolicy.Deadline(None).remaining() is None
    assert not respolicy.Deadline(None).expired()
    z = respolicy.Deadline(0.0)
    assert z.expired() and z.remaining() == 0.0


def test_transient_classification():
    """Transport-shaped failures are redialed or replayed, a restarted
    server's included; a server's refusal and a bug are not."""
    transient = lambda e: isinstance(e, respolicy.TRANSIENT_ERRORS)
    assert transient(ConnectionResetError())
    assert transient(asyncio.IncompleteReadError(b"", 8))
    assert transient(TimeoutError())
    assert transient(OSError(111, "refused"))
    assert transient(trpc.ServerRestartedError("new boot"))
    assert not transient(ValueError("bug"))
    assert not transient(RuntimeError("server error on x"))
    assert not transient(asyncio.CancelledError())


def test_retry_async_retries_transient_and_raises_fatal():
    calls = []

    async def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("blip")
        return "ok"

    async def fatal():
        raise ValueError("bug")

    pol = respolicy.RetryPolicy(base_s=0.001, attempts=5)
    assert _run(respolicy.retry_async(flaky, pol)) == "ok" and len(calls) == 3
    with pytest.raises(ValueError):
        _run(respolicy.retry_async(fatal, pol))
    calls.clear()
    with pytest.raises(ConnectionResetError):  # exhaustion re-raises the last error
        _run(respolicy.retry_async(flaky, respolicy.RetryPolicy(base_s=0.001, attempts=2)))


def test_verb_budgets_and_shard_policy_are_the_jax_packages():
    b = respolicy.VerbBudgets()
    assert b.budget("status") == 60.0 and b.budget("plane_reset") == 600.0
    assert b.budget("reset") == 300.0 and b.budget("tree_crawl") == 1800.0
    assert respolicy.SHARD_POLICY.attempts == 3 and respolicy.SHARD_POLICY.cap_s == 1.0
    assert respolicy.DIAL_POLICY.attempts == 10


# -- the fault grammar ----------------------------------------------------------


def test_parse_faults_grammar():
    faults = parse_faults("ctl0:sever@msg=12;plane:delay@msg=3,ms=50;"
                          "ctl1:blackhole@msg=2,count=4,dir=s2c;x:flood@msg=1,count=2")
    assert [f.action for f in faults] == ["sever", "delay", "blackhole", "flood"]
    assert faults[0] == FaultSpec(link="ctl0", action="sever", at_msg=12)
    assert faults[1].ms == 50 and faults[1].direction == "c2s"
    assert faults[2].count == 4 and faults[2].direction == "s2c"
    assert parse_faults("") == [] and parse_faults(None) == []


@pytest.mark.parametrize("bad", [
    "ctl0:sever",  # no trigger
    "ctl0:sever@ms=5",  # missing msg=
    "ctl0:explode@msg=1",  # unknown action
    "ctl0:sever@msg=0",  # 1-indexed
    "ctl0:sever@msg=1,dir=sideways",  # unknown direction
    "ctl0:sever@msg=1,speed=9",  # unknown argument
    "justgarbage",
])
def test_parse_faults_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_faults(bad)


# -- the proxy ------------------------------------------------------------------


async def _echo_behind_proxy(spec, link="t"):
    """A framed echo server behind a proxy: (proxy, server)."""
    async def echo(reader, writer):
        try:
            while True:
                await trpc._send(writer, ("echo", await trpc._recv(reader)))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            writer.close()

    port_s, port_p = chip_smoke.free_ports()
    srv = await asyncio.start_server(echo, "127.0.0.1", port_s)
    px = await ChaosProxy("127.0.0.1", port_p, "127.0.0.1", port_s, parse_faults(spec),
                          link=link).start()
    return px, srv


async def _close(px, srv, *writers):
    for w in writers:
        w.close()
    await px.stop()
    srv.close()
    await srv.wait_closed()


def test_proxy_forwards_blackholes_and_severs_and_its_listener_survives():
    async def flow():
        px, srv = await _echo_behind_proxy("t:blackhole@msg=2;t:sever@msg=4;other:sever@msg=1")
        assert [f.link for f in px.faults] == ["t", "t"]  # another link's clause is not ours
        r, w = await asyncio.open_connection("127.0.0.1", px.listen_port)
        await trpc._send(w, "one")  # frame 1: forwarded
        assert await trpc._recv(r) == ("echo", "one")
        await trpc._send(w, "two")  # frame 2: dropped, the connection open
        await trpc._send(w, "three")
        assert await trpc._recv(r) == ("echo", "three")
        await trpc._send(w, "four")  # frame 4: sever
        with pytest.raises((asyncio.IncompleteReadError, ConnectionResetError)):
            await trpc._recv(r)
        # the listener survives, and a fired sever does not re-arm on the redial
        r2, w2 = await asyncio.open_connection("127.0.0.1", px.listen_port)
        for word in ("a", "b", "c", "d", "e"):
            await trpc._send(w2, word)
            assert await trpc._recv(r2) == ("echo", word)
        assert px.fired == [("blackhole", "c2s", 2), ("sever", "c2s", 4)]
        assert px.frames["c2s"] == 9
        await _close(px, srv, w2)

    _run(flow())


def test_proxy_truncate_tears_the_frame():
    async def flow():
        got = []

        async def sink(reader, writer):
            try:
                got.append(await trpc._recv(reader))
            except (asyncio.IncompleteReadError, ConnectionResetError) as e:
                got.append(("torn", type(e).__name__))
            writer.close()

        port_s, port_p = chip_smoke.free_ports()
        srv = await asyncio.start_server(sink, "127.0.0.1", port_s)
        px = await ChaosProxy("127.0.0.1", port_p, "127.0.0.1", port_s,
                              parse_faults("t:truncate@msg=1"), link="t").start()
        r, w = await asyncio.open_connection("127.0.0.1", port_p)
        await trpc._send(w, {"payload": list(range(100))})
        for _ in range(100):
            if got:
                break
            await asyncio.sleep(0.02)
        assert got == [("torn", "IncompleteReadError")]
        await _close(px, srv, w)

    _run(flow())


def test_proxy_delays_a_frame_and_floods_duplicates():
    async def flow():
        px, srv = await _echo_behind_proxy("t:delay@msg=1,ms=150;t:flood@msg=2,count=2")
        r, w = await asyncio.open_connection("127.0.0.1", px.listen_port)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await trpc._send(w, "slow")
        assert await trpc._recv(r) == ("echo", "slow")
        assert loop.time() - t0 >= 0.14
        await trpc._send(w, "dup")  # delivered 1 + 2 times
        assert [await trpc._recv(r) for _ in range(3)] == [("echo", "dup")] * 3
        assert [a for a, _, _ in px.fired] == ["delay", "flood"]
        await _close(px, srv, w)

    _run(flow())


def test_proxy_severs_the_response_direction():
    async def flow():
        px, srv = await _echo_behind_proxy("t:sever@msg=2,dir=s2c")
        r, w = await asyncio.open_connection("127.0.0.1", px.listen_port)
        await trpc._send(w, 1)
        assert await trpc._recv(r) == ("echo", 1)
        await trpc._send(w, 2)  # the request arrives; its answer is cut
        with pytest.raises((asyncio.IncompleteReadError, ConnectionResetError)):
            await trpc._recv(r)
        assert px.fired == [("sever", "s2c", 2)] and px.frames == {"c2s": 2, "s2c": 2}
        await _close(px, srv, w)

    _run(flow())
