"""The PyTorch port's admission gate and native reservoir
(``resilience/admission.py``, ``native/``) against the JAX package's, on
the same offers, tolerance zero:

(a) the token bucket's take, refusal and refill horizon, and every verdict
    scope of the gate (rate, burst, quota, capacity), under a
    ``ManualClock`` driven identically on both sides;
(b) the reservoir shed mode: slots, sheds and ledgers of a long offer
    sequence, and its ``admit_offloaded`` twin;
(c) the incremental reservoir: the native library, its Python twin and the
    JAX package's ``native.Reservoir`` draw the same slots from the same
    seed, and its state round-trips into either, mid-stream;
(d) ``csv_reservoir_sample`` on a CSV written from a seed, and the rides
    sampler over it."""

import asyncio
import csv
import sys

import numpy as np
import pytest

import torch_ref
from fuzzyheavyhitters_torch import native as tnative
from fuzzyheavyhitters_torch.resilience import admission as tadm
from fuzzyheavyhitters_torch.workloads import rides as trides

(jadm, jnative, jrides) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.resilience.admission", "fuzzyheavyhitters_tpu.native",
    "fuzzyheavyhitters_tpu.workloads.rides")


def _verdict(v) -> tuple:
    return (v.admitted, v.slot, v.shed, v.scope, round(v.retry_after_s, 9))


def _ledger(wa) -> tuple:
    res = None if wa.reservoir is None else wa.reservoir.state().tolist()
    return (wa.subs, wa.keys, wa.sub_keys, dict(wa.client_keys), wa.pending_draws, res)


def _both(**kw):
    """A port and a JAX controller over their own ManualClocks."""
    tc, jc = tadm.ManualClock(), jadm.ManualClock()
    return (tadm.AdmissionController(**kw, clock=tc), tc,
            jadm.AdmissionController(**kw, clock=jc), jc)


# offers: (client id, keys, seconds to advance before the offer)
_RATE_OFFERS = [("a", 30, 0.0), ("b", 30, 0.0), ("a", 50, 0.0), ("c", 10, 0.1),
                ("a", 80, 0.5), ("b", 200, 0.0), ("c", 40, 2.0), ("a", 5, 0.0)]


@pytest.mark.parametrize("kw,offers", [
    (dict(max_window_keys=1000, rate_keys_per_s=100.0, burst_keys=100), _RATE_OFFERS),
    (dict(max_window_keys=1000, client_quota=60), [("a", 30, 0), ("a", 30, 0), ("a", 1, 0),
                                                   ("b", 61, 0), ("b", 60, 0), ("c", 5, 0)]),
    (dict(max_window_keys=100), [("a", 40, 0), ("b", 40, 0), ("c", 30, 0), ("d", 20, 0),
                                 ("e", 1, 0), ("f", 101, 0)]),
    (dict(max_window_keys=1000, rate_keys_per_s=50.0, burst_keys=60, client_quota=90),
     [("a", 50, 0), ("a", 50, 0), ("b", 20, 0), ("b", 20, 1.0), ("a", 50, 5.0), ("c", 61, 0)]),
], ids=["rate-burst", "quota", "capacity", "rate-quota"])
def test_reject_mode_verdicts_match_jax(kw, offers):
    tctl, tclock, jctl, jclock = _both(**kw)
    twa, jwa = tctl.window(3), jctl.window(3)
    assert twa.seed == jwa.seed == (kw.get("seed", 0) * 0x9E3779B9 + 3) % (1 << 64)
    scopes = set()
    for client, n, dt in offers:
        tclock.advance(dt)
        jclock.advance(dt)
        tv, jv = tctl.admit(twa, client, n), jctl.admit(jwa, client, n)
        assert _verdict(tv) == _verdict(jv)
        assert _ledger(twa) == _ledger(jwa)
        scopes.add(tv.scope)
        if tctl.bucket is not None:
            assert tctl.bucket.tokens == jctl.bucket.tokens
    assert len(scopes) >= 2  # some admitted, something refused


def test_token_bucket_refill_horizon_matches_jax():
    tc, jc = tadm.ManualClock(5.0), jadm.ManualClock(5.0)
    tb = tadm.TokenBucket(40.0, 100, clock=tc)
    jb = jadm.TokenBucket(40.0, 100, clock=jc)
    for take, dt in ((70, 0), (50, 0), (50, 0.25), (50, 0.5), (100, 10), (1, 0)):
        tc.advance(dt)
        jc.advance(dt)
        assert tb.wait_s(take) == jb.wait_s(take)
        assert tb.try_take(take) == jb.try_take(take)
        assert tb.tokens == jb.tokens
    with pytest.raises(ValueError, match="rate must be positive"):
        tadm.TokenBucket(0.0, 10)
    with pytest.raises(ValueError, match="positive"):
        tadm.AdmissionController(max_window_keys=0)
    with pytest.raises(ValueError, match="unknown shed policy"):
        tadm.AdmissionController(max_window_keys=4, shed="drop")


@pytest.mark.parametrize("seed,window", [(0, 0), (7, 1), (2**63 + 5, 9)])
def test_reservoir_mode_slots_and_sheds_match_jax(seed, window):
    """A window of 5 submissions' room offered 60 chunks of 4 keys (and a
    mismatched chunk, refused before any draw): the same slots, sheds and
    sampler state as the JAX gate."""
    tctl, _, jctl, _ = _both(max_window_keys=20, shed="reservoir", seed=seed)
    twa, jwa = tctl.window(window), jctl.window(window)
    out = []
    for i in range(60):
        n = 3 if i == 30 else 4
        tv, jv = tctl.admit(twa, f"c{i % 7}", n), jctl.admit(jwa, f"c{i % 7}", n)
        assert _verdict(tv) == _verdict(jv)
        out.append(_verdict(tv))
    assert _ledger(twa) == _ledger(jwa)
    assert sum(v[2] for v in out) > 10 and sum(v[1] is not None for v in out) > 3
    assert out[30][3] == "capacity"  # a size that breaks the slot table


def test_admit_offloaded_runs_behind_the_gate_and_matches_admit():
    async def flow():
        ctl = tadm.AdmissionController(max_window_keys=12, shed="reservoir", seed=4)
        ref = tadm.AdmissionController(max_window_keys=12, shed="reservoir", seed=4)
        wa, wr = ctl.window(2), ref.window(2)
        gate = asyncio.Lock()
        got = [await ctl.admit_offloaded(wa, "x", 3, gate=gate) for _ in range(20)]
        assert [_verdict(v) for v in got] == [_verdict(ref.admit(wr, "x", 3))
                                              for _ in range(20)]
        assert not gate.locked()

    asyncio.run(flow())


def _twin(k, seed=0, state=None):
    """A reservoir on the Python twin whatever the host builds."""
    py = tnative._PyXoshiro256(seed)
    if state is None:
        return tnative.Reservoir(k, seed, _py=py)
    py.s = [int(v) for v in state[2:]]
    return tnative.Reservoir(int(state[0]), 0, _py=py, _seen=int(state[1]))


@pytest.mark.parametrize("k,seed,n", [(1, 0, 50), (7, 42, 400), (64, 2**64 - 1, 1000)])
def test_native_reservoir_matches_twin_and_jax(k, seed, n):
    assert tnative.available()  # g++ builds it here
    nat, twin = tnative.Reservoir(k, seed), _twin(k, seed)
    assert nat._handle is not None and twin._handle is None
    with torch_ref.installed():
        ref = jnative.Reservoir(k, seed)
    a = np.concatenate([nat.offer(n // 2), nat.offer(n - n // 2)])
    np.testing.assert_array_equal(a, twin.offer(n))
    np.testing.assert_array_equal(a, ref.offer(n))
    assert (a[:k] == np.arange(min(k, n))).all() and (a >= -1).all() and (a < k).all()
    np.testing.assert_array_equal(nat.state(), twin.state())
    np.testing.assert_array_equal(nat.state(), ref.state())
    assert nat.seen == twin.seen == n


def test_reservoir_state_round_trips_across_packages_mid_stream():
    r = tnative.Reservoir(9, 123)
    r.offer(37)
    st = r.state()
    assert st.dtype == np.uint64 and st.shape == (6,) and int(st[1]) == 37
    want = r.offer(300)
    for back in (tnative.Reservoir.from_state(st), _twin(9, state=st),
                 jnative.Reservoir.from_state(st)):
        np.testing.assert_array_equal(back.offer(300), want)
    # and a JAX state into the port
    j = jnative.Reservoir(9, 123)
    j.offer(37)
    np.testing.assert_array_equal(tnative.Reservoir.from_state(j.state()).offer(300), want)
    with pytest.raises(ValueError, match="uint64\\[6\\]"):
        tnative.Reservoir.from_state(np.zeros(5, np.uint64))
    with pytest.raises(ValueError, match="positive"):
        tnative.Reservoir(0, 1)


def _write_csv(path, rows: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"col{i}" for i in range(16)])
        for i in range(rows):
            row = [f"x{i}"] * 16
            row[13] = f"{-97.74 + rng.normal(0, 0.05):.6f}"
            row[14] = f"{30.26 + rng.normal(0, 0.05):.6f}"
            row[2] = '"a, quoted field"'
            w.writerow(row)


@pytest.mark.parametrize("rows,k,seed", [(50, 80, 1), (500, 64, 2), (3000, 100, 2**40 + 3)])
def test_csv_reservoir_sample_matches_jax(tmp_path, rows, k, seed):
    path = str(tmp_path / "rides.csv")
    _write_csv(path, rows, seed)
    got = tnative.csv_reservoir_sample(path, 14, 13, k, seed)
    with torch_ref.installed():
        want = jnative.csv_reservoir_sample(path, 14, 13, k, seed)
    assert got.shape == (min(rows, k), 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the rides sampler takes it, as the JAX one does
    with torch_ref.installed():
        jpts = jrides.sample_start_locations(path, k, seed)
    np.testing.assert_array_equal(trides.sample_start_locations(path, k, seed), jpts)
    with pytest.raises(FileNotFoundError):
        tnative.csv_reservoir_sample(str(tmp_path / "absent.csv"), 14, 13, k, seed)


def test_without_the_native_library_the_twins_serve(tmp_path, monkeypatch):
    """No ``g++`` (the build failed): the reservoir runs on the Python twin
    with the same slots, and the rides sampler falls back to NumPy, drawing
    the JAX package's fallback sample for the same seed."""
    path = str(tmp_path / "rides.csv")
    _write_csv(path, 400, 9)
    want_slots = tnative.Reservoir(5, 77).offer(200)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    r = tnative.Reservoir(5, 77)
    assert r._handle is None and not tnative.available()
    np.testing.assert_array_equal(r.offer(200), want_slots)
    assert tnative.csv_reservoir_sample(path, 14, 13, 10, 3) is None
    with torch_ref.installed():
        # the module the JAX sampler imports at call time (the suite's other
        # files may have loaded another copy of it than ``jnative``)
        monkeypatch.setattr(sys.modules["fuzzyheavyhitters_tpu.native"], "_load", lambda: None)
        jpts = jrides.sample_start_locations(path, 50, 3)
    np.testing.assert_array_equal(trides.sample_start_locations(path, 50, 3), jpts)

