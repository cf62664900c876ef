"""The PyTorch port's secure exchange (``protocol/secure.py``, the secure
level of ``protocol/driver.py``, ``bin/mesh``) against the JAX package, bit
for bit: one whole level with the same injected OT-session material — the
evaluator's u message and T rows, the garbler's planar message byte for
byte (pad slots included) and shares, the evaluator's opened values — on
both fields, both garbler signs and both equality paths; the helpers
(strings, seeds, b2a pairs, share sums); and whole secure crawls, whose
hitters and counts must equal the JAX package's trusted driver on the same
keys.  The JAX package's equality kernels run as its XLA twins (see
``test_torch_ot2s.py``)."""

import json
import random

import numpy as np
import pytest
import torch

import torch_logs
import torch_ref
from fuzzyheavyhitters_torch.bin import mesh as tmesh
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops import otext as totext
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import config as tconfig
from fuzzyheavyhitters_torch.utils import words_to_numpy

(jsecure, jotext, jfields, jgc, jgc_pallas, jotext_pallas, jutils, jworkloads, jibdcf,
 jdriver, jconfig) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.secure", "fuzzyheavyhitters_tpu.ops.otext",
    "fuzzyheavyhitters_tpu.ops.fields", "fuzzyheavyhitters_tpu.ops.gc",
    "fuzzyheavyhitters_tpu.ops.gc_pallas", "fuzzyheavyhitters_tpu.ops.otext_pallas",
    "fuzzyheavyhitters_tpu.utils", "fuzzyheavyhitters_tpu.workloads",
    "fuzzyheavyhitters_tpu.ops.ibdcf", "fuzzyheavyhitters_tpu.protocol.driver",
    "fuzzyheavyhitters_tpu.utils.config")

FIELDS = {"FE62": (tfields.FE62, jfields.FE62), "F255": (tfields.F255, jfields.F255)}


def _field_np(name, v):
    """A port field tensor as the JAX package's numpy form."""
    return v.numpy().view(np.uint64) if name == "FE62" else words_to_numpy(v)


def _sessions(seed):
    mat = tdriver.session_material(random.Random(seed))
    s_bits, seeds0, seeds1, chosen = mat["sessions"][0]
    return mat, (totext.OtExtSender(s_bits, chosen), totext.OtExtReceiver(seeds0, seeds1)), \
        (jotext.OtExtSender(s_bits, chosen), jotext.OtExtReceiver(seeds0, seeds1))


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("garbler", [0, 1])
@pytest.mark.parametrize("path,S", [("ot2s", 2), ("gc", 2), ("gc", 4)])
def test_whole_level_matches_jax(field, garbler, path, S):
    tf, jf = FIELDS[field]
    _, (tsnd, trcv), (jsnd, jrcv) = _sessions(20 + garbler)
    rng = np.random.default_rng(21 + S)
    # a first batch, so this level's pad index and stream offset are not 0
    pre = rng.integers(0, 2, size=333).astype(bool)
    ju, _ = jrcv.extend(pre)
    tu, _ = trcv.extend(torch.from_numpy(pre))
    jsnd.extend(333, ju)
    tsnd.extend(333, tu)
    B = 600
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    y = x.copy()
    y[::3] = rng.integers(0, 2, size=y[::3].shape).astype(bool)
    gseed, bseed = (rng.integers(0, 2**32, size=4, dtype=np.uint32) for _ in range(2))
    with torch_ref.installed():
        ju, jt, jidx0 = jsecure.ev_step1_fused(jrcv, y)
        jmsg, jr1 = jsecure.gb_step_level(jsnd, ju, x, gseed, bseed, jf, garbler, path)
        jvals = jsecure.ev_open_level(jt, y, jmsg, B, S, jf, jidx0, path)
    tu, tt, tidx0 = tsecure.ev_step1_fused(trcv, torch.from_numpy(y))
    assert tidx0 == jidx0 == 333
    np.testing.assert_array_equal(words_to_numpy(tu), np.asarray(ju, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tt), np.asarray(jt, np.uint32))
    tmsg, tr1 = tsecure.gb_step_level(tsnd, tu, torch.from_numpy(x), gseed, bseed, tf,
                                      garbler, path)
    np.testing.assert_array_equal(words_to_numpy(tmsg), np.asarray(jmsg, np.uint32))
    np.testing.assert_array_equal(_field_np(field, tr1), np.asarray(jr1))
    tvals = tsecure.ev_open_level(tt, torch.from_numpy(y), tmsg, B, S, tf, tidx0, path)
    np.testing.assert_array_equal(_field_np(field, tvals), np.asarray(jvals))
    # the shares reconstruct [x == y] whichever server garbled
    sh = (tr1, tvals) if garbler == 0 else (tvals, tr1)
    diff = tf.sub(sh[0], sh[1])
    eq = (x == y).all(axis=1)
    if field == "FE62":
        np.testing.assert_array_equal(tf.canon(diff).numpy(), eq)
    else:
        np.testing.assert_array_equal(words_to_numpy(diff)[:, 0], eq)
        assert not words_to_numpy(diff)[:, 1:].any()


@pytest.mark.parametrize("d", [1, 2, 3])
def test_child_strings_match_jax(d):
    packed = np.random.default_rng(30 + d).integers(0, 2**32, size=(3, 17), dtype=np.uint32)
    want = np.asarray(jsecure.child_strings(packed, d))
    got = tsecure.child_strings(torch.from_numpy(packed.view(np.int32)), d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsecure._string_positions(d), jsecure._string_positions(d))


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("garbler", [0, 1])
def test_b2a_pair_and_share_sums_match_jax(field, garbler, monkeypatch):
    tf, jf = FIELDS[field]
    seed = jsecure.derive_seed(np.array([5, 6, 7, 8], np.uint32), 2, 9, 3)
    np.testing.assert_array_equal(tsecure.derive_seed(np.array([5, 6, 7, 8]), 2, 9, 3), seed)
    F, C, N = 7, 2, 143
    B = F * C * N
    jr1, jw0, jw1 = jsecure.b2a_payload_pair(jf, seed, B, garbler)
    monkeypatch.setattr(tsecure, "B2A_TESTS", 256)  # several passes over the stream
    tr1, tw0, tw1 = tsecure.b2a_payload_pair(tf, seed, B, garbler, "cpu")
    np.testing.assert_array_equal(_field_np(field, tr1), np.asarray(jr1))
    np.testing.assert_array_equal(words_to_numpy(tw0), np.asarray(jw0, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tw1), np.asarray(jw1, np.uint32))
    np.testing.assert_array_equal(
        _field_np(field, tsecure.words_to_field(tf, tw1)),
        np.asarray(jsecure.words_to_field(jf, np.asarray(jw1))))
    alive_n = np.arange(F) != 3
    alive_k = np.arange(N) % 5 != 0
    w = jsecure.alive_weight(alive_n, alive_k, C)
    tw = tsecure.alive_weight(torch.from_numpy(alive_n), torch.from_numpy(alive_k), C)
    np.testing.assert_array_equal(tw.numpy(), w)
    vals = np.asarray(jr1).reshape((F, C, N) + tf.limb_shape)
    monkeypatch.setattr(tsecure, "SUM_NODES", 3)
    got = tsecure.node_share_sums(tf, tr1.reshape((F, C, N) + tf.limb_shape), tw)
    np.testing.assert_array_equal(_field_np(field, got),
                                  np.asarray(jsecure.node_share_sums(jf, vals, w)))


def test_ot_path_rules_match_jax():
    for S in (1, 2, 4, 6, 8):
        for o in ("auto", "gc"):
            assert tsecure.ot_path(S, o) == jsecure.ot_path(S, o)
    assert tsecure.ot_path(6, "ot2s") == "ot2s"
    with pytest.raises(ValueError, match="capped"):
        tsecure.ot_path(8, "ot2s")
    with pytest.raises(ValueError):
        tsecure.ot_path(2, "bogus")
    with pytest.raises(ValueError, match="ot_path"):
        tconfig.Config(**dict(CRAWLS["rides"], ot_path="bogus"))


_BASE = dict(ball_size=2, addkey_batch_size=100, num_sites=20, threshold=0.05,
             zipf_exponent=1.03, server0="127.0.0.1:8000", server1="127.0.0.1:8001")
CRAWLS = {
    "zipf": dict(_BASE, data_len=32, n_dims=1, threshold=0.015, distribution="zipf"),
    "rides": dict(_BASE, data_len=16, n_dims=2, ball_size=1, threshold=0.075,
                  distribution="rides"),
}


@pytest.mark.parametrize("workload,n,path", [("zipf", 400, "auto"), ("rides", 300, "auto"),
                                             ("rides", 300, "gc")])
def test_secure_crawl_matches_jax_trusted_driver(workload, n, path):
    raw = CRAWLS[workload]
    rng = np.random.default_rng(40)
    pts = jworkloads.sample_points(jconfig.Config(**raw), n, rng)
    k0, k1 = jibdcf.gen_l_inf_ball(pts, raw["ball_size"], rng, engine="np")
    d, L = raw["n_dims"], raw["data_len"]
    jres = jdriver.Leader(*jdriver.make_servers(k0, k1), n_dims=d, data_len=L,
                          f_max=1024).run(nreqs=n, threshold=raw["threshold"])
    ts = tdriver.make_servers(tibdcf.keys_from_numpy(k0, "cpu"),
                              tibdcf.keys_from_numpy(k1, "cpu"))
    sessions = tdriver.make_sessions(tdriver.session_material(random.Random(41)), "cpu")
    lead = tdriver.Leader(*ts, n_dims=d, data_len=L, f_max=1024, secure=sessions,
                          ot_path=path)
    tres = lead.run(nreqs=n, threshold=raw["threshold"])
    assert jres.paths.shape[0] > 0
    np.testing.assert_array_equal(tres.paths, jres.paths)
    np.testing.assert_array_equal(tres.counts, np.asarray(jres.counts, np.int64))
    for k in ("otext", "b2a", "field"):
        assert len(lead.timings[k]) == L
    used = "garble" if tsecure.ot_path(2 * d, path) == "gc" else "b2a"
    assert sum(lead.timings[used]) > 0
    # both sessions advanced: the garbler alternates per level
    assert all(s.consumed > 0 for s in sessions.snd)
    assert [s.consumed for s in sessions.snd] == [s.consumed for s in sessions.rcv]


@pytest.mark.parametrize("path", ["auto", "gc"])
def test_mesh_binary_secure_rides_equals_trusted(tmp_path, capsys, path):
    cfg_path = tmp_path / "rides.json"
    cfg_path.write_text(json.dumps(dict(CRAWLS["rides"], secure_exchange=True,
                                        ot_path=path)))
    with torch_logs.binary_in_process():  # events as JSON lines on stdout
        tmesh.main(["-c", str(cfg_path), "-n", "300", "--device", "cpu", "--seed", "1",
                    "--csv", str(tmp_path / "a.csv")])
    events = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    done = next(e for e in events if e["event"] == "crawl.done")
    assert done["secure"] and len(done["ot_consumed"]) == 2
    secure = [(e["value"], e["count"]) for e in events if e["event"] == "hitter"]
    trusted = tmesh.run(tconfig.Config(**CRAWLS["rides"]), 300, device="cpu", seed=1,
                        csv_path=str(tmp_path / "b.csv"))
    assert secure and secure == [(str(r.tolist()), int(c)) for r, c in
                                 zip(trusted.result.decode_ints(), trusted.result.counts)]


def test_reconstruction_refuses_a_role_mismatch(monkeypatch):
    """Both sessions' garbler seen as server 0: the shares no longer
    reconstruct a count, and the leader raises instead of thresholding."""
    raw = CRAWLS["rides"]
    rng = np.random.default_rng(50)
    pts = jworkloads.sample_points(jconfig.Config(**raw), 60, rng)
    k0, k1 = jibdcf.gen_l_inf_ball(pts, 1, rng, engine="np")
    ts = tdriver.make_servers(tibdcf.keys_from_numpy(k0, "cpu"),
                              tibdcf.keys_from_numpy(k1, "cpu"))
    sessions = tdriver.make_sessions(tdriver.session_material(random.Random(51)), "cpu")
    lead = tdriver.Leader(*ts, n_dims=2, data_len=16, secure=sessions)
    real = tsecure.b2a_payload_pair
    monkeypatch.setattr(tsecure, "b2a_payload_pair",
                        lambda f, s, B, g, dev: real(f, s, B, 1 - g, dev))
    with pytest.raises(RuntimeError, match="out of range|residue"):
        lead.run(nreqs=60, threshold=0.075)
