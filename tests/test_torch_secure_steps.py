"""The PyTorch port's sans-IO secure forms against the JAX package, byte for
byte (tolerance 0: the protocol is bitwise): the OT extension's
``extend_pads``, the two-round flow (``ev_step1`` → ``gb_step1`` →
``ev_step2`` → ``ev_step3`` → ``gb_step2`` → ``ev_step4``), the b2a cores,
the test-major 1-of-2^S table and its ``gb_step_ot4`` / ``ev_open_ot4``
steps, the fused flat-wire form ``gb_step_fused`` / ``ev_open_fused`` and
the wire packing helpers, on both fields and both garbler signs; and the
test-major GC surface of ``ops/gc.py``: ``garble_equality``,
``garble_equality_delta`` / ``eval_equality`` and K2's payload pair
``garble_equality_payload`` / ``eval_equality_payload`` (through the GC
kernels' wrappers at S >= 2, the plain forms at S = 1).

The JAX side runs its XLA twins, and K2's Pallas kernels op by op through
``torch_ref.pallas_eager``."""

import functools
import random

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import gc as tgc
from fuzzyheavyhitters_torch.ops import otext as totext
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jsecure, jotext, jfields, jgc, jgc_pallas = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.secure", "fuzzyheavyhitters_tpu.ops.otext",
    "fuzzyheavyhitters_tpu.ops.fields", "fuzzyheavyhitters_tpu.ops.gc",
    "fuzzyheavyhitters_tpu.ops.gc_pallas")

FIELDS = {"FE62": (tfields.FE62, jfields.FE62), "F255": (tfields.F255, jfields.F255)}


def _w(a):
    return words_from_numpy(a, "cpu")


def _u32(a):
    return np.asarray(a, np.uint32)


def _field_np(name, v):
    return v.numpy().view(np.uint64) if name == "FE62" else words_to_numpy(v)


def _eq_words(t, j):
    np.testing.assert_array_equal(words_to_numpy(t), _u32(j))


@functools.lru_cache(maxsize=None)
def _material():
    """One base-OT session for the module (the pure-Python base OT takes
    about a second a session)."""
    return tdriver.session_material(random.Random(5))["sessions"][0]


def _sessions(seed, pre: int = 333):
    """A port and a JAX OT-extension pair on the same base-OT material, each
    advanced by a first batch of ``pre`` OTs (choices drawn from ``seed``)
    so pad indices and stream offsets start past 0."""
    s_bits, seeds0, seeds1, chosen = _material()
    t = totext.OtExtSender(s_bits, chosen), totext.OtExtReceiver(seeds0, seeds1)
    j = jotext.OtExtSender(s_bits, chosen), jotext.OtExtReceiver(seeds0, seeds1)
    choices = np.random.default_rng(seed).integers(0, 2, size=pre).astype(bool)
    ju, _ = j[1].extend(choices)
    tu, _ = t[1].extend(torch.from_numpy(choices))
    j[0].extend(pre, ju)
    t[0].extend(pre, tu)
    return t, j


def _strings(seed, B, S):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    y = x.copy()
    y[::3] = rng.integers(0, 2, size=y[::3].shape).astype(bool)
    seeds = [rng.integers(0, 2**32, size=4, dtype=np.uint32) for _ in range(2)]
    return x, y, seeds


@pytest.mark.parametrize("W,domain", [(4, 0), (8, 0x0F4E4F54)])
def test_extend_pads_match_jax(W, domain):
    (tsnd, trcv), (jsnd, jrcv) = _sessions(3)
    choices = np.random.default_rng(4).integers(0, 2, size=777).astype(bool)
    ju, jt, jpad = jrcv.extend_pads(choices, W, domain)
    tu, tt, tpad = trcv.extend_pads(torch.from_numpy(choices), W, domain)
    for a, b in ((tu, ju), (tt, jt), (tpad, jpad)):
        _eq_words(a, b)
    jq, jp0, jp1 = jsnd.extend_pads(777, ju, W, domain)
    tq, tp0, tp1 = tsnd.extend_pads(777, tu, W, domain)
    for a, b in ((tq, jq), (tp0, jp0), (tp1, jp1)):
        _eq_words(a, b)
    assert tsnd.consumed == jsnd.consumed == trcv.consumed == 333 + 777
    assert tsnd.stream_offset == jsnd.stream_offset
    # the receiver's pad is the sender's pad of its choice
    np.testing.assert_array_equal(words_to_numpy(tpad),
                                  np.where(choices[:, None], words_to_numpy(tp1),
                                           words_to_numpy(tp0)))


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("garbler", [0, 1])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_two_round_flow_matches_jax(field, garbler, S):
    """Every message and share of the two-round flow, byte for byte; S = 1
    runs the plain delta garble and eval, S >= 2 the GC kernels' wrappers."""
    tf, jf = FIELDS[field]
    (tsnd, trcv), (jsnd, jrcv) = _sessions(10 + S + garbler)
    B = 300
    x, y, (gseed, bseed) = _strings(20 + S, B, S)
    with torch_ref.installed():
        ju, jt = jsecure.ev_step1(jrcv, y)
        jbatch, jmask = jsecure.gb_step1(jsnd, ju, x, gseed)
        je = jsecure.ev_step2(jbatch, jt, B, S)
        ju2, jt2, jidx0 = jsecure.ev_step3(jrcv, je)
        jc0, jc1, jr1 = jsecure.gb_step2(jsnd, ju2, jmask, bseed, jf, garbler)
        jv = jsecure.ev_step4(jrcv, jt2, jidx0, jc0, jc1, je, jf)
    tu, tt = tsecure.ev_step1(trcv, torch.from_numpy(y))
    _eq_words(tu, ju)
    _eq_words(tt, jt)
    tbatch, tmask = tsecure.gb_step1(tsnd, tu, torch.from_numpy(x), gseed)
    for a, b in zip(tbatch[:2], jbatch[:2]):
        _eq_words(a, b)
    np.testing.assert_array_equal(tbatch.decode.numpy(), np.asarray(jbatch.decode))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    te = tsecure.ev_step2(tbatch, tt, B, S)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy() ^ tmask.numpy(), (x == y).all(axis=1))
    tu2, tt2, tidx0 = tsecure.ev_step3(trcv, te)
    assert tidx0 == jidx0 == 333 + B * S
    _eq_words(tu2, ju2)
    _eq_words(tt2, jt2)
    tc0, tc1, tr1 = tsecure.gb_step2(tsnd, tu2, tmask, bseed, tf, garbler)
    _eq_words(tc0, jc0)
    _eq_words(tc1, jc1)
    np.testing.assert_array_equal(_field_np(field, tr1), np.asarray(jr1))
    tv = tsecure.ev_step4(trcv, tt2, tidx0, tc0, tc1, te, tf)
    np.testing.assert_array_equal(_field_np(field, tv), np.asarray(jv))
    # the b2a cores the mesh calls give the same words on the same rows
    with torch_ref.installed():
        jb = jsecure.b2a_encrypt(jf, jt2 ^ (np.asarray(je)[:, None] * tsnd.s_block),
                                 tsnd.s_block, jmask, bseed, jidx0, garbler)
        jd = jsecure.b2a_decrypt(jf, jt2, jidx0, jb[0], jb[1], je)
    tq2 = tt2 ^ torch.where(te[:, None], _w(tsnd.s_block), 0)
    tb = tsecure.b2a_encrypt(tf, tq2, tsnd.s_block, tmask, bseed, tidx0, garbler)
    _eq_words(tb[0], jc0)
    _eq_words(tb[1], jc1)
    _eq_words(tb[0], jb[0])
    np.testing.assert_array_equal(_field_np(field, tb[2]), np.asarray(jb[2]))
    td = tsecure.b2a_decrypt(tf, tt2, tidx0, tb[0], tb[1], te)
    np.testing.assert_array_equal(_field_np(field, td), np.asarray(jd))
    # v_server0 - v_server1 = [x == y] whichever server garbled
    sh = (tr1, tv) if garbler == 0 else (tv, tr1)
    diff = tf.sub(sh[0], sh[1])
    eq = (x == y).all(axis=1)
    if field == "FE62":
        np.testing.assert_array_equal(tf.canon(diff).numpy(), eq)
    else:
        np.testing.assert_array_equal(words_to_numpy(diff)[:, 0], eq)


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_ot2s_test_major_matches_jax(S, W):
    """The test-major table through the ot2s kernels' wrappers against the
    JAX package's ``ot2s_encrypt`` / ``ot2s_decrypt``; ``ot4_*`` are views."""
    rng = np.random.default_rng(50 + S * 10 + W)
    B, idx0 = 500, 2**32 - 200  # the pad index wraps inside the batch
    s = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s[0] |= 1
    q = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    x, y, _ = _strings(60 + S, B, S)
    m0 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    m1 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    t = q ^ (y[..., None] * s)
    jcts = jsecure.ot2s_encrypt(q, s, x, m0, m1, W, idx0)
    jpay = jsecure.ot2s_decrypt(t, y, jcts, W, idx0)
    tcts = tsecure.ot2s_encrypt(_w(q), s, torch.from_numpy(x), _w(m0), _w(m1), W, idx0)
    assert tcts.shape == (1 << S, B, W)
    _eq_words(tcts, jcts)
    tpay = tsecure.ot2s_decrypt(_w(t), torch.from_numpy(y), tcts, W, idx0)
    _eq_words(tpay, jpay)
    np.testing.assert_array_equal(words_to_numpy(tpay),
                                  np.where((x == y).all(1)[:, None], m1, m0))
    _eq_words(tsecure.ot4_encrypt(_w(q), s, torch.from_numpy(x), _w(m0), _w(m1), W, idx0),
              jcts)
    _eq_words(tsecure.ot4_decrypt(_w(t), torch.from_numpy(y), tcts, W, idx0), jpay)


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("garbler", [0, 1])
def test_ot4_steps_match_jax(field, garbler):
    tf, jf = FIELDS[field]
    (tsnd, trcv), (jsnd, jrcv) = _sessions(30 + garbler)
    B, S = 400, 2
    x, y, (_, bseed) = _strings(31, B, S)
    with torch_ref.installed():
        ju, jt, jidx0 = jsecure.ev_step1_fused(jrcv, y)
        jcts, jr1 = jsecure.gb_step_ot4(jsnd, ju, x, bseed, jf, garbler)
        jv = jsecure.ev_open_ot4(jrcv, jt, y, np.asarray(jcts).ravel(), B, jf, jidx0)
    tu, tt, tidx0 = tsecure.ev_step1_fused(trcv, torch.from_numpy(y))
    tcts, tr1 = tsecure.gb_step_ot4(tsnd, tu, torch.from_numpy(x), bseed, tf, garbler)
    _eq_words(tcts, jcts)
    np.testing.assert_array_equal(_field_np(field, tr1), np.asarray(jr1))
    tv = tsecure.ev_open_ot4(trcv, tt, torch.from_numpy(y), tcts.reshape(-1), B, tf, tidx0)
    np.testing.assert_array_equal(_field_np(field, tv), np.asarray(jv))
    with pytest.raises(ValueError, match="S == 2"):
        tsecure.gb_step_ot4(tsnd, tu, torch.zeros((B, 4), dtype=torch.bool), bseed, tf)


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("garbler", [0, 1])
@pytest.mark.parametrize("S", [2, 4])
def test_fused_flat_wire_matches_jax(field, garbler, S):
    """``gb_step_fused`` / ``ev_open_fused`` (K2 on the flat wire) and the
    packing helpers, byte for byte."""
    tf, jf = FIELDS[field]
    (tsnd, trcv), (jsnd, jrcv) = _sessions(40 + S + garbler)
    B = 350
    x, y, (gseed, bseed) = _strings(41 + S, B, S)
    with torch_ref.installed():
        ju, jt, jidx0 = jsecure.ev_step1_fused(jrcv, y)
        jmsg, jr1 = jsecure.gb_step_fused(jsnd, ju, x, gseed, bseed, jf, garbler)
        jv = jsecure.ev_open_fused(jrcv, jt, jmsg, B, S, jf, jidx0)
    tu, tt, tidx0 = tsecure.ev_step1_fused(trcv, torch.from_numpy(y))
    tmsg, tr1 = tsecure.gb_step_fused(tsnd, tu, torch.from_numpy(x), gseed, bseed, tf,
                                      garbler)
    _eq_words(tmsg, jmsg)
    np.testing.assert_array_equal(_field_np(field, tr1), np.asarray(jr1))
    tv = tsecure.ev_open_fused(trcv, tt, tmsg, B, S, tf, tidx0)
    np.testing.assert_array_equal(_field_np(field, tv), np.asarray(jv))
    W = tsecure.payload_words(tf)
    batch, cts = tsecure.unpack_gc_payload_batch(tmsg, B, S, W)
    assert cts.shape == (2, B, W)
    assert torch.equal(tsecure.pack_gc_payload_batch(batch, cts), tmsg)
    with torch_ref.installed():
        jb = jsecure.unpack_gc_batch(np.asarray(jmsg)[:B * (S - 1) * 8 + B * S * 4 + B], B, S)
    tb = tsecure.unpack_gc_batch(tsecure.pack_gc_batch(batch), B, S)
    for a, b in zip(tb[:2], jb[:2]):
        _eq_words(a, b)
    np.testing.assert_array_equal(tb.decode.numpy(), np.asarray(jb.decode))


def test_garble_equality_matches_jax():
    """The seed-only garble and its evaluator label pairs."""
    B, S = 257, 5
    x, y, (seed, _) = _strings(70, B, S)
    jbatch, jsec = jgc.garble_equality(seed, x)
    tbatch, tsec = tgc.garble_equality(seed, torch.from_numpy(x))
    for a, b in zip(tbatch[:2], jbatch[:2]):
        _eq_words(a, b)
    np.testing.assert_array_equal(tbatch.decode.numpy(), np.asarray(jbatch.decode))
    np.testing.assert_array_equal(tsec.mask.numpy(), np.asarray(jsec.mask))
    _eq_words(tsec.ev_label0, jsec.ev_label0)
    _eq_words(tsec.ev_label1, jsec.ev_label1)
    labels = torch.where(torch.from_numpy(y)[..., None], tsec.ev_label1, tsec.ev_label0)
    e = tgc.eval_equality(tbatch, labels)
    np.testing.assert_array_equal(e.numpy() ^ tsec.mask.numpy(), (x == y).all(axis=1))


@pytest.mark.parametrize("S", [1, 2, 3, 6])
def test_delta_garble_and_eval_match_jax(S):
    """``garble_equality_delta`` / ``eval_equality``: the GC kernels'
    wrappers with zero payloads at S >= 2 (odd S too), plain at S = 1."""
    rng = np.random.default_rng(80 + S)
    B = 333
    R = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    R[0] |= 1
    Y0 = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    x, y, (seed, _) = _strings(81 + S, B, S)
    evl = Y0 ^ (y[..., None] * R)
    jbatch, jmask = jgc.garble_equality_delta(R, Y0, seed, x)
    je = jgc.eval_equality(jbatch, evl)
    tbatch, tmask = tgc.garble_equality_delta(R, _w(Y0), seed, torch.from_numpy(x))
    for a, b in zip(tbatch[:2], jbatch[:2]):
        _eq_words(a, b)
    np.testing.assert_array_equal(tbatch.decode.numpy(), np.asarray(jbatch.decode))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    te = tgc.eval_equality(tbatch, _w(evl))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("W", [4, 8])
def test_payload_pair_k2_matches_jax(S, W):
    """K2: the test-major payload garble and eval against the JAX package's
    XLA twins and (S >= 2) its Pallas kernels run op by op; the port's plain
    twins against the same."""
    rng = np.random.default_rng(90 + 10 * S + W)
    B, idx0 = 300, 2**32 - 100
    R = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    R[0] |= 1
    Y0 = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    x, y, (seed, _) = _strings(91 + S, B, S)
    m0 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    m1 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    evl = Y0 ^ (y[..., None] * R)
    with torch_ref.installed():
        jb, jcts, jmask = jgc._garble_equality_payload_xla(R, Y0, seed, x, m0, m1, W, idx0)
        je, jpay = jgc._eval_equality_payload_xla(jb, evl, jcts, W, idx0)
        want = [(jb, jcts, jmask, je, jpay)]
        if S >= 2:
            with torch_ref.pallas_eager():
                pb, pcts, pmask = jgc_pallas.garble_equality_payload(R, Y0, seed, x, m0, m1,
                                                                    W, idx0)
                pe, ppay = jgc_pallas.eval_equality_payload(jb, evl, jcts, W, idx0)
            want.append((pb, pcts, pmask, pe, ppay))
    args = (R, _w(Y0), seed, torch.from_numpy(x), _w(m0), _w(m1), W, idx0)
    for garble, evaluate in ((tgc.garble_equality_payload, tgc.eval_equality_payload),
                             (tgc._garble_equality_payload_plain,
                              tgc._eval_equality_payload_plain)):
        tb, tcts, tmask = garble(*args)
        te, tpay = evaluate(tb, _w(evl), tcts, W, idx0)
        for b, cts, mask, e, pay in want:
            for a, c in zip(tb[:2], b[:2]):
                _eq_words(a, c)
            np.testing.assert_array_equal(tb.decode.numpy(), np.asarray(b.decode))
            _eq_words(tcts, cts)
            np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
            np.testing.assert_array_equal(te.numpy(), np.asarray(e))
            _eq_words(tpay, pay)
    eq = (x == y).all(axis=1)
    np.testing.assert_array_equal(words_to_numpy(tpay), np.where(eq[:, None], m1, m0))


@pytest.mark.parametrize("eq_ot4", [True, False])
def test_ot_path_follows_eq_ot4(eq_ot4, monkeypatch):
    monkeypatch.setattr(tsecure, "EQ_OT4", eq_ot4)
    monkeypatch.setattr(jsecure, "EQ_OT4", eq_ot4)
    for S in (1, 2, 4, 6, 8):
        assert tsecure.ot_path(S) == jsecure.ot_path(S)
        assert tsecure._ot4_use(S) == jsecure._ot4_use(S)
        for forced in ("gc", "ot2s"):
            if forced == "ot2s" and S > tsecure.OT2S_MAX_S:
                with pytest.raises(ValueError):
                    tsecure.ot_path(S, forced)
            else:
                assert tsecure.ot_path(S, forced) == jsecure.ot_path(S, forced) == forced
