"""The PyTorch port's OT layer (``ops/prg.py`` streams, ``ops/baseot.py``,
``ops/otext.py``) against the JAX package, bit for bit: the CTR stream with
an offset, the packed butterfly transpose, bit packing, the IKNP extension
(both roles, a second batch at a non-zero stream offset, and the row-sliced
form against the whole), ``ot_hash`` with an index base and a domain, the
GF(2^128) helpers, and the Chou-Orlandi base OT message for message under a
seeded ``random.Random``."""

import random

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import baseot as tbaseot
from fuzzyheavyhitters_torch.ops import otext as totext
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jprg, jbaseot, jotext = torch_ref.reference(
    "fuzzyheavyhitters_tpu.ops.prg", "fuzzyheavyhitters_tpu.ops.baseot",
    "fuzzyheavyhitters_tpu.ops.otext")


def _w(a):
    return words_from_numpy(a, "cpu")


@pytest.mark.parametrize("offset", [0, 5, 2**32 - 3])
def test_stream_blocks_and_words_match_jax(offset):
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2**32, size=(3, 4), dtype=np.uint32)
    np.testing.assert_array_equal(
        words_to_numpy(tprg.stream_blocks(_w(seeds), 7, offset)),
        np.asarray(jprg.stream_blocks(seeds, 7, offset), np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tprg.stream_words(_w(seeds), 53)),
                                  np.asarray(jprg.stream_words(seeds, 53), np.uint32))


def test_stream_passes_concatenate(monkeypatch):
    seed = _w(np.random.default_rng(2).integers(0, 2**32, size=(2, 4), dtype=np.uint32))
    whole = tprg.stream_blocks(seed, 11, 9)
    monkeypatch.setattr(tprg, "STREAM_BLOCKS", 3)
    assert torch.equal(tprg.stream_blocks(seed, 11, 9), whole)


@pytest.mark.parametrize("m", [32, 100, 2049])
def test_bits_and_butterfly_match_jax(m):
    rng = np.random.default_rng(3 + m)
    bits = rng.integers(0, 2, size=(3, m)).astype(bool)
    packed = totext.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(words_to_numpy(packed),
                                  np.asarray(jotext.pack_bits(bits), np.uint32))
    assert torch.equal(totext.unpack_bits(packed, m), torch.from_numpy(bits))
    cols = rng.integers(0, 2**32, size=(128, -(-m // 32)), dtype=np.uint32)
    np.testing.assert_array_equal(
        words_to_numpy(totext._transpose_pack(_w(cols), m)),
        np.asarray(jotext._transpose_pack(cols, m), np.uint32))


def _material(seed):
    rng = random.Random(seed)
    s_bits = totext.fresh_s_bits(rng)
    seeds0, seeds1, chosen = tbaseot.exchange(s_bits, rng)
    return s_bits, seeds0, seeds1, chosen


def test_extension_matches_jax_across_batches():
    s_bits, seeds0, seeds1, chosen = _material(7)
    jsnd, jrcv = jotext.OtExtSender(s_bits, chosen), jotext.OtExtReceiver(seeds0, seeds1)
    tsnd, trcv = totext.OtExtSender(s_bits, chosen), totext.OtExtReceiver(seeds0, seeds1)
    rng = np.random.default_rng(8)
    s_block = torch.from_numpy(totext.s_to_block(s_bits).view(np.int32))
    np.testing.assert_array_equal(totext.s_to_block(s_bits), jotext.s_to_block(s_bits))
    for m in (1000, 3000, 77):  # the later batches start at non-zero stream offsets
        r = rng.integers(0, 2, size=m).astype(bool)
        ju, jt = jrcv.extend(r)
        tu, tt = trcv.extend(torch.from_numpy(r))
        np.testing.assert_array_equal(words_to_numpy(tu), np.asarray(ju, np.uint32))
        np.testing.assert_array_equal(words_to_numpy(tt), np.asarray(jt, np.uint32))
        tq = tsnd.extend(m, tu)
        np.testing.assert_array_equal(words_to_numpy(tq),
                                      np.asarray(jsnd.extend(m, ju), np.uint32))
        # Δ-OT: Q_j = T_j ^ r_j·s
        assert torch.equal(tq, tt ^ torch.where(torch.from_numpy(r)[:, None], s_block, 0))
        assert (tsnd.consumed, tsnd.stream_offset) == (jsnd.consumed, jsnd.stream_offset)
        assert (trcv.consumed, trcv.stream_offset) == (jrcv.consumed, jrcv.stream_offset)


def test_row_sliced_extension_equals_whole(monkeypatch):
    s_bits, seeds0, seeds1, chosen = _material(9)
    r = torch.from_numpy(np.random.default_rng(10).integers(0, 2, size=5000).astype(bool))
    whole = [totext.OtExtSender(s_bits, chosen), totext.OtExtReceiver(seeds0, seeds1)]
    sliced = [totext.OtExtSender(s_bits, chosen), totext.OtExtReceiver(seeds0, seeds1)]
    for snd, rcv in (whole, sliced):
        snd.extend(700, rcv.extend(r[:700])[0])  # a first batch moves the offsets
    u, t = whole[1].extend(r)
    q = whole[0].extend(5000, u)
    monkeypatch.setattr(totext, "EXT_ROWS", 1024)
    u2, t2 = sliced[1].extend(r)
    assert torch.equal(u2, u) and torch.equal(t2, t)
    assert torch.equal(sliced[0].extend(5000, u2), q)


@pytest.mark.parametrize("domain", [0, 0x0F4E4F54])
@pytest.mark.parametrize("idx0", [0, 977, 2**32 - 5])
def test_ot_hash_matches_jax(domain, idx0):
    rows = np.random.default_rng(11).integers(0, 2**32, size=(2, 50, 4), dtype=np.uint32)
    want = np.asarray(jotext.ot_hash(rows, 8, idx0, domain=domain), np.uint32)
    got = totext.ot_hash(_w(rows), 8, idx0, domain=domain)
    np.testing.assert_array_equal(words_to_numpy(got), want)


def test_ot_index_past_2_32_wraps():
    """A session past 2^32 OTs: the port reduces the index mod 2^32 (the
    JAX package's uint32 index cannot hold it)."""
    rows = _w(np.random.default_rng(12).integers(0, 2**32, size=(9, 4), dtype=np.uint32))
    assert torch.equal(totext.ot_hash(rows, 4, 2**32 + 5), totext.ot_hash(rows, 4, 5))


@pytest.mark.parametrize("S", [1, 2, 4, 6])
def test_gf128_helpers_match_jax(S):
    rng = np.random.default_rng(13 + S)
    x = rng.integers(0, 2**32, size=(16, 4), dtype=np.uint32)
    x[0] = [0, 0, 0, 0x80000000]  # the reduction bit
    np.testing.assert_array_equal(words_to_numpy(totext.gf128_double(_w(x))),
                                  np.asarray(jotext.gf128_double(x), np.uint32))
    rows = rng.integers(0, 2**32, size=(5, S, 4), dtype=np.uint32)
    np.testing.assert_array_equal(words_to_numpy(totext.gf128_comb(_w(rows))),
                                  np.asarray(jotext.gf128_comb(rows), np.uint32))
    s = x[1] | np.uint32(1)
    np.testing.assert_array_equal(words_to_numpy(totext.gf128_offsets(_w(s), S)),
                                  np.asarray(jotext.gf128_offsets(s, S), np.uint32))


def test_base_ot_matches_jax_message_for_message():
    choices = np.random.default_rng(14).integers(0, 2, size=12).astype(bool)
    tr, jr = random.Random(15), random.Random(15)
    tsnd, jsnd = tbaseot.BaseOtSender(tr), jbaseot.BaseOtSender(jr)
    assert tsnd.round1() == jsnd.round1()
    trcv, jrcv = tbaseot.BaseOtReceiver(choices, tr), jbaseot.BaseOtReceiver(choices, jr)
    tmsg, jmsg = trcv.round1(tsnd.round1()), jrcv.round1(jsnd.round1())
    assert tmsg == jmsg
    ts0, ts1 = tsnd.seeds([tbaseot.decompress(m) for m in tmsg])
    js0, js1 = jsnd.seeds([jbaseot.decompress(m) for m in jmsg])
    np.testing.assert_array_equal(ts0, js0)
    np.testing.assert_array_equal(ts1, js1)
    chosen = trcv.seeds()
    np.testing.assert_array_equal(chosen, jrcv.seeds())
    np.testing.assert_array_equal(chosen, np.where(choices[:, None], ts1, ts0))
    with pytest.raises(ValueError):
        tbaseot.decompress(b"\xff" * 32)


def test_exchange_and_inprocess_pair():
    s_bits = totext.fresh_s_bits(random.Random(16))
    assert s_bits[0] and s_bits.shape == (128,)
    s0, s1, chosen = tbaseot.exchange(s_bits, random.Random(17))
    np.testing.assert_array_equal(chosen, np.where(s_bits[:, None], s1, s0))
    snd, rcv = totext.inprocess_pair("cpu", random.Random(18))
    r = torch.from_numpy(np.random.default_rng(19).integers(0, 2, size=300).astype(bool))
    u, t = rcv.extend(r)
    s_block = torch.from_numpy(snd.s_block.view(np.int32))
    assert torch.equal(snd.extend(300, u), t ^ torch.where(r[:, None], s_block, 0))
    with pytest.raises(ValueError):
        totext.OtExtSender(np.zeros(128, bool), chosen)
