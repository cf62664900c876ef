"""The PyTorch port's frontier expansion (plain version of the CUDA kernel in
``fuzzyheavyhitters_torch/csrc/expand.cu``) and its crawl helpers against
the JAX package's XLA engine, bit for bit: packed share bits, the
both-direction child cache, the gather-advance, counts, masks and
survivor compaction.  The JAX engine keeps the interleaved layout on the
CPU, so its frontiers cross into the port through ``states_from_numpy``
(plane-major) and the port's results go back through ``to_interleaved``."""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import expand_cuda
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.utils import words_to_numpy

jibdcf, jprg, jcollect = torch_ref.reference(
    "fuzzyheavyhitters_tpu.ops.ibdcf", "fuzzyheavyhitters_tpu.ops.prg",
    "fuzzyheavyhitters_tpu.protocol.collect")


@pytest.fixture
def bit_mode(request, monkeypatch):
    monkeypatch.setattr(jprg, "DERIVED_BITS", request.param)
    monkeypatch.setattr(tprg, "DERIVED_BITS", request.param)
    return request.param


def _keys(rng, n, d, L, ball=2):
    pts = rng.integers(0, 1 << L, size=(n, d))
    bits = ((pts[..., None] >> np.arange(L - 1, -1, -1)) & 1) > 0
    return jibdcf.gen_l_inf_ball(bits, ball, rng, engine="np")


def _jax_frontier(k, d, rng, derived):
    """A JAX interleaved frontier of 4 distinct nodes at depth 1."""
    f0 = jcollect.tree_init(k, 4, planar=False)
    cw = jibdcf.level_cw(k, 0)
    _, ch = jcollect._expand_body(cw, f0, derived, True, False)
    parent = np.array([0, 0, 0, 0], np.int32)
    pat = rng.integers(0, 2, size=(4, d)).astype(bool)
    return jcollect._advance_children_jit(ch, parent, pat, 3, planar=False)


def _children_to_interleaved(ch):
    """Port PlanarChildren -> (seed [F, N, d, 2, dir, 4], bit/y [.., dir])."""
    seed = words_to_numpy(ch.seed.permute(4, 5, 2, 3, 0, 1))
    fl = ch.flags.permute(2, 3, 0, 1).numpy()  # [F, N, d, 2]
    bit = np.stack([(fl & 1) != 0, (fl & 2) != 0], axis=-1)
    y = np.stack([(fl & 4) != 0, (fl & 8) != 0], axis=-1)
    return seed, bit, y


@pytest.mark.parametrize("bit_mode", [False, True], indirect=True)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_expand_matches_jax_xla_engine(bit_mode, d):
    rng = np.random.default_rng(20 + d)
    n, L = 29, 7
    k0, _ = _keys(rng, n, d, L)
    jf = _jax_frontier(k0, d, rng, bit_mode)
    tk = tibdcf.keys_from_numpy(k0, "cpu")
    tf = tcollect.Frontier(
        states=tcollect.states_from_numpy(jf.states, "cpu"),
        alive=torch.from_numpy(np.array(jf.alive)))
    for lvl in (1, 5):
        jp, jch = jcollect._expand_body(
            jibdcf.level_cw(k0, lvl), jf, bit_mode, True, False)
        tp, tch = tcollect.expand_share_bits(tk, tf, lvl)
        np.testing.assert_array_equal(words_to_numpy(tp), np.asarray(jp, np.uint32))
        seed, bit, y = _children_to_interleaved(tch)
        np.testing.assert_array_equal(seed, np.asarray(jch.seed, np.uint32))
        np.testing.assert_array_equal(bit, np.asarray(jch.bit, bool))
        np.testing.assert_array_equal(y, np.asarray(jch.y_bit, bool))
        tp_only, none = tcollect.expand_share_bits(tk, tf, lvl, want_children=False)
        assert none is None and torch.equal(tp_only, tp)


@pytest.mark.parametrize("d", [1, 2])
def test_advance_from_children_matches_jax(d):
    rng = np.random.default_rng(40 + d)
    n, L = 23, 6
    k0, _ = _keys(rng, n, d, L)
    jf = _jax_frontier(k0, d, rng, True)
    _, jch = jcollect._expand_body(jibdcf.level_cw(k0, 1), jf, True, True, False)
    tk = tibdcf.keys_from_numpy(k0, "cpu")
    tf = tcollect.Frontier(tcollect.states_from_numpy(jf.states, "cpu"),
                           torch.from_numpy(np.array(jf.alive)))
    _, tch = tcollect.expand_share_bits(tk, tf, 1)
    parent = np.array([2, 0, 3, 1, 1, 0, 0, 0], np.int32)
    pat = rng.integers(0, 2, size=(8, d)).astype(bool)
    ja = jcollect._advance_children_jit(jch, parent, pat, 5, planar=False)
    ta = tcollect.advance_from_children(
        tch, torch.from_numpy(parent.astype(np.int64)), torch.from_numpy(pat), 5)
    ti = tcollect.to_interleaved(ta.states)
    np.testing.assert_array_equal(words_to_numpy(ti.seed), np.asarray(ja.states.seed, np.uint32))
    np.testing.assert_array_equal(ti.bit.numpy(), np.asarray(ja.states.bit))
    np.testing.assert_array_equal(ti.y_bit.numpy(), np.asarray(ja.states.y_bit))
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))


def test_tree_init_matches_jax_planar(rng):
    k0, _ = _keys(rng, 17, 2, 5)
    jf = jcollect.tree_init(k0, 4, planar=True)
    tf = tcollect.tree_init(tibdcf.keys_from_numpy(k0, "cpu"), 4)
    np.testing.assert_array_equal(words_to_numpy(tf.states.seed),
                                  np.asarray(jf.states.seed, np.uint32))
    np.testing.assert_array_equal(tf.states.bit.numpy(), np.asarray(jf.states.bit))
    np.testing.assert_array_equal(tf.states.y_bit.numpy(), np.asarray(jf.states.y_bit))
    np.testing.assert_array_equal(tf.alive.numpy(), np.asarray(jf.alive))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_counts_by_pattern_matches_jax(d):
    rng = np.random.default_rng(60 + d)
    F, n = 8, 53
    p0 = rng.integers(0, 1 << 32, size=(F, n), dtype=np.uint32)
    p1 = p0 ^ (rng.integers(0, 1 << (4 * d), size=(F, n)).astype(np.uint32)
               * rng.integers(0, 2, size=(F, n)).astype(np.uint32))
    alive_k = rng.integers(0, 4, size=n) > 0
    alive_n = np.arange(F) < 6
    masks = jcollect.pattern_masks(d)
    want = np.asarray(jcollect.counts_by_pattern(p0, p1, masks, alive_k, alive_n))
    got = tcollect.counts_by_pattern(
        torch.from_numpy(p0.view(np.int32)), torch.from_numpy(p1.view(np.int32)),
        tcollect.pattern_masks(d), torch.from_numpy(alive_k), torch.from_numpy(alive_n))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_masks_and_compaction_match_jax(rng):
    for d in range(1, 9):
        np.testing.assert_array_equal(tcollect.pattern_masks(d), jcollect.pattern_masks(d))
        np.testing.assert_array_equal(tcollect._bit_positions(d), jcollect._bit_positions(d))
    keep = rng.integers(0, 2, size=(16, 4)).astype(bool)
    for f_max in (64, 40):
        for a, b in zip(tcollect.compact_survivors(keep, f_max),
                        jcollect.compact_survivors(keep, f_max)):
            np.testing.assert_array_equal(a, b)
    pattern = rng.integers(0, 8, size=10).astype(np.int32)
    np.testing.assert_array_equal(tcollect.pattern_to_bits(pattern, 3),
                                  jcollect.pattern_to_bits(pattern, 3))
    for n_alive in (0, 1, 5, 33, 64):
        assert tcollect.bucket_for(n_alive, 64) == jcollect.bucket_for(n_alive, 64)
    with pytest.raises(ValueError, match="exceed f_max=8"):
        tcollect.compact_survivors(np.ones((4, 4), bool), 8)


def test_plain_expand_row_slices_equal_whole(rng):
    """The plain version on row slices (``row0``) equals one whole call —
    the slicing the on-card check uses when the plain version must fit."""
    d2, F, n = 4, 3, 11
    B = F * n
    seed = torch.from_numpy(rng.integers(-2**31, 2**31, size=(4, d2, B)).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, 2, size=(d2, B)).astype(bool))
    y = torch.from_numpy(rng.integers(0, 2, size=(d2, B)).astype(bool))
    cws = torch.from_numpy(rng.integers(-2**31, 2**31, size=(4, d2, n)).astype(np.int32))
    cwf = torch.from_numpy(rng.integers(0, 16, size=(d2, n)).astype(np.uint8))
    whole = expand_cuda.expand_packed(seed, t, y, cws, cwf, True)
    for lo, hi in ((0, 7), (7, 20), (20, B)):
        part = expand_cuda.expand_packed_plain(
            seed[..., lo:hi], t[:, lo:hi], y[:, lo:hi], cws, cwf, True, row0=lo)
        assert torch.equal(part[0], whole[0][lo:hi])
        assert torch.equal(part[1], whole[1][..., lo:hi])
        assert torch.equal(part[2], whole[2][:, lo:hi])
    with pytest.raises(ValueError):
        expand_cuda.expand_packed(seed[..., :-1], t[:, :-1], y[:, :-1], cws, cwf)
