"""The PyTorch port's payload DPF (``fuzzyheavyhitters_torch/ops/dpf.py``)
against the JAX package's ``ops/dpf.py``, tolerance zero: ``convert`` in
both fields, ``gen_pair`` at d = 1 and d = 2, ``eval_bit`` at every level
along random paths (both parties' states and shares), and the one-hot
contract of ``tests/test_sketch.py`` — the parties' shares add up to the
payload at the client's prefix and to zero at every other node of every
level.  Inputs are made from ``np.random.default_rng``; FE62 values are
compared as uint64, F255 as uint32 limbs."""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import dpf as tdpf
from fuzzyheavyhitters_torch.ops import fields as tf
from fuzzyheavyhitters_torch.protocol import sketch as tsketch
from fuzzyheavyhitters_torch.utils import words_from_numpy

(jdpf, jf, jsketch) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.ops.dpf", "fuzzyheavyhitters_tpu.ops.fields",
    "fuzzyheavyhitters_tpu.protocol.sketch")

N, L, LANES = 6, 5, 2  # tests/test_sketch.py's shape


def wire(t):
    return tsketch.wire(t)


def _inputs(seed, d):
    """(init seeds, alpha bits, FE62 payloads, F255 leaf payloads), numpy,
    batch [N] (d = 1 without the dim axis, as the JAX tests call it) or
    [N, d]."""
    rng = np.random.default_rng(seed)
    batch = (N,) if d == 1 else (N, d)
    seeds = rng.integers(0, 2**32, size=batch + (2, 4), dtype=np.uint32)
    alpha = rng.integers(0, 2, size=batch + (L,)).astype(bool)
    vals = rng.integers(1, 100, size=batch + (L - 1, LANES)).astype(np.uint64)
    vlast = np.asarray(jf.F255.sample(
        rng.integers(0, 2**32, size=batch + (LANES, 8), dtype=np.uint32)), np.uint32)
    return seeds, alpha, vals, vlast


def _port(seeds, alpha, vals, vlast):
    return (words_from_numpy(seeds, "cpu"), torch.from_numpy(alpha),
            torch.from_numpy(vals.view(np.int64)), words_from_numpy(vlast, "cpu"))


@pytest.mark.parametrize("field", ["FE62", "F255"])
def test_convert_matches_jax(field):
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2**32, size=(7, 3, 4), dtype=np.uint32)
    seeds[0, 0] = 0xFFFFFFFF
    with torch_ref.installed():
        want = np.asarray(jdpf.convert(seeds, getattr(jf, field), LANES))
    got = wire(tdpf.convert(words_from_numpy(seeds, "cpu"), getattr(tf, field), LANES))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2])
def test_gen_pair_matches_jax(d):
    inputs = _inputs(2 + d, d)
    with torch_ref.installed():
        jk = jdpf.gen_pair(*inputs, jf.FE62, jf.F255, LANES)
    tk = tdpf.gen_pair(*_port(*inputs), tf.FE62, tf.F255, LANES)
    for p in (0, 1):
        for name, j, t in zip(jdpf.DpfKeyBatch._fields, jk[p], tk[p]):
            j = np.asarray(j)
            got = wire(t)
            assert got.dtype == j.dtype and got.shape == j.shape, (p, name)
            np.testing.assert_array_equal(got, j, err_msg=f"party {p} {name}")


@pytest.mark.parametrize("d", [1, 2])
def test_eval_bit_matches_jax_at_every_level(d):
    """Both parties walk one random path per key: states and value shares
    equal at every level, FE62 inner levels and the F255 leaf."""
    inputs = _inputs(4 + d, d)
    dirs = np.random.default_rng(9 + d).integers(0, 2, size=inputs[1].shape).astype(bool)
    with torch_ref.installed():
        jk = jdpf.gen_pair(*inputs, jf.FE62, jf.F255, LANES)
        jwant = []
        for key in jk:
            st, out = jdpf.eval_init(key), []
            for j in range(L):
                last = j == L - 1
                cwv = key.cw_val_last if last else key.cw_val[..., j, :]
                st, sh = jdpf.eval_bit(jdpf.level_cw(key, j), st, dirs[..., j], cwv,
                                       key.key_idx, jf.F255 if last else jf.FE62, LANES)
                out.append((np.asarray(st.seed), np.asarray(st.t), np.asarray(sh)))
            jwant.append(out)
    tk = tdpf.gen_pair(*_port(*inputs), tf.FE62, tf.F255, LANES)
    tdirs = torch.from_numpy(dirs)
    for p, key in enumerate(tk):
        st = tdpf.eval_init(key)
        for j in range(L):
            last = j == L - 1
            cwv = key.cw_val_last if last else key.cw_val[..., j, :]
            st, sh = tdpf.eval_bit(tdpf.level_cw(key, j), st, tdirs[..., j], cwv, key.key_idx,
                                   tf.F255 if last else tf.FE62, LANES)
            for got, want in zip((wire(st.seed), st.t.numpy(), wire(sh)), jwant[p][j]):
                assert got.dtype == want.dtype, (p, j)
                np.testing.assert_array_equal(got, want, err_msg=f"party {p} level {j}")


@pytest.mark.parametrize("d", [1, 2])
def test_one_hot_reconstruction_and_full_levels_match_jax(d):
    """share0 + share1 is the payload at the client's prefix and 0 at every
    other node, at every level and in both fields (the BGI payload-DPF
    contract, ref: sketch.rs:8-24); each party's full-level shares equal
    the JAX package's ``eval_level_full``."""
    inputs = _inputs(6 + d, d)
    seeds, alpha, vals, vlast = inputs
    tk = tdpf.gen_pair(*_port(*inputs), tf.FE62, tf.F255, LANES)
    tsk = [tsketch.SketchKeyBatch(k, None, None, None, None, None, None) for k in tk]
    with torch_ref.installed():
        jk = jdpf.gen_pair(*inputs, jf.FE62, jf.F255, LANES)
        jsk = [jsketch.SketchKeyBatch(k, None, None, None, None, None, None) for k in jk]
        jfull = [[np.asarray(jsketch.eval_level_full(k, j, jf.FE62, jf.F255, L))
                  for j in range(L)] for k in jsk]
    flat_alpha = alpha.reshape(-1, L)
    for j in range(L):
        fld = tf.FE62 if j < L - 1 else tf.F255
        s0, s1 = (tsketch.eval_level_full(k, j, tf.FE62, tf.F255, L) for k in tsk)
        for p, s in enumerate((s0, s1)):
            np.testing.assert_array_equal(wire(s), jfull[p][j], err_msg=f"party {p} lvl {j}")
        rec = wire(fld.canon(fld.add(s0, s1)))
        rec = rec.reshape((-1,) + rec.shape[len(alpha.shape) - 1:])
        want_v = (vals[..., j, :] if j < L - 1 else vlast).reshape((-1,) + rec.shape[2:])
        for i in range(rec.shape[0]):
            idx = int("".join("1" if b else "0" for b in flat_alpha[i, :j + 1]), 2)
            want = np.zeros_like(rec[i])
            want[idx] = want_v[i]
            np.testing.assert_array_equal(rec[i], want, err_msg=f"lvl {j} key {i}")
