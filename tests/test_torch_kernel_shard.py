"""The PyTorch port's row-sharded secure kernel stage
(``parallel/kernel_shard.py``, K3) against the JAX package's
``parallel/kernel_shard.py``, tolerance zero.

At B a few planar blocks less a remainder — the last shard holds pad rows
and B·S straddles a u word — and k in {1, 2, 4} shards, on the ot2s table
and the garbled circuit, FE62 and F255:

- the u matrix and the frame of ``run_level_pair`` are byte-equal to the
  JAX ``run_level_pair``'s (its shards on the conftest's virtual CPU
  devices, its XLA twins) and to the port's whole-level path (k = 1:
  ``secure.ev_step1_fused`` / ``gb_step_level`` / ``ev_open_level``);
- both parties' b2a values equal, test by test, and the folded share sums
  equal the whole level's;
- both sessions' cursors advance in lockstep with a whole-level extend;
- ``gc._carve_label_words_shard`` gives the JAX slices, with a seek past
  2^32 words, and the whole draw's slice;
- ``kernel_shards``/``bind`` degrade as the JAX package's.

The JAX package's functions run inside ``torch_ref.installed()``."""

import numpy as np
import pytest
import torch

import fuzzyheavyhitters_tpu.ops.fields  # noqa: F401  (one fields module under every torch_ref
# load, whatever other files a worker collects: the JAX functions compare field classes by
# identity, and tests/test_fields.py imports it so in a whole run)
import torch_ref
from fuzzyheavyhitters_torch.ops import gc as tgc
from fuzzyheavyhitters_torch.ops import otext as totext
from fuzzyheavyhitters_torch.ops.fields import F255, FE62
from fuzzyheavyhitters_torch.parallel import kernel_shard as tks
from fuzzyheavyhitters_torch.parallel.server_mesh import Sharded
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

(jks, jotext, jgc, jfields) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.parallel.kernel_shard", "fuzzyheavyhitters_tpu.ops.otext",
    "fuzzyheavyhitters_tpu.ops.gc", "fuzzyheavyhitters_tpu.ops.fields")

import jax  # noqa: E402  (after the reference import, as the other parity tests)

BLK = tks.BLOCK
B, S = 4 * BLK - 1234, 2  # 4 blocks, the last with 1,234 pad rows; B·S % 32 = 28
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _material(seed):
    """Base-OT material of one session: (s_bits, chosen, seeds0, seeds1)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2, 128).astype(bool)
    s[0] = True
    seeds0 = rng.integers(0, 2**32, size=(128, 4), dtype=np.uint32)
    seeds1 = rng.integers(0, 2**32, size=(128, 4), dtype=np.uint32)
    return s, np.where(s[:, None], seeds1, seeds0), seeds0, seeds1


def _port_pair(mat):
    s, chosen, s0, s1 = mat
    return totext.OtExtSender(s, chosen, CPU), totext.OtExtReceiver(s0, s1, CPU)


def _strings(seed, b=B, s=S):
    """Both servers' strings bool[b, s]: equal on about half the tests."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (b, s)).astype(bool)
    y = np.where(rng.random((b, 1)) < 0.5, x, rng.integers(0, 2, (b, s)).astype(bool))
    return x, y


def _shard_flat(x, ks):
    pad = np.zeros((ks.bp, x.shape[1]), bool)
    pad[:x.shape[0]] = x
    return Sharded([torch.from_numpy(pad[j * ks.bloc:(j + 1) * ks.bloc].copy())
                    for j in range(ks.k)], 0)


SEEDS = (np.array([1, 2, 3, 4], np.uint32), np.array([9, 8, 7, 0xFFFFFFFF], np.uint32))


def _port_whole(mat, x, y, field, garbler, path):
    """The port's whole-level path: (u, frame, sender values, receiver values)."""
    snd, rcv = _port_pair(mat)
    b, s = x.shape
    u, t, idx0 = tsecure.ev_step1_fused(rcv, torch.from_numpy(y))
    u_np = words_to_numpy(u)
    msg, vs = tsecure.gb_step_level(snd, words_from_numpy(u_np, CPU), torch.from_numpy(x),
                                    *SEEDS, field, garbler, path)
    vr = tsecure.ev_open_level(t, torch.from_numpy(y), msg, b, s, field, idx0, path)
    return u_np, words_to_numpy(msg), vs, vr, (snd, rcv)


def _port_sharded(mat, x, y, field, garbler, path, k):
    snd, rcv = _port_pair(mat)
    ks = tks.KernelShard(devices=(CPU,) * k, B=x.shape[0], S=x.shape[1])
    u, m, vs, vr = tks.run_level_pair(ks, snd, rcv, _shard_flat(x, ks), _shard_flat(y, ks),
                                      *SEEDS, field, garbler, path)
    return u, m, vs, vr, (snd, rcv), ks


def _jax_sharded(mat, x, y, field_name, garbler, path, k):
    s, chosen, s0, s1 = mat
    with torch_ref.installed():
        snd, rcv = jotext.OtExtSender(s, chosen), jotext.OtExtReceiver(s0, s1)
        ks = jks.KernelShard(devices=tuple(jax.devices()[:k]), B=x.shape[0], S=x.shape[1])
        field = getattr(jfields, field_name)
        flat = lambda a: jax.device_put(
            np.concatenate([a, np.zeros((ks.bp - a.shape[0], a.shape[1]), bool)]),
            ks.sharding(jax.sharding.PartitionSpec(jks.DATA, None)))
        u, m, vs, vr = jks.run_level_pair(ks, snd, rcv, flat(x), flat(y), *SEEDS, field,
                                          garbler, path)
        return np.asarray(u), np.asarray(m), np.asarray(vs), np.asarray(vr), (snd, rcv)


def _vals_np(field, v):
    """Port field values in the JAX package's dtypes."""
    t = torch.cat(list(v)) if isinstance(v, Sharded) else v
    return t.numpy().view(np.uint64) if field is FE62 else t.numpy().view(np.uint32)


@pytest.mark.parametrize("path,field", [("ot2s", FE62), ("ot2s", F255), ("gc", FE62),
                                        ("gc", F255)])
def test_sharded_level_is_the_whole_level_and_the_jax_stage(path, field):
    mat = _material(11)
    x, y = _strings(12)
    garbler = 1 if field is FE62 else 0
    u1, m1, vs1, vr1, (snd1, rcv1) = _port_whole(mat, x, y, field, garbler, path)
    assert u1.shape == (128, -(-B * S // 32))
    for k in (1, 2, 4):
        u, m, vs, vr, (snd, rcv), ks = _port_sharded(mat, x, y, field, garbler, path, k)
        assert ks.k == k and ks.bp == 4 * BLK
        np.testing.assert_array_equal(u, u1)
        assert m.dtype == np.uint32 and m.tobytes() == m1.tobytes()
        np.testing.assert_array_equal(_vals_np(field, vs)[:B], _vals_np(field, vs1))
        np.testing.assert_array_equal(_vals_np(field, vr)[:B], _vals_np(field, vr1))
        # the sessions' cursors: a whole-level extend's, on both sides
        for a, b in ((snd, snd1), (rcv, rcv1)):
            assert (a.consumed, a.stream_offset) == (b.consumed, b.stream_offset) == (
                B * S, totext._stream_blocks(B * S))
    for k in (1, 2, 4):
        ju, jm, jvs, jvr, (jsnd, jrcv) = _jax_sharded(mat, x, y, field.__name__, garbler,
                                                      path, k)
        np.testing.assert_array_equal(ju, u1)
        assert jm.tobytes() == m1.tobytes()
        np.testing.assert_array_equal(jvs.reshape(-1, *field.limb_shape)[:B],
                                      _vals_np(field, vs1))
        np.testing.assert_array_equal(jvr.reshape(-1, *field.limb_shape)[:B],
                                      _vals_np(field, vr1))
        assert (jsnd.consumed, jrcv.consumed) == (B * S, B * S)


def test_share_sums_fold_to_the_whole_level():
    """Shards whose tests straddle node rows fold, with ``field_psum``, to
    the whole level's per-(node, pattern) sums, in both fields."""
    F, C, N = 3, 4, 2731  # B = 32,772: five blocks, rows straddling shards
    b = F * C * N
    ks = tks.bind((CPU,) * 8, b, 2, 8)
    assert ks.k == 5
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.random((F, C, N)) < 0.7)
    for field in (FE62, F255):
        words = rng.integers(0, 2**32, size=(ks.bp, 8 if field is F255 else 4),
                             dtype=np.uint32)
        vals = tsecure.words_to_field(field, words_from_numpy(words, CPU))
        parts = Sharded([vals[j * ks.bloc:(j + 1) * ks.bloc] for j in range(ks.k)], 0)
        whole = tsecure.node_share_sums(field, vals[:b].reshape((F, C, N) + field.limb_shape),
                                        w)
        got = tks.share_sums(ks, field, parts, w, F, C, N)
        assert torch.equal(field.canon(got), field.canon(whole))


@pytest.mark.parametrize("t0,b,s,bloc", [(0, 3 * BLK, 4, BLK), (BLK, 2 * BLK - 5, 2, BLK),
                                         (2 * BLK, 2 * BLK + 100, 4, BLK),
                                         (1 << 28, (1 << 28) + 3000, 4, BLK)])
def test_carve_label_words_shard_matches_jax(t0, b, s, bloc):
    """The shard's label and mask slices equal the JAX package's; the last
    case seeks past 2^32 words (t0·S·4 = 2^32) and past B (pad rows carve to
    zero)."""
    seed = np.array([5, 6, 7, 8], np.uint32)
    X0, mask = tgc._carve_label_words_shard(words_from_numpy(seed, CPU), b, s, t0, bloc)
    with torch_ref.installed():
        jX0, jmask = jgc._carve_label_words_shard(seed, b, s, t0, bloc)
    np.testing.assert_array_equal(words_to_numpy(X0), np.asarray(jX0))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    live = np.arange(t0, t0 + bloc) < b
    assert not words_to_numpy(X0)[~live].any() and not mask.numpy()[~live].any()
    if b < 1 << 20:  # against the whole draw
        _, (wX0,), wmask = tgc._carve_label_words(words_from_numpy(seed, CPU), b, s, 1, False)
        n = int(live.sum())
        assert torch.equal(X0[:n], wX0[t0:t0 + n]) and torch.equal(mask[:n], wmask[t0:t0 + n])


def test_kernel_shard_binding_degrades():
    """A non-dividing planar batch degrades to fewer kernel shards, down to
    the gather path (None), as the JAX package's (test_multichip.py:276-292)."""
    assert tks.kernel_shards(8 * BLK, 8) == 8
    assert tks.kernel_shards(6 * BLK, 4) == 3
    assert tks.kernel_shards(3 * BLK, 2) == 1
    assert tks.kernel_shards(BLK - 5, 8) == 1
    assert tks.kernel_shards(2 * BLK, 0) == 1
    assert tks.kernel_shards(8 * BLK - 1234, 4) == 4
    for b in (1, BLK, 5 * BLK + 1, 12 * BLK - 1, 30 * BLK):
        for budget in range(0, 9):
            assert tks.kernel_shards(b, budget) == jks.kernel_shards(b, budget)
    devs = (CPU,) * 4
    assert tks.bind(devs, BLK, 2, 4) is None
    ks = tks.bind(devs, 2 * BLK - 7, 2, 4)
    assert ks is not None and ks.k == 2 and ks.bp == 2 * BLK and ks.bloc == BLK
    for path, s, w in (("ot2s", 4, 4), ("gc", 8, 8), ("gc", 2, 4)):
        assert tks.n_msg_planes(path, s, w) == jks.n_msg_planes(path, s, w)
