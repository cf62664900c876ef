"""The PyTorch port's 1-of-2^S equality OT (``ops/otext_cuda.py``: the plain
versions of the ``csrc/ot2s.cu`` kernels behind their test-major wrappers,
and the entries that route through them: ``protocol/secure.py``'s packed
and test-major forms and K3's ``parallel/kernel_shard.py`` shards) against
the JAX package, bit for bit (tolerance 0), on the whole planar buffer, pad
slots included: S in {2, 4, 6}, both payload widths, a batch that is a
whole number of 8,192-test planar blocks and one that is not, a pad index
that wraps inside the batch, the domain folded into real tests only.

The JAX side is both its XLA twins (``secure._ot2s_encrypt_packed_xla`` /
``_ot2s_decrypt_packed_xla``, ``secure.ot2s_encrypt`` / ``ot2s_decrypt``)
and its Pallas kernels ``otext_pallas._enc_planar`` / ``_dec_planar``
themselves, whose bodies run op by op on their grid through
``torch_ref.pallas_eager``: XLA:CPU compiles even the S = 2 kernel in
interpret mode for minutes, past 12 GB.  (The JAX package pins the twins to
the kernels in ``tests/test_secure_kernels.py::test_ot2s_planar_engine_parity``,
a test that needs a JAX release that its ``ops/prg.py`` imports under.)
The decrypt kernel's sector floor (``chip_smoke.dec_sector_count``) is held
against a count by brute force."""

import numpy as np
import pytest
import torch

import fuzzyheavyhitters_tpu.ops.fields  # noqa: F401  (one fields module under every torch_ref
# load, as tests/test_torch_kernel_shard.py)
import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch.ops import gc as tgc
from fuzzyheavyhitters_torch.ops import otext as totext
from fuzzyheavyhitters_torch.ops import otext_cuda
from fuzzyheavyhitters_torch.ops.fields import F255, FE62
from fuzzyheavyhitters_torch.parallel import kernel_shard as tks
from fuzzyheavyhitters_torch.parallel.server_mesh import Sharded
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jsecure, jotext_pallas = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.secure", "fuzzyheavyhitters_tpu.ops.otext_pallas")

BLK = tgc.PLANAR_BLOCK


def _w(a):
    return words_from_numpy(a, "cpu")


def _inputs(rng, B, S, W):
    q = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    s = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s[0] |= 1
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    m0 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    m1 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    return q, s, x, m0, m1


def _receiver(q, s, x):
    """The receiver's strings y (a third of x's flipped where random) and T
    rows (Δ-OT: t_j = q_j ^ y_j·s)."""
    y = x.copy()
    y[::3] = ~y[::3]
    return q ^ (y[..., None] * s), y


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_ot2s_packed_planes_match_jax(S, W):
    """Against the XLA twins and the Pallas kernels, over two planar blocks."""
    rng = np.random.default_rng(100 + 10 * S + W)
    B, idx0 = 9000, 2**32 - 5000  # the pad index wraps at test 5000
    q, s, x, m0, m1 = _inputs(rng, B, S, W)
    with torch_ref.installed():
        jmsg = np.asarray(jsecure._ot2s_encrypt_packed_xla(q, s, x, m0, m1, W, idx0),
                          np.uint32)
        with torch_ref.pallas_eager():
            pmsg = np.asarray(jotext_pallas.ot2s_encrypt(q, s, x, m0, m1, W, idx0,
                                                         domain=jsecure._OT2S_DOMAIN))
    tmsg = tsecure.ot2s_encrypt_packed(_w(q), s, torch.from_numpy(x), _w(m0), _w(m1),
                                       W, idx0)
    assert tmsg.shape == ((1 << S) * W * 2 * BLK,)  # B pads to two planar blocks
    np.testing.assert_array_equal(words_to_numpy(tmsg), jmsg)
    np.testing.assert_array_equal(words_to_numpy(tmsg), pmsg)
    t, y = _receiver(q, s, x)
    with torch_ref.installed():
        jpay = np.asarray(jsecure._ot2s_decrypt_packed_xla(t, y, jmsg, S, W, idx0), np.uint32)
        with torch_ref.pallas_eager():
            ppay = np.asarray(jotext_pallas.ot2s_decrypt(t, y, jmsg, W, idx0,
                                                         domain=jsecure._OT2S_DOMAIN))
    tpay = tsecure.ot2s_decrypt_packed(_w(t), torch.from_numpy(y), tmsg, W, idx0)
    np.testing.assert_array_equal(words_to_numpy(tpay), jpay)
    np.testing.assert_array_equal(words_to_numpy(tpay), ppay)
    eq = (x == y).all(axis=1)
    np.testing.assert_array_equal(words_to_numpy(tpay), np.where(eq[:, None], m1, m0))


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_ot2s_whole_blocks_match_jax(S, W):
    """A batch of whole planar blocks (no pad tests) through the wrappers
    and the packed entries against the XLA twins, the pad index wrapping."""
    rng = np.random.default_rng(300 + 10 * S + W)
    B, idx0 = BLK, 2**32 - 3000
    q, s, x, m0, m1 = _inputs(rng, B, S, W)
    t, y = _receiver(q, s, x)
    with torch_ref.installed():
        jmsg = np.asarray(jsecure._ot2s_encrypt_packed_xla(q, s, x, m0, m1, W, idx0),
                          np.uint32)
        jpay = np.asarray(jsecure._ot2s_decrypt_packed_xla(t, y, jmsg, S, W, idx0), np.uint32)
    args = (_w(q), s, torch.from_numpy(x), _w(m0), _w(m1), idx0)
    tmsg = otext_cuda.enc_planar(*args)
    assert tmsg.shape == ((1 << S) * W * B,)
    np.testing.assert_array_equal(words_to_numpy(tmsg), jmsg)
    np.testing.assert_array_equal(words_to_numpy(otext_cuda.enc_planar_plain(*args)), jmsg)
    np.testing.assert_array_equal(
        words_to_numpy(tsecure.ot2s_encrypt_packed(*args[:5], W, idx0)), jmsg)
    for pay in (otext_cuda.dec_planar(_w(t), torch.from_numpy(y), tmsg, idx0),
                tsecure.ot2s_decrypt_packed(_w(t), torch.from_numpy(y), tmsg, W, idx0)):
        assert pay.shape == (B, W) and pay.is_contiguous()
        np.testing.assert_array_equal(words_to_numpy(pay), jpay)


@pytest.mark.parametrize("S", [2, 4])
def test_ot2s_test_major_forms_match_jax(S):
    """The plain test-major forms (``otext_cuda.ot2s_encrypt`` /
    ``ot2s_decrypt``) against the JAX package's, both payload widths."""
    for W in (4, 8):
        rng = np.random.default_rng(200 + S + W)
        B, idx0 = 300, 2**32 - 100  # the pad index wraps inside the batch
        q, s, x, m0, m1 = _inputs(rng, B, S, W)
        with torch_ref.installed():
            jcts = np.asarray(jsecure.ot2s_encrypt(q, s, x, m0, m1, W, idx0), np.uint32)
        offs = otext_cuda.offsets(s, S, "cpu")
        tcts = otext_cuda.ot2s_encrypt(_w(q), offs, torch.from_numpy(x), _w(m0), _w(m1), W,
                                       idx0)
        np.testing.assert_array_equal(words_to_numpy(tcts), jcts)
        t = q.copy()
        t[:, 0, 1] ^= np.uint32(tsecure._OT2S_DOMAIN)
        with torch_ref.installed():
            jpay = np.asarray(jsecure.ot2s_decrypt(q, x, jcts, W, idx0), np.uint32)
        tpay = otext_cuda.ot2s_decrypt(_w(t), torch.from_numpy(x), tcts, W, idx0)
        np.testing.assert_array_equal(words_to_numpy(tpay), jpay)


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_ot2s_test_major_entries_match_jax(S, W):
    """The mesh's entries ``secure.ot2s_encrypt`` / ``ot2s_decrypt`` (one
    wrapper call each: the table a [2^S, B, W] view of the kernel's planes
    over B tests) against the JAX package's test-major functions; decrypt
    also takes the table as a contiguous copy, as it arrives over gloo."""
    rng = np.random.default_rng(400 + 10 * S + W)
    B, idx0 = 1000, 2**32 - 600
    q, s, x, m0, m1 = _inputs(rng, B, S, W)
    t, y = _receiver(q, s, x)
    with torch_ref.installed():
        jcts = np.asarray(jsecure.ot2s_encrypt(q, s, x, m0, m1, W, idx0), np.uint32)
        jpay = np.asarray(jsecure.ot2s_decrypt(t, y, jcts, W, idx0), np.uint32)
    tcts = tsecure.ot2s_encrypt(_w(q), s, torch.from_numpy(x), _w(m0), _w(m1), W, idx0)
    assert tcts.shape == (1 << S, B, W)
    np.testing.assert_array_equal(words_to_numpy(tcts.contiguous()), jcts)
    for cts in (tcts, tcts.contiguous()):
        tpay = tsecure.ot2s_decrypt(_w(t), torch.from_numpy(y), cts, W, idx0)
        np.testing.assert_array_equal(words_to_numpy(tpay), jpay)


def test_ot2s_pad_tests_and_domain():
    """Pad tests t in [B, bp) hold the bare pads H(o_c, idx0 + t) of zero
    inputs (the domain in every offset), and decrypt folds the domain into
    the real tests only: its B rows equal the JAX package's whether the
    table comes raveled, as planes [2^S * W, bp] (columns past B unread) or
    test-major; a table holding fewer than B tests is refused."""
    rng = np.random.default_rng(7)
    S, W, B, idx0 = 2, 4, BLK + 5, 2**32 - BLK
    q, s, x, m0, m1 = _inputs(rng, B, S, W)
    tmsg = otext_cuda.enc_planar(_w(q), s, torch.from_numpy(x), _w(m0), _w(m1), idx0)
    planes = tmsg.reshape((1 << S) * W, 2 * BLK)
    offs = otext_cuda.offsets(s, S, "cpu")
    idx_pad = idx0 + B
    want = totext.ot_hash(offs[:, None, :].expand(1 << S, 2 * BLK - B, 4), W, idx_pad)
    assert torch.equal(planes[:, B:], want.permute(0, 2, 1).reshape((1 << S) * W, -1))
    t, y = _receiver(q, s, x)
    with torch_ref.installed():
        jpay = np.asarray(jsecure._ot2s_decrypt_packed_xla(
            t, y, words_to_numpy(tmsg), S, W, idx0), np.uint32)
    tt, ty = _w(t), torch.from_numpy(y)
    views = (tmsg, planes, planes.reshape(1 << S, W, -1).permute(0, 2, 1))
    for table in views:
        np.testing.assert_array_equal(words_to_numpy(otext_cuda.dec_planar(tt, ty, table, idx0)),
                                      jpay)
    with pytest.raises(ValueError, match="fewer"):
        otext_cuda.dec_planar(tt, ty, planes[:, :B - 1], idx0)


@pytest.mark.parametrize("S,field", [(2, FE62), (4, FE62), (4, F255)])
def test_ot2s_k3_shards_match_whole_level(S, field):
    """K3's ``gb_kernel`` / ``ev_open`` on k = 2 CPU shards (the second
    holding pad tests) against the unsharded level's packed entries on the
    same OT material: the frame byte-equal, both parties' b2a values
    equal."""
    rng = np.random.default_rng(11 + S)
    B, k, garbler = 2 * BLK - 777, 2, 1
    s_bits = rng.integers(0, 2, 128).astype(bool)
    s_bits[0] = True
    seeds0 = rng.integers(0, 2**32, size=(128, 4), dtype=np.uint32)
    seeds1 = rng.integers(0, 2**32, size=(128, 4), dtype=np.uint32)
    chosen = np.where(s_bits[:, None], seeds1, seeds0)
    snd = totext.OtExtSender(s_bits, chosen, "cpu")
    rcv = totext.OtExtReceiver(seeds0, seeds1, "cpu")
    x = rng.integers(0, 2, (B, S)).astype(bool)
    y = np.where(rng.random((B, 1)) < 0.5, x, rng.integers(0, 2, (B, S)).astype(bool))
    gseed = np.array([1, 2, 3, 4], np.uint32)
    bseed = np.array([9, 8, 7, 0xFFFFFFFF], np.uint32)
    u, t_rows, idx0 = tsecure.ev_step1_fused(rcv, torch.from_numpy(y))
    q = snd.extend(B * S, u)
    W = tsecure.payload_words(field)
    r1, w0, w1 = tsecure.b2a_payload_pair(field, bseed, B, garbler, torch.device("cpu"))
    whole = tsecure.ot2s_encrypt_packed(q.reshape(B, S, 4), snd.s_block, torch.from_numpy(x),
                                        w1, w0, W, idx0)
    vr = tsecure.ev_open_level(t_rows, torch.from_numpy(y), whole, B, S, field, idx0, "ot2s")
    ks = tks.KernelShard(devices=(torch.device("cpu"),) * k, B=B, S=S)
    bloc = ks.bloc

    def shard(a, width):
        pad = torch.zeros((ks.bp * width,) + tuple(a.shape[1:]), dtype=a.dtype)
        pad[:a.shape[0]] = a
        return Sharded([pad[j * bloc * width:(j + 1) * bloc * width] for j in range(k)], 0)

    xs, ys = shard(torch.from_numpy(x), 1), shard(torch.from_numpy(y), 1)
    planes, vals = tks.gb_kernel(ks, snd.s_block, shard(q, S), xs, gseed, bseed, field,
                                 garbler, "ot2s", idx0)
    frame = torch.cat(list(planes), dim=1)
    assert frame.shape == ((1 << S) * W, ks.bp)
    assert torch.equal(frame.reshape(-1), whole)
    assert torch.equal(torch.cat(list(vals))[:B], r1)
    got = tks.ev_open(ks, shard(t_rows, S), ys, words_to_numpy(frame), field, "ot2s", idx0)
    assert torch.equal(torch.cat(list(got))[:B], vr)


@pytest.mark.parametrize("S,W,B", [(2, 4, 1000), (4, 8, 4099), (6, 4, 777)])
def test_dec_sector_count_matches_brute_force(S, W, B):
    """The decrypt floor's sectors: distinct (plane, sector) pairs that the
    opened planes y_t * W + w touch, at 32- and 64-byte granules and the
    128-byte lines."""
    rng = np.random.default_rng(S * W + B)
    y = rng.integers(0, 2, (B, S)).astype(bool)
    yi = (y * (1 << np.arange(S))).sum(1)
    for granule in (32, 64, 128):
        seen = {(int(yi[t]) * W + w, t * 4 // granule) for t in range(B) for w in range(W)}
        assert chip_smoke.dec_sector_count(torch.from_numpy(y), W, granule) == len(seen)
    assert chip_smoke.dec_sector_count(torch.zeros((B, S), dtype=torch.bool), W) == \
        W * -(-B // 8)


def test_ot2s_wrappers_check_inputs():
    """The wrappers refuse what the kernels do not take, on either device."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    bits = lambda *shape: torch.zeros(shape, dtype=torch.bool)
    s = np.array([1, 0, 0, 0], np.uint32)
    with pytest.raises(ValueError, match="x must be torch.bool"):
        otext_cuda.enc_planar(z(8, 2, 4), s, z(8, 2), z(8, 4), z(8, 4), 0)
    with pytest.raises(ValueError, match="s_block"):
        otext_cuda.enc_planar(z(8, 2, 4), s[:2], bits(8, 2), z(8, 4), z(8, 4), 0)
    with pytest.raises(ValueError, match="m_v1"):
        otext_cuda.enc_planar(z(8, 2, 4), s, bits(8, 2), z(8, 4), z(8, 8), 0)
    with pytest.raises(ValueError, match="bp"):
        otext_cuda.enc_planar(z(8, 2, 4), s, bits(8, 2), z(8, 4), z(8, 4), 0, 4)
    with pytest.raises(ValueError, match="planes"):
        otext_cuda.dec_planar(z(8, 2, 4), bits(8, 2), z(15, 8), 0)
    with pytest.raises(ValueError, match="raveled"):
        otext_cuda.dec_planar(z(8, 2, 4), bits(8, 2), z(100), 0)
    out = otext_cuda.enc_planar(z(5, 2, 4), s, bits(5, 2), z(5, 4), z(5, 4), 0, 5)
    assert out.shape == (16 * 5,)
    assert otext_cuda.enc_planar(z(5, 2, 4), s, bits(5, 2), z(5, 4), z(5, 4), 0).shape == (
        16 * BLK,)
    assert otext_cuda.dec_planar(z(5, 2, 4), bits(5, 2), out.reshape(16, 5), 0).shape == (5, 4)
