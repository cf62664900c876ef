"""The PyTorch port's ibDCF keygen (plain version of the CUDA kernel in
``fuzzyheavyhitters_torch/csrc/keygen.cu``) against the JAX package's
``gen_pair_np`` / ``gen_pair``, bit for bit, in both PRG bit modes and at
n_dims 1, 2, 3 with client counts that are not multiples of 1024.  The
Pallas keygen kernel's interpret mode is too slow for this suite; the JAX
suite pins ``gen_pair_np`` and ``gen_pair`` bit-identical to it."""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops import keygen_cuda
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jibdcf, jprg = torch_ref.reference(
    "fuzzyheavyhitters_tpu.ops.ibdcf", "fuzzyheavyhitters_tpu.ops.prg")


def _assert_keys_equal(tk, jk):
    np.testing.assert_array_equal(tk.key_idx.numpy(), np.asarray(jk.key_idx, bool))
    np.testing.assert_array_equal(words_to_numpy(tk.root_seed),
                                  np.asarray(jk.root_seed, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tk.cw_seed),
                                  np.asarray(jk.cw_seed, np.uint32))
    np.testing.assert_array_equal(tk.cw_bits.numpy(), np.asarray(jk.cw_bits, bool))
    np.testing.assert_array_equal(tk.cw_y_bits.numpy(), np.asarray(jk.cw_y_bits, bool))


@pytest.fixture
def bit_mode(request, monkeypatch):
    """Set both packages' PRG bit mode for one test."""
    monkeypatch.setattr(jprg, "DERIVED_BITS", request.param)
    monkeypatch.setattr(tprg, "DERIVED_BITS", request.param)
    return request.param


@pytest.mark.parametrize("bit_mode", [False, True], indirect=True)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_gen_pair_matches_gen_pair_np(bit_mode, d):
    rng = np.random.default_rng(100 + d)
    n, L = 37, 13
    seeds = rng.integers(0, 1 << 32, size=(n, d, 2, 2, 4), dtype=np.uint32)
    alpha = rng.integers(0, 2, size=(n, d, 2, L)).astype(bool)
    side = np.broadcast_to(np.array([True, False]), (n, d, 2))
    j0, j1 = jibdcf.gen_pair_np(seeds, alpha, side)
    t0, t1 = tibdcf.gen_pair(words_from_numpy(seeds, "cpu"),
                             torch.from_numpy(alpha), torch.from_numpy(side.copy()))
    _assert_keys_equal(t0, j0)
    _assert_keys_equal(t1, j1)


def test_gen_pair_matches_jax_scan(rng):
    n, L = 21, 9
    seeds = rng.integers(0, 1 << 32, size=(n, 2, 4), dtype=np.uint32)
    alpha = rng.integers(0, 2, size=(n, L)).astype(bool)
    side = rng.integers(0, 2, size=n).astype(bool)
    j0, _ = jibdcf.gen_pair(seeds, alpha, side)
    t0, _ = tibdcf.gen_pair(words_from_numpy(seeds, "cpu"),
                            torch.from_numpy(alpha), torch.from_numpy(side))
    _assert_keys_equal(t0, j0)


@pytest.mark.parametrize("coords", [False, True])
def test_ball_keygen_same_rng_same_keys(coords):
    """Same numpy seed -> the same keys in both packages (the rng draw order
    of ``gen_l_inf_ball`` and its coordinate variant is kept)."""
    n, d = 45, 2
    pts = np.random.default_rng(7).integers(-300, 300, size=(n, d))
    if coords:
        j0, j1 = jibdcf.gen_l_inf_ball_from_coords(
            pts, 3, np.random.default_rng(5), engine="np")
        t0, t1 = tibdcf.gen_l_inf_ball_from_coords(
            pts, 3, np.random.default_rng(5), device="cpu")
    else:
        bits = ((pts[..., None] & 0x3FF) >> np.arange(9, -1, -1)) & 1 > 0
        j0, j1 = jibdcf.gen_l_inf_ball(bits, 2, np.random.default_rng(5), engine="np")
        t0, t1 = tibdcf.gen_l_inf_ball(bits, 2, np.random.default_rng(5), device="cpu")
    _assert_keys_equal(t0, j0)
    _assert_keys_equal(t1, j1)


@pytest.mark.parametrize("L", [8, 64, 70, 130])
def test_ball_bounds_match_jax(rng, L):
    """The port's multi-limb arithmetic vs the JAX package's bit ripple,
    across limb boundaries and at both saturating edges."""
    bits = rng.integers(0, 2, size=(50, 3, L)).astype(bool)
    bits[0] = True  # saturates high
    bits[1] = False  # saturates low
    bits[2, :, -7:] = True  # carries across the low limb
    bits[3, :, -7:] = False  # borrows across the low limb
    for ball in (0, 1, 5, 300, 1 << 80):
        for a, b in zip(tibdcf.ball_bounds(bits, ball), jibdcf.ball_bounds(bits, ball)):
            np.testing.assert_array_equal(a, b)


def test_eval_full_matches_jax(rng):
    """Evaluation of ported keys at random inputs gives the JAX shares, and
    the two parties' shares reconstruct the comparison."""
    n, L = 24, 10
    seeds = rng.integers(0, 1 << 32, size=(n, 2, 4), dtype=np.uint32)
    alpha = rng.integers(0, 2, size=(n, L)).astype(bool)
    side = rng.integers(0, 2, size=n).astype(bool)
    x = rng.integers(0, 2, size=(n, L)).astype(bool)
    j0, j1 = jibdcf.gen_pair_np(seeds, alpha, side)
    shares = []
    for jk in (j0, j1):
        tk = tibdcf.keys_from_numpy(jk, "cpu")
        st = tibdcf.eval_full(tk, torch.from_numpy(x))
        want = jibdcf.share_bit(jibdcf.eval_full(jk, x))
        np.testing.assert_array_equal(tibdcf.share_bit(st).numpy(), np.asarray(want))
        shares.append(tibdcf.share_bit(st).numpy())
    weights = 1 << np.arange(L - 1, -1, -1)
    xv, av = (x * weights).sum(1), (alpha * weights).sum(1)
    np.testing.assert_array_equal(shares[0] ^ shares[1],
                                  np.where(side, xv < av, xv > av))


def test_wrapper_checks_shapes_and_routes_cpu_to_plain():
    seeds = torch.zeros((4, 2, 4), dtype=torch.int32)
    alpha = torch.zeros((4, 6), dtype=torch.bool)
    side = torch.zeros(4, dtype=torch.bool)
    before = keygen_cuda.LAUNCHES
    out = keygen_cuda.gen_cw(seeds, alpha, side, True)
    assert keygen_cuda.LAUNCHES == before  # the plain version launches nothing
    for a, b in zip(out, keygen_cuda.gen_cw_plain(seeds, alpha, side, True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        keygen_cuda.gen_cw(seeds.to(torch.int64), alpha, side)
    with pytest.raises(ValueError):
        keygen_cuda.gen_cw(seeds, alpha[:3], side)
