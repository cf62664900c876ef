"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips.  This file
imports no JAX (the machine with the card has none), so on that machine run
it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fuzzyheavyhitters_torch.ops import expand_cuda, keygen_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=shape).astype(np.int32))


@pytest.mark.parametrize("derived", [False, True])
def test_keygen_kernel_equals_plain(cuda, derived):
    rng = np.random.default_rng(11)
    K, L = 1000, 37  # K not a multiple of the block
    seeds = _ints(rng, (K, 2, 4))
    alpha = torch.from_numpy(rng.integers(0, 2, size=(K, L)).astype(bool))
    side = torch.from_numpy(rng.integers(0, 2, size=K).astype(bool))
    want = keygen_cuda.gen_cw_plain(seeds, alpha, side, derived)
    before = keygen_cuda.LAUNCHES
    got = keygen_cuda.gen_cw(seeds.to(cuda), alpha.to(cuda), side.to(cuda), derived)
    torch.cuda.synchronize()
    assert keygen_cuda.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("derived", [False, True])
@pytest.mark.parametrize("d2,want_children", [(2, True), (4, True), (6, False)])
def test_expand_kernel_equals_plain(cuda, derived, d2, want_children):
    rng = np.random.default_rng(12)
    F, N = 5, 777
    B = F * N
    args = (_ints(rng, (4, d2, B)),
            torch.from_numpy(rng.integers(0, 2, size=(d2, B)).astype(bool)),
            torch.from_numpy(rng.integers(0, 2, size=(d2, B)).astype(bool)),
            _ints(rng, (4, d2, N)),
            torch.from_numpy(rng.integers(0, 16, size=(d2, N)).astype(np.uint8)))
    want = expand_cuda.expand_packed_plain(*args, derived, want_children)
    got = expand_cuda.expand_packed(*(a.to(cuda) for a in args), derived, want_children)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert torch.equal(a.cpu(), b)


def test_wrappers_reject_bad_inputs(cuda):
    seeds = torch.zeros((4, 2, 4), dtype=torch.int32, device=cuda)
    alpha = torch.zeros((4, 6), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        keygen_cuda.gen_cw(seeds, alpha, torch.zeros(4, dtype=torch.bool))  # mixed devices
    with pytest.raises(ValueError):
        keygen_cuda.gen_cw(seeds.float(), alpha, torch.zeros(4, dtype=torch.bool, device=cuda))
