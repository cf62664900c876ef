"""The PyTorch port's fixed-key ChaCha PRG against the JAX package's, bit
for bit (tolerance 0: the system is bitwise), plus the port's import
isolation: importing it must load neither JAX nor the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

(jprg,) = torch_ref.reference("fuzzyheavyhitters_tpu.ops.prg")


def _blocks(rng, shape):
    return rng.integers(0, 1 << 32, size=shape + (4,), dtype=np.uint32)


def test_constants_match_jax():
    assert tprg._SIGMA == jprg._SIGMA
    assert tprg._FIXED_KEY == jprg._FIXED_KEY
    assert tprg.N_ROUNDS == jprg.N_ROUNDS == 8
    assert tprg.DERIVED_BITS == jprg.DERIVED_BITS


def test_chacha_block_matches_jax(rng):
    blk = _blocks(rng, (3, 37))
    blk[0, 0] = 0xFFFFFFFF  # wraparound of every add
    blk[0, 1] = 0
    want = np.asarray(jprg.chacha_block(blk), np.uint32)
    np.testing.assert_array_equal(want, jprg.np_chacha_block(blk))
    got = words_to_numpy(tprg.chacha_block(words_from_numpy(blk, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("derived", [False, True])
def test_expand_matches_jax(rng, derived):
    seed = _blocks(rng, (5, 2, 2))
    js_l, js_r, jb, jy = jprg.expand(seed, derived)
    ts_l, ts_r, tb, ty = tprg.expand(words_from_numpy(seed, "cpu"), derived)
    np.testing.assert_array_equal(words_to_numpy(ts_l), np.asarray(js_l, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(ts_r), np.asarray(js_r, np.uint32))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb, bool))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy, bool))


def test_seed_mask_drops_low_nibble(rng):
    seed = _blocks(rng, (16,))
    flipped = seed.copy()
    flipped[:, 0] ^= rng.integers(1, 16, size=16).astype(np.uint32)
    a = tprg.expand(words_from_numpy(seed, "cpu"), True)
    b = tprg.expand(words_from_numpy(flipped, "cpu"), True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_word_bridge_round_trips():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFF0, 0xFFFFFFFF], np.uint32)
    t = words_from_numpy(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(t), w)
    u = tprg.to_u64(t)
    np.testing.assert_array_equal(u.numpy(), w.astype(np.int64))
    assert torch.equal(tprg.to_i32(u), t)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import fuzzyheavyhitters_torch.bin.mesh\n"
        "import fuzzyheavyhitters_torch.ops.cuda_build\n"
        "import fuzzyheavyhitters_torch.analysis\n"
        "import fuzzyheavyhitters_torch.analysis.cli\n"
        "import fuzzyheavyhitters_torch.workloads.covid_data_visualization\n"
        "import fuzzyheavyhitters_torch.workloads.ride_austin_visualization\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('fuzzyheavyhitters_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_import_no_jax():
    """No file of the port, and not chip_smoke.py, has an import of jax or
    of the JAX package (at module level or inside a function)."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(root, "fuzzyheavyhitters_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for n in ast.walk(tree):
            mods = ([a.name for a in n.names] if isinstance(n, ast.Import)
                    else [n.module or ""] if isinstance(n, ast.ImportFrom) and not n.level
                    else [])
            bad += [(path, n.lineno, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "fuzzyheavyhitters_tpu")]
    assert len(files) > 60 and not bad, bad
