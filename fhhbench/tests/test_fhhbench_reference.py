"""The plain reference against brute-force counts, and its imports."""

from __future__ import annotations

import ast
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from fhhbench.reference import crawl
from fhhbench.traffic import rides, zipf
from fhhbench.traffic.generate import point_sets

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fuzzyheavyhitters_tpu", "fuzzyheavyhitters_torch"}


def ints(bits: np.ndarray) -> list:
    """bool[..., L] MSB-first -> Python ints, flattened."""
    L = bits.shape[-1]
    return [int("".join("1" if b else "0" for b in row), 2) for row in bits.reshape(-1, L)]


def brute_force(points, ball, threshold, f_max):
    """The level loop over Python integers: every child of every surviving
    node counted by comparing each client's box prefixes with it."""
    N, d, L = points.shape
    top = (1 << L) - 1
    v = np.array(ints(points), dtype=object).reshape(N, d)
    lo = [[max(0, int(x) - ball) for x in row] for row in v]
    hi = [[min(top, int(x) + ball) for x in row] for row in v]
    t = max(1, int(threshold * N))
    nodes = [tuple([0] * d)]
    counts = []
    for level in range(L):
        s = L - level - 1
        survivors = []
        for node in nodes:
            for c in range(1 << d):
                child = tuple((node[j] << 1) | ((c >> j) & 1) for j in range(d))
                n = sum(all(lo[i][j] >> s <= child[j] <= hi[i][j] >> s for j in range(d))
                        for i in range(N))
                if n >= t:
                    survivors.append((child, n))
        assert len(survivors) <= f_max
        nodes = [c for c, _ in survivors]
        counts = [n for _, n in survivors]
        if not nodes:
            return [], []
    return nodes, counts


def as_ints(hitters: crawl.Hitters) -> list:
    H, d, _ = hitters.paths.shape
    return [tuple(ints(hitters.paths[h])) for h in range(H)]


SAMPLERS = {"zipf": zipf, "rides": rides}


def points(cfg: dict, n: int, seed: int) -> np.ndarray:
    return point_sets(SAMPLERS[cfg["distribution"]], cfg, {"clients": n, "point_sets": 1}, seed)[0]


def config(name: str, **changes) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(changes)
    return cfg


@pytest.mark.parametrize("name,n,changes", [
    ("zipf4", 30, {"num_sites": 4}),  # data_len 512, ball 2, threshold 1 client
    ("zipf4", 60, {"num_sites": 3, "threshold": 0.2}),
    ("rides", 80, {}),
    ("rides", 120, {"threshold": 0.2, "ball_size": 3}),
])
def test_reference_equals_brute_force(name, n, changes):
    cfg = config(name, **changes)
    for seed in (1, 2**35 + 11):
        pts = points(cfg, n, seed)
        got = crawl.heavy_hitters(pts, cfg["ball_size"], cfg["threshold"], cfg["f_max"])
        nodes, counts = brute_force(pts, cfg["ball_size"], cfg["threshold"], cfg["f_max"])
        assert as_ints(got) == nodes
        assert got.counts.tolist() == counts
        assert got.paths.shape[-1] == cfg["data_len"] or not nodes


def test_reference_equals_every_leaf_counted():
    """In a domain small enough to count every leaf: the hitters are the
    leaves counted at or above the threshold (counts fall with depth, so
    pruning loses none)."""
    rng = np.random.default_rng(3)
    N, d, L, ball = 60, 2, 5, 1
    v = rng.integers(0, 1 << L, size=(N, d))
    v[: N // 2] = v[0]  # a cluster
    pts = ((v[..., None] >> np.arange(L - 1, -1, -1)) & 1).astype(bool)
    got = crawl.heavy_hitters(pts, ball, 0.1, 1024)
    t = max(1, int(0.1 * N))
    want = []
    for leaf in itertools.product(range(1 << L), repeat=d):
        n = int(np.all(np.abs(v - np.array(leaf)) <= ball, axis=1).sum())
        if n >= t:
            want.append((leaf, n))
    assert sorted(zip(as_ints(got), got.counts.tolist())) == sorted(want)


def test_weights_count_rows_as_clients():
    cfg = config("rides")
    pts = points(cfg, 400, 9)
    once = crawl.heavy_hitters(np.concatenate([pts, pts]), 1, 0.075, 1024)
    twice = crawl.heavy_hitters(pts, 1, 0.075, 1024, weights=np.full(400, 2))
    assert (once.paths == twice.paths).all() and (once.counts == twice.counts).all()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    assert names <= {"__future__", "dataclasses", "numpy"}
