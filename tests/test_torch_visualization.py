"""The port's two visualization scripts against the JAX package's: on the
same inputs and seeds both write the same PNG files, pixel for pixel (the
PNG bytes may differ in metadata, so the decoded images are compared)."""

from __future__ import annotations

import os

import numpy as np
import pytest

import torch_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTROIDS = os.path.join(REPO, "data", "county_centroids.csv")


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """Both packages' plots: rides with and without a hitters CSV, covid
    with and without a hitters array -> {case: (jax paths, port paths)}."""
    pytest.importorskip("matplotlib")
    from fuzzyheavyhitters_torch.workloads import covid_data_visualization as tcviz
    from fuzzyheavyhitters_torch.workloads import ride_austin_visualization as trviz
    from fuzzyheavyhitters_torch.workloads import rides

    jcviz, jrviz = torch_ref.reference(
        "fuzzyheavyhitters_tpu.workloads.covid_data_visualization",
        "fuzzyheavyhitters_tpu.workloads.ride_austin_visualization")
    tmp = tmp_path_factory.mktemp("viz")
    paths = np.zeros((3, 2, 16), bool)
    paths[:, :, 0] = True  # positive offset-binary coords
    hits = str(tmp / "hh.csv")
    rides.save_heavy_hitters(paths, hits)
    missing = str(tmp / "missing.csv")  # forces the samplers' fallbacks
    hitters = np.array([[30.27, -97.74], [40.71, -74.0]])
    out = {}
    for pkg, cviz, rviz in (("jax", jcviz, jrviz), ("port", tcviz, trviz)):
        out.setdefault("rides", []).append(
            rviz.visualize(hits, missing, 500, str(tmp / pkg / "rides")))
        out.setdefault("rides_no_hitters", []).append(
            rviz.visualize(missing, missing, 300, str(tmp / pkg / "rides0")))
        out.setdefault("covid", []).append(
            cviz.visualize(CENTROIDS, missing, 500, str(tmp / pkg / "covid")))
        out.setdefault("covid_hitters", []).append(
            cviz.visualize(CENTROIDS, missing, 300, str(tmp / pkg / "covid1"),
                           hitters=hitters))
    return out


_CASES = {
    "rides": ("start_heatmap.png", "heavy_hitters_map.png", "start_marginals.png"),
    "rides_no_hitters": ("start_heatmap.png", "start_marginals.png"),
    "covid": ("county_centroids.png", "case_density_heatmap.png", "location_marginals.png"),
    "covid_hitters": ("county_centroids.png", "case_density_heatmap.png",
                      "location_marginals.png"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_same_files(case, renders):
    jax_paths, port_paths = renders[case]
    names = [os.path.basename(p) for p in port_paths]
    assert names == [os.path.basename(p) for p in jax_paths] == list(_CASES[case])


@pytest.mark.parametrize("case, name", [(c, n) for c in sorted(_CASES) for n in _CASES[c]])
def test_same_pixels(case, name, renders):
    import matplotlib.image as mpimg

    jax_paths, port_paths = renders[case]
    a = mpimg.imread(next(p for p in jax_paths if p.endswith(name)))
    b = mpimg.imread(next(p for p in port_paths if p.endswith(name)))
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_array_equal(a, b)
