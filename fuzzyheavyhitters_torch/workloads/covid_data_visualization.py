"""COVID-geo visualization (ref: src/covid_data_visualization.py; the
port's copy of the JAX package's script, over the port's ``covid``).

The reference script renders case-density heatmaps and demographic
histograms from the 9 GB case-surveillance CSV (absent even from its own
tree) over contextily basemaps.  This counterpart works from what actually
ships: the county-centroid file plus the same sampler the protocol uses
(``covid.sample_covid_locations`` falls back to uniform county sampling
when the big CSV is missing), and the protocol's decoded heavy-hitter
coordinates when provided.  Plain matplotlib, no network tiles.

Outputs PNGs under ``data/covid_plots/``::

    python -m fuzzyheavyhitters_torch.workloads.covid_data_visualization \
        [--centroids data/county_centroids.csv] [--n 20000]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import covid

DEFAULT_CENTROIDS = "data/county_centroids.csv"
DEFAULT_CASES = "data/COVID-19_Case_Surveillance_Public_Use_Data_with_Geography_20250430.csv"
OUTPUT_DIR = "data/covid_plots"

# continental-US display window (the reference's maps crop to it too)
LON_LIM = (-130.0, -65.0)
LAT_LIM = (23.0, 50.0)


def visualize(centroids_path: str = DEFAULT_CENTROIDS, cases_path: str = DEFAULT_CASES,
              n: int = 20_000, out_dir: str = OUTPUT_DIR,
              hitters: np.ndarray | None = None) -> list[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    cents = covid.load_centroids(centroids_path)
    c_lat = np.array([v[0] for v in cents.values()])
    c_lon = np.array([v[1] for v in cents.values()])
    inside = (
        (c_lon >= LON_LIM[0]) & (c_lon <= LON_LIM[1])
        & (c_lat >= LAT_LIM[0]) & (c_lat <= LAT_LIM[1])
    )

    # 1. county centroid map (the sampler's support)
    fig, ax = plt.subplots(figsize=(12, 7))
    ax.scatter(c_lon[inside], c_lat[inside], s=2, c="steelblue", alpha=0.6)
    ax.set_xlim(*LON_LIM)
    ax.set_ylim(*LAT_LIM)
    ax.set_title(f"{inside.sum()} county centroids (sampler support)")
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    p = os.path.join(out_dir, "county_centroids.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)

    # 2. sampled case-location density (real CSV when present, else the
    # uniform-county fallback), decoded from the f64 bit-vector encoding
    pts_bits = covid.sample_covid_locations(
        cases_path, centroids_path, n, fuzz_factor=8.0, rng=7
    )
    lat = np.array([covid.bool_vec_to_f64(b) for b in pts_bits[:, 0]])
    lon = np.array([covid.bool_vec_to_f64(b) for b in pts_bits[:, 1]])
    keep = (
        (lon >= LON_LIM[0]) & (lon <= LON_LIM[1])
        & (lat >= LAT_LIM[0]) & (lat <= LAT_LIM[1])
    )
    fig, ax = plt.subplots(figsize=(12, 7))
    hb = ax.hexbin(lon[keep], lat[keep], gridsize=80, cmap="inferno", mincnt=1)
    fig.colorbar(hb, ax=ax, label="cases")
    if hitters is not None and len(hitters):
        ax.scatter(hitters[:, 1], hitters[:, 0], s=70, c="cyan", marker="x",
                   label=f"{len(hitters)} heavy hitters")
        ax.legend()
    ax.set_xlim(*LON_LIM)
    ax.set_ylim(*LAT_LIM)
    src = "case CSV" if os.path.exists(cases_path) else "uniform-county fallback"
    ax.set_title(f"Case-location density ({src}, 8 km jitter)")
    p = os.path.join(out_dir, "case_density_heatmap.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)

    # 3. per-axis marginals of the sampled locations
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].hist(lat[keep], bins=80, color="darkorange")
    axes[0].set_title("latitude marginal")
    axes[1].hist(lon[keep], bins=80, color="darkorange")
    axes[1].set_title("longitude marginal")
    p = os.path.join(out_dir, "location_marginals.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)
    return written


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--centroids", default=DEFAULT_CENTROIDS)
    ap.add_argument("--cases", default=DEFAULT_CASES)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--out", default=OUTPUT_DIR)
    args = ap.parse_args()
    for p in visualize(args.centroids, args.cases, args.n, args.out):
        sys.stdout.write(f"wrote {p}\n")


if __name__ == "__main__":
    main()
