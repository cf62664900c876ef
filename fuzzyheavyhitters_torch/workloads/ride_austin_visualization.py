"""RideAustin visualization (ref: src/ride_austin_visualization.py; the
port's copy of the JAX package's script, over the port's ``rides``).

The reference script plots the raw 9 GB rides dataset (hexbin start/end
heatmaps, duration histogram) over contextily web basemaps.  This
counterpart works in the environments this framework actually ships to:

- **no giant inputs required** — the primary subject is the protocol's
  OUTPUT, ``data/ride_heavy_hitters.csv`` (index, latitude, longitude;
  workloads/rides.py ``save_heavy_hitters``); raw start locations come
  from the real CSV when present and the seeded synthetic Austin sampler
  otherwise (``load_or_synthesize_locations`` — the same fallback the
  protocol drivers use);
- **no network** — plain matplotlib axes instead of contextily tile
  fetches (zero-egress deployments).

Outputs PNGs under ``data/ride_plots/``::

    python -m fuzzyheavyhitters_torch.workloads.ride_austin_visualization \
        [--hitters data/ride_heavy_hitters.csv] [--n 20000]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from . import rides

DEFAULT_HITTERS = "data/ride_heavy_hitters.csv"
DEFAULT_RAW = "data/RideAustin_Weather.csv"
OUTPUT_DIR = "data/ride_plots"


def load_hitters(path: str) -> np.ndarray:
    """(lat, lon) float rows from the heavy-hitter output CSV."""
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.append((float(row["latitude"]), float(row["longitude"])))
    return np.asarray(out, dtype=float).reshape(-1, 2)


def visualize(hitters_path: str = DEFAULT_HITTERS, raw_path: str = DEFAULT_RAW,
              n: int = 20_000, out_dir: str = OUTPUT_DIR) -> list[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    coords = rides.load_or_synthesize_locations(raw_path, n, seed=42)
    lat, lon = coords[:, 0] / 100.0, coords[:, 1] / 100.0  # centideg -> deg

    # 1. start-locations heatmap (the reference's hexbin, sans basemap)
    fig, ax = plt.subplots(figsize=(10, 8))
    hb = ax.hexbin(lon, lat, gridsize=60, cmap="viridis", mincnt=1)
    fig.colorbar(hb, ax=ax, label="rides")
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    ax.set_title("Ride start locations (centidegree resolution)")
    p = os.path.join(out_dir, "start_heatmap.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)

    # 2. heavy hitters over the start distribution (protocol output)
    if os.path.exists(hitters_path) and os.path.getsize(hitters_path) > 0:
        hh = load_hitters(hitters_path)
        fig, ax = plt.subplots(figsize=(10, 8))
        ax.hexbin(lon, lat, gridsize=60, cmap="Greys", mincnt=1)
        ax.scatter(hh[:, 1], hh[:, 0], s=60, c="crimson", marker="x",
                   label=f"{len(hh)} fuzzy heavy hitters")
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
        ax.set_title("Fuzzy heavy hitters vs ride starts")
        ax.legend()
        p = os.path.join(out_dir, "heavy_hitters_map.png")
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # 3. per-axis marginals (the reference's distribution histograms)
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].hist(lat, bins=80, color="steelblue")
    axes[0].set_title("latitude marginal")
    axes[1].hist(lon, bins=80, color="steelblue")
    axes[1].set_title("longitude marginal")
    p = os.path.join(out_dir, "start_marginals.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)
    return written


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hitters", default=DEFAULT_HITTERS)
    ap.add_argument("--raw", default=DEFAULT_RAW)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--out", default=OUTPUT_DIR)
    args = ap.parse_args()
    for p in visualize(args.hitters, args.raw, args.n, args.out):
        sys.stdout.write(f"wrote {p}\n")


if __name__ == "__main__":
    main()
