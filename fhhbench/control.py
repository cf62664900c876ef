"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee the configuration
states broken, "every client counted exactly once".  It counts a seeded
half of the clients, each twice (the sampled counting that approximate
heavy-hitter schemes use), and the same judgement as a run's must read it
as not correct.  It runs no program code and needs no card:

    python3 fhhbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers compared, each with its limit,
over both point sets of the run that seed starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fhhbench import judge  # noqa: E402
from fhhbench.collection import Collection  # noqa: E402
from fhhbench.reference import crawl as reference  # noqa: E402
from fhhbench.spec import Spec  # noqa: E402
from fhhbench.traffic.generate import point_sets, seed_sequence  # noqa: E402


def sampled_hitters(cfg: dict, points: np.ndarray, seed: int) -> reference.Hitters:
    """The control's answer: half the clients, drawn from ``seed``, each
    counted twice (so the threshold's base, the clients' weight, is kept)."""
    n = points.shape[0]
    weight = np.zeros(n, np.int64)
    weight[np.random.default_rng(seed_sequence(seed, 2)).permutation(n)[: n // 2]] = 2
    return reference.heavy_hitters(points, cfg["ball_size"], cfg["threshold"], cfg["f_max"],
                                   weights=weight)


def control_checks(sampler, cfg: dict, mix: dict, seed: int) -> dict:
    """The judgement of the control on the point sets of run ``seed``."""
    sets = point_sets(sampler, cfg, mix, seed)
    refs, answers = {}, []
    for k, pts in enumerate(sets):
        refs[k] = reference.heavy_hitters(pts, cfg["ball_size"], cfg["threshold"], cfg["f_max"])
        got = sampled_hitters(cfg, pts, seed)
        answers.append(Collection(index=k, point_set=k, clients=pts.shape[0],
                                  paths=got.paths, counts=got.counts))
    return judge.judge(answers, refs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fhhbench-control", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = Spec(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in args.seeds:
        checks = control_checks(spec.sampler(cfg["distribution"]), cfg, mix, seed)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": judge.passed(checks), "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
