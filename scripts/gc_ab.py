"""Time the garbled-circuit kernels (``csrc/gc.cu``) of several trees of the
port on one card, in turns.

    python scripts/gc_ab.py --tree A=chipcheck/parent --tree B=. --order ABBA \\
        --out build/gc_ab.json

Each turn is one process that imports the tree's own package (the tree
first on ``PYTHONPATH``), builds its ``gc.cu`` into the tree's build
directory (a tree's first turn builds, its later turns load), and times
garble and eval at ``chip_smoke.GC_TIMING``'s shapes through the tree's
``gc_cuda`` wrappers with ``chip_smoke.gc_time_shape`` (this repository's
``chip_smoke.py``, the same seeds in every turn).  Printed per shape and
kernel: the milliseconds of every turn, each tree's least over its turns
and its ratio to the bound (``chip_smoke.secure_bound``); per tree, the
ptxas registers and spills and the SASS instructions of the instantiation
that ran each shape.  Every turn digests every output of every shape
(SHA-256): the digests must agree across turns and trees, or the script
exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN_TIMEOUT_S = 900  # a turn that builds an older tree's unrolled gc.cu takes minutes


def _chip_smoke():
    """This repository's chip_smoke.py, whatever tree is first on sys.path."""
    spec = importlib.util.spec_from_file_location("gc_ab_chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, seed: int, out: str) -> None:
    """One turn: time every shape of GC_TIMING with ``tree``'s kernels."""
    sys.path.insert(0, tree)
    import torch

    cs = _chip_smoke()
    gcc = importlib.import_module("fuzzyheavyhitters_torch.ops.gc_cuda")
    cb = importlib.import_module("fuzzyheavyhitters_torch.ops.cuda_build")
    if not os.path.abspath(gcc.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {gcc.__file__}, not the tree {tree}'s package")
    cb.build(["gc"])
    ptx = cs.ptxas_by_function(cb.log_path("gc").read_text())
    sass = cs.sass_by_function(cb.lib_path("gc"))
    shapes = []
    for i, (what, S, W, bp) in enumerate(cs.GC_TIMING):
        g_ms, e_ms, outs = cs.gc_time_shape(torch, gcc, S, W, bp, seed + i)
        h = hashlib.sha256()
        for o in outs:
            h.update(o.cpu().numpy().tobytes())
        del outs
        torch.cuda.empty_cache()
        shapes.append({"what": what, "S": S, "W": W, "bp": bp, "garble_ms": g_ms,
                       "eval_ms": e_ms, "digest": h.hexdigest()} | {
            which: {"ptxas": cs.gc_instantiation(ptx, which, S, W),
                    "sass_instructions": cs.gc_instantiation(sass, which, S, W)}
            for which in ("garble", "eval")})
    with open(out, "w") as f:
        json.dump({"tree": tree, "device": torch.cuda.get_device_name(0), "shapes": shapes}, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a tree of the port (at least one)")
    ap.add_argument("--order", default="ABBA", help="turns, by tree name")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", help="write every turn's figures here (JSON)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.seed, args.json)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees or any(name not in trees for name in args.order):
        ap.error("--order names trees that --tree does not give")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(args.order):
            path = os.path.join(tmp, f"turn{i}.json")
            env = dict(os.environ, PYTHONPATH=os.path.abspath(trees[name]))
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                            os.path.abspath(trees[name]), "--seed", str(args.seed),
                            "--json", path], env=env, check=True, timeout=TURN_TIMEOUT_S)
            with open(path) as f:
                turns.append(dict(json.load(f), name=name))
            print(f"turn {i} ({name}): " + "; ".join(
                f"{s['what']} S={s['S']} W={s['W']}: garble {s['garble_ms']:.4f} "
                f"eval {s['eval_ms']:.4f} ms" for s in turns[-1]["shapes"]), flush=True)
    bad = 0
    summary = []
    for j, (what, S, W, bp) in enumerate(cs.GC_TIMING):
        digests = {t["shapes"][j]["digest"] for t in turns}
        bad += len(digests) != 1
        for kn, which in (("gc_garble", "garble"), ("gc_eval", "eval")):
            b_ms, b_by = cs.secure_bound(kn, S, W, bp)
            for name in dict.fromkeys(args.order):
                mine = [t for t in turns if t["name"] == name]
                ms = [t["shapes"][j][f"{which}_ms"] for t in mine]
                inst = mine[0]["shapes"][j][which]
                ptx = inst["ptxas"] or {}
                summary.append({"kernel": kn, "what": what, "S": S, "W": W, "bp": bp,
                                "tree": name, "ms": ms, "min_ms": min(ms), "bound_ms": b_ms,
                                "bound_by": b_by, "ratio": min(ms) / b_ms, **ptx,
                                "sass_instructions": inst["sass_instructions"]})
                r = summary[-1]
                print(f"{kn} {what} S={S} W={W} bp={bp} tree {name}: ms "
                      f"{' / '.join(f'{m:.4f}' for m in ms)} (least {r['min_ms']:.4f}) "
                      f"bound {b_ms:.4f} ({b_by}) ratio {r['ratio']:.3f}; registers "
                      f"{ptx.get('registers')} spills {ptx.get('spill_stores')}/"
                      f"{ptx.get('spill_loads')} B sass {inst['sass_instructions']}",
                      flush=True)
        same = "bit-identical across every turn" if len(digests) == 1 else "DIFFER"
        print(f"{what} S={S} W={W}: outputs {same}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "order": args.order, "trees": trees, "turns": turns,
                       "summary": summary}, f, indent=1)
    print(json.dumps({"gc_ab": {"smi": smi, "bit_identical": not bad}}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
