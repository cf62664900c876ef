"""The turn driver that ``scripts/gc_ab.py`` and ``scripts/ot2s_ab.py`` share:
several trees of the port timed on one card, in turns.

A script hands ``main`` its name, a worker and a summary.  ``main`` reads
``--tree NAME=PATH`` (at least one), ``--order`` (turns by tree name,
default ``ABBA``), ``--seed``, ``--out`` and the script's per-tree switch
if it declares one (``--SWITCH NAME``, once for each tree that takes it);
prints the card's name and power limit; runs each turn as one process of the calling script
(``--worker``) with the tree first on ``PYTHONPATH``; and, per shape,
hands the turns' figures to the summary, which prints its rows and returns
them.  A worker returns one dict a shape with a ``digest`` of its outputs
(``digest``): the digests must agree across turns and trees, or ``main``
returns 1.  ``--out`` takes every turn's figures and the summary rows
(JSON); the last line is ``{"<name>": {"smi": ..., "bit_identical": ...}}``.
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


def chip_smoke():
    """This repository's chip_smoke.py, whatever tree is first on sys.path."""
    spec = importlib.util.spec_from_file_location("kernel_ab_chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_module(tree: str, name: str):
    """Import ``name`` and raise unless it is the tree's own file."""
    mod = importlib.import_module(name)
    if not os.path.abspath(mod.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {mod.__file__}, not the tree {tree}'s package")
    return mod


def digest(outs) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


def main(name: str, doc: str, script: str, worker, turn_line, summary, timeout_s: int,
         switch=None) -> int:
    """Run the turns.  ``worker(cs, tree, seed, switched) -> [shape dict]``
    times one tree (``cs`` this repository's chip_smoke module,
    ``switched`` whether the tree takes ``switch``, a (name, help) pair or
    None); ``turn_line(shape)`` is a shape's part of a turn's printed line;
    ``summary(cs, shapes, order)`` gets one shape's dicts by tree name, each
    a list over that tree's turns, prints its rows and returns them."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a tree of the port (at least one)")
    ap.add_argument("--order", default="ABBA", help="turns, by tree name")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", help="write every turn's figures here (JSON)")
    if switch:
        ap.add_argument(f"--{switch[0]}", action="append", default=[], metavar="NAME",
                        dest="switched", help=switch[1])
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    ap.add_argument("--switched-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, args.worker)
        import torch

        shapes = worker(chip_smoke(), args.worker, args.seed, args.switched_worker)
        with open(args.json, "w") as f:
            json.dump({"tree": args.worker, "device": torch.cuda.get_device_name(0),
                       "shapes": shapes}, f)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    switched = set(getattr(args, "switched", ()))
    if not trees or any(n not in trees for n in (*args.order, *switched)):
        ap.error("--order or a switch names trees that --tree does not give")
    cs = chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(args.order):
            path = os.path.join(tmp, f"turn{i}.json")
            env = dict(os.environ, PYTHONPATH=os.path.abspath(trees[tree]))
            subprocess.run([sys.executable, os.path.abspath(script), "--worker",
                            os.path.abspath(trees[tree]), "--seed", str(args.seed),
                            "--json", path] + ["--switched-worker"] * (tree in switched),
                           env=env, check=True, timeout=timeout_s)
            with open(path) as f:
                turns.append(dict(json.load(f), name=tree))
            print(f"turn {i} ({tree}): " + "; ".join(map(turn_line, turns[-1]["shapes"])),
                  flush=True)
    bad, rows = 0, []
    for j in range(len(turns[0]["shapes"])):
        digests = {t["shapes"][j]["digest"] for t in turns}
        bad += len(digests) != 1
        rows += summary(cs, {n: [t["shapes"][j] for t in turns if t["name"] == n]
                             for n in dict.fromkeys(args.order)}, args.order)
        s = turns[0]["shapes"][j]
        same = "bit-identical across every turn" if len(digests) == 1 else "DIFFER"
        print(f"{s['what']} S={s['S']} W={s['W']}: outputs {same}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "order": args.order, "trees": trees, "turns": turns,
                       "summary": rows}, f, indent=1)
    print(json.dumps({name: {"smi": smi, "bit_identical": not bad}}))
    return 1 if bad else 0
