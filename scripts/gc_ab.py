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
exits 1.  The turns, the digests and ``--out`` are ``scripts/kernel_ab.py``'s.
"""

from __future__ import annotations

import sys

import kernel_ab

TURN_TIMEOUT_S = 900  # a turn that builds an older tree's unrolled gc.cu takes minutes


def worker(cs, tree: str, seed: int, _switched: bool) -> list:
    """One turn: time every shape of GC_TIMING with ``tree``'s kernels."""
    import torch

    gcc = kernel_ab.tree_module(tree, "fuzzyheavyhitters_torch.ops.gc_cuda")
    cb = kernel_ab.tree_module(tree, "fuzzyheavyhitters_torch.ops.cuda_build")
    cb.build(["gc"])
    ptx = cs.ptxas_by_function(cb.log_path("gc").read_text())
    sass = cs.sass_by_function(cb.lib_path("gc"))
    shapes = []
    for i, (what, S, W, bp) in enumerate(cs.GC_TIMING):
        g_ms, e_ms, outs = cs.gc_time_shape(torch, gcc, S, W, bp, seed + i)
        digest = kernel_ab.digest(outs)
        del outs
        torch.cuda.empty_cache()
        shapes.append({"what": what, "S": S, "W": W, "bp": bp, "garble_ms": g_ms,
                       "eval_ms": e_ms, "digest": digest} | {
            which: {"ptxas": cs.gc_instantiation(ptx, which, S, W),
                    "sass_instructions": cs.gc_instantiation(sass, which, S, W)}
            for which in ("garble", "eval")})
    return shapes


def turn_line(s: dict) -> str:
    return f"{s['what']} S={s['S']} W={s['W']}: garble {s['garble_ms']:.4f} eval {s['eval_ms']:.4f} ms"


def summary(cs, by_tree: dict, order: str) -> list:
    """One shape's rows: each kernel's milliseconds a tree, its least and
    its ratio to the bound."""
    rows = []
    s = next(iter(by_tree.values()))[0]
    what, S, W, bp = s["what"], s["S"], s["W"], s["bp"]
    for kn, which in (("gc_garble", "garble"), ("gc_eval", "eval")):
        b_ms, b_by = cs.secure_bound(kn, S, W, bp)
        for name, mine in by_tree.items():
            ms = [t[f"{which}_ms"] for t in mine]
            inst = mine[0][which]
            ptx = inst["ptxas"] or {}
            r = {"kernel": kn, "what": what, "S": S, "W": W, "bp": bp, "tree": name, "ms": ms,
                 "min_ms": min(ms), "bound_ms": b_ms, "bound_by": b_by,
                 "ratio": min(ms) / b_ms, **ptx, "sass_instructions": inst["sass_instructions"]}
            rows.append(r)
            print(f"{kn} {what} S={S} W={W} bp={bp} tree {name}: ms "
                  f"{' / '.join(f'{m:.4f}' for m in ms)} (least {r['min_ms']:.4f}) "
                  f"bound {b_ms:.4f} ({b_by}) ratio {r['ratio']:.3f}; registers "
                  f"{ptx.get('registers')} spills {ptx.get('spill_stores')}/"
                  f"{ptx.get('spill_loads')} B sass {inst['sass_instructions']}", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(kernel_ab.main("gc_ab", __doc__, __file__, worker, turn_line, summary,
                            TURN_TIMEOUT_S))
