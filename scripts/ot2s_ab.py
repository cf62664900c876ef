"""Time the 1-of-2^S OT step (``secure.ot2s_encrypt_packed`` /
``ot2s_decrypt_packed``, whatever kernels and passes sit under them) of
several trees of the port on one card, in turns.

    python scripts/ot2s_ab.py --tree A=chipcheck/parent --tree B=. --order ABBA \\
        --profiler A --out build/ot2s_ab.json

Each turn is one process that imports the tree's own package (the tree
first on ``PYTHONPATH``), builds its ``ot2s.cu`` into the tree's build
directory (a tree's first turn builds, its later turns load), and times
each level's encrypt and decrypt step at ``chip_smoke.OT2S_TIMING``'s
shapes through the tree's ``protocol/secure.py`` with
``chip_smoke.ot2s_time_shape`` (this repository's ``chip_smoke.py``, the
same seeds in every turn): the step's milliseconds (CUDA events, warm), its
device milliseconds and its host microseconds a call.  The device time is
a CUDA graph's replay, or ``torch.profiler``'s for each tree named by
``--profiler`` (a step that copies from host memory, as the parent of the
redesign's does, cannot be captured in a graph); each row says which.
Printed per shape and step: every turn's figures, each tree's least, its
ratio to the bound (``chip_smoke.secure_bound``; decrypt also to its
32-byte sector floor, ``chip_smoke.ot2s_floor``) and each tree's speed-up
over the first tree of ``--order``; per tree, the ptxas registers and
spills and the SASS instructions of the kernel that ran.  Every turn
digests every output (SHA-256): the digests must agree across turns and
trees, or the script exits 1.  The turns, the digests and ``--out`` are
``scripts/kernel_ab.py``'s.
"""

from __future__ import annotations

import sys

import kernel_ab

TURN_TIMEOUT_S = 600
STEPS = (("ot2s_encrypt", "encrypt", "enc"), ("ot2s_decrypt", "decrypt", "dec"))
PROFILER = ("profiler", "a tree whose device time torch.profiler reads, for a step that "
            "a CUDA graph cannot capture (default: a graph's replay)")


def worker(cs, tree: str, seed: int, profiler: bool) -> list:
    """One turn: time every shape of OT2S_TIMING with ``tree``'s step."""
    import torch

    secure = kernel_ab.tree_module(tree, "fuzzyheavyhitters_torch.protocol.secure")
    cb = kernel_ab.tree_module(tree, "fuzzyheavyhitters_torch.ops.cuda_build")
    cb.build(["ot2s"])
    ptx = cs.ptxas_by_function(cb.log_path("ot2s").read_text())
    sass = cs.sass_by_function(cb.lib_path("ot2s"))
    shapes = []
    for i, (what, S, W, B) in enumerate(cs.OT2S_TIMING):
        steps, y, outs = cs.ot2s_time_shape(torch, secure, S, W, B, seed + i,
                                            graph=not profiler)
        digest = kernel_ab.digest(outs)
        floor = cs.ot2s_floor(y, W)[0]
        del outs, y
        torch.cuda.empty_cache()
        shapes.append({"what": what, "S": S, "W": W, "B": B, "steps": steps,
                       "floor32_ms": floor, "digest": digest} | {
            which: {"ptxas": cs.ot2s_instantiation(ptx, which, S, W),
                    "sass_instructions": cs.ot2s_instantiation(sass, which, S, W)}
            for which in ("enc", "dec")})
    return shapes


def turn_line(s: dict) -> str:
    return (f"{s['what']} S={s['S']} W={s['W']}: encrypt {s['steps']['encrypt']['ms']:.4f} "
            f"decrypt {s['steps']['decrypt']['ms']:.4f} ms")


def summary(cs, by_tree: dict, order: str) -> list:
    """One shape's rows: each step's figures a tree, its least, its ratios
    to the bound (and decrypt's to its floor) and its speed-up over the
    first tree of ``order``."""
    rows = []
    s = by_tree[order[0]][0]
    what, S, W, B = s["what"], s["S"], s["W"], s["B"]
    for kn, step, which in STEPS:
        b_ms, b_by = cs.secure_bound(kn, S, W, B, B)
        least = {}
        for name, mine in by_tree.items():
            fig = {k: [t["steps"][step][k] for t in mine] for k in ("ms", "device_ms", "host_us")}
            least[name] = {k: min(v) for k, v in fig.items()}
            inst = mine[0][which]
            ptx = inst["ptxas"] or {}
            row = {"kernel": kn, "what": what, "S": S, "W": W, "B": B, "tree": name, **fig,
                   **{f"min_{k}": v for k, v in least[name].items()},
                   "device_by": mine[0]["steps"][step]["device_by"],
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ratio": least[name]["device_ms"] / b_ms, **ptx,
                   "sass_instructions": inst["sass_instructions"],
                   "speedup": {k: least[order[0]][k] / least[name][k] for k in least[name]}}
            floor = ""
            if kn == "ot2s_decrypt":
                row["floor32_ms"] = mine[0]["floor32_ms"]
                row["device_floor_ratio"] = least[name]["device_ms"] / row["floor32_ms"]
                floor = (f", floor {row['floor32_ms']:.4f} (device "
                         f"{row['device_floor_ratio']:.3f}x)")
            rows.append(row)
            print(f"{kn} {what} S={S} W={W} B={B} tree {name}: ms "
                  f"{' / '.join(f'{m:.4f}' for m in fig['ms'])} (least "
                  f"{least[name]['ms']:.4f}, device {least[name]['device_ms']:.4f} by "
                  f"{row['device_by']}, host {least[name]['host_us']:.1f} us) bound {b_ms:.4f} "
                  f"({b_by}, device {row['device_ratio']:.3f}x){floor}; over {order[0]}: step "
                  f"{row['speedup']['ms']:.2f}x, device {row['speedup']['device_ms']:.2f}x, "
                  f"host {row['speedup']['host_us']:.2f}x; registers "
                  f"{ptx.get('registers')} spills {ptx.get('spill_stores')}/"
                  f"{ptx.get('spill_loads')} B sass {inst['sass_instructions']}", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(kernel_ab.main("ot2s_ab", __doc__, __file__, worker, turn_line, summary,
                            TURN_TIMEOUT_S, PROFILER))
