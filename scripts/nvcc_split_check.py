#!/usr/bin/env python3
"""Time each kernel source's ``nvcc`` build with and without
``-split-compile=0`` and compare the SASS the two builds hold.

    python3 scripts/nvcc_split_check.py      # on a host with nvcc and cuobjdump

``fuzzyheavyhitters_torch/ops/cuda_build.py`` builds with the flag: it runs
the device optimizer over a source's kernels on every core.  This script
builds every ``csrc/*.cu`` one at a time into a temporary directory, both
ways, prints the seconds of each build and whether the two libraries' SASS
(``cuobjdump -sass``, headers dropped) is byte-equal, and exits non-zero if
any is not.  It prints the host's core count and the ``nvcc`` release.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fuzzyheavyhitters_torch.ops import cuda_build  # noqa: E402

SPLIT = "-split-compile=0"


def sass(path: str, cuobjdump: str) -> str:
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                         check=True).stdout
    return "\n".join(line for line in out.splitlines()
                     if line.strip() and not line.lstrip().startswith(
                         ("Fatbin", "=====", "arch", "code for", "host", "compile_size",
                          "Compiled", "Identifier")))


def main() -> int:
    nvcc = cuda_build.nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    rel = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    print(f"cores {os.cpu_count()}; {rel.strip().splitlines()[-1]}", flush=True)
    base = [f for f in cuda_build.NVCC_FLAGS if f != SPLIT]
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in cuda_build.SOURCES.items():
            codes, secs = [], []
            for flags in (base, base + [SPLIT]):
                out = os.path.join(tmp, f"{name}{len(codes)}.so")
                t0 = time.perf_counter()
                subprocess.run([nvcc, *flags, "-I", str(cuda_build.CSRC), "-o", out,
                                str(cuda_build.CSRC / src)], check=True,
                               stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                secs.append(time.perf_counter() - t0)
                codes.append(sass(out, cuobjdump))
            same = codes[0] == codes[1]
            bad += not same
            print(f"{src}: {secs[0]:.1f} s, with {SPLIT} {secs[1]:.1f} s; SASS "
                  f"{'byte-equal' if same else 'DIFFERS'} ({len(codes[0])} chars)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
