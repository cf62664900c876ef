"""Probe how fast the card reads sparse 32-byte sectors, and how close a
bare gather comes to decrypt's sector floor at the ot2s timing line's
shapes.

    python scripts/ot2s_sector_probe.py [--out build/ot2s_sector_probe.json]

Builds two small probe kernels (their source is below, compiled by
``nvcc`` for ``sm_90a`` into the port's build directory) and times each
with CUDA events (warm, mean of ``REPS`` launches):

- ``sectors``: k sectors of every 128-byte line of a 4 GiB buffer (the
  sectors each pattern names), in 16-byte loads, by each load instruction
  of ``LOADS`` (a C++ load; ``ld.global.nc`` with no L2
  prefetch size, with 64 and 128 bytes, and with ``L1::no_allocate``).
  Printed: ms, the sectors' bytes over the time (useful GB/s) and the
  lines' bytes and the 64-byte halves' bytes over the same time: a rate
  above the card's 3.35 TB/s says that the card did not fetch whole lines
  (or halves).
- at each shape of ``chip_smoke.OT2S_TIMING``, on one draw of random
  choices: ``decrypt`` (``otext_cuda.dec_planar`` on the planar table),
  ``gather`` by each load of ``LOADS`` (decrypt without rows or hash: one
  choice byte a test, its W words of slot y loaded at once, W words
  stored) and ``planes`` (the same words by C++ loads, slot by slot: a warp
  issues slot c's loads for the lanes that chose c, c = 0 .. 2^S - 1, so a
  warp's load touches one plane).  Each gather is checked against the
  table's slots first.  Printed beside each: its time over the 32- and
  64-byte sector floors and over the 128-byte lines of the sectors opened
  (``chip_smoke.ot2s_floor``; a gather's floors count its own bytes: one
  choice byte and 4W out a test).

Prints the card's name and power limit first, then the load instructions
(``LDG`` opcodes in ``cuobjdump -sass``) of the probe's kernels and of
ot2s.cu's decrypt kernels, and a JSON object of every figure last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from fuzzyheavyhitters_torch.ops import cuda_build, otext_cuda  # noqa: E402

REPS = 20
LINES = 1 << 25  # 4 GiB of 128-byte lines
# sectors read of each line (probe_sectors_launch's p)
PATTERNS = ((0,), (0, 1), (0, 2), (0, 1, 2), (0, 1, 2, 3))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

// LOADS: 0 a C++ load, 1 ld.global.nc with no prefetch size, 2 and 3 with
// an L2 prefetch of 64 and 128 bytes, 4 ld.global.nc.L1::no_allocate.
template <int L>
__device__ __forceinline__ uint32_t probe_ld(const uint32_t* p) {
    uint32_t v;
    if constexpr (L == 0) v = *p;
    if constexpr (L == 1) asm("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
    if constexpr (L == 2) asm("ld.global.nc.L2::64B.b32 %0, [%1];" : "=r"(v) : "l"(p));
    if constexpr (L == 3) asm("ld.global.nc.L2::128B.b32 %0, [%1];" : "=r"(v) : "l"(p));
    if constexpr (L == 4)
        asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// 16 bytes at p by the load L of probe_ld.
template <int L>
__device__ __forceinline__ uint4 probe_ld4(const uint4* p) {
    uint4 v;
    if constexpr (L == 0) v = *p;
#define LD4(q)                                                                               \
    asm(q " {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p))
    if constexpr (L == 1) LD4("ld.global.nc.v4.u32");
    if constexpr (L == 2) LD4("ld.global.nc.L2::64B.v4.u32");
    if constexpr (L == 3) LD4("ld.global.nc.L2::128B.v4.u32");
    if constexpr (L == 4) LD4("ld.global.nc.L1::no_allocate.v4.u32");
#undef LD4
    return v;
}

// Sectors ORDER[j] (4 bits each, j < K) of each 128-byte line: piece g
// (16 bytes) is half g % 2 of the (g / 2 % K)-th sector of line g / 2K,
// grid-stride, four pieces in flight a thread.
template <int K, unsigned ORDER, int L>
__global__ void probe_sectors(const uint4* __restrict__ buf, long long lines,
                              uint32_t* __restrict__ sink) {
    uint32_t acc = 0u;
    const long long n = lines * 2 * K, step = (long long)gridDim.x * blockDim.x;
#pragma unroll 4
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n; g += step) {
        const long long line = g / (2 * K);
        const int j = (int)(g % (2 * K));
        const uint4 v = probe_ld4<L>(buf + line * 8 + ((ORDER >> (4 * (j >> 1))) & 15u) * 2
                                     + (j & 1));
        acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    if (acc == 0x9E3779B9u) *sink = acc;
}

// Test t opens slot c[t] of a planar table (word w of slot c at
// cts[(c * W + w) * bp + t]) and stores its W words.  PLANES: issue the
// loads slot by slot, each warp's load instruction on one plane.
template <int C, int W, bool PLANES, int L>
__global__ void probe_gather(const uint8_t* __restrict__ c, const uint32_t* __restrict__ cts,
                             long long bp, long long B, uint4* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    const int ci = c[t];
    uint32_t v[W];
    if (PLANES) {
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = 0u;
#pragma unroll 1
        for (int cc = 0; cc < C; ++cc)
            if (ci == cc) {
#pragma unroll
                for (int w = 0; w < W; ++w)
                    v[w] = probe_ld<L>(cts + (long long)(cc * W + w) * bp + t);
            }
    } else {
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = probe_ld<L>(cts + (long long)(ci * W + w) * bp + t);
    }
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
        out[t * (W / 4) + k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <int K, unsigned ORDER>
static int sectors(const void* buf, long long lines, int load, void* sink, cudaStream_t st) {
#define L(l)                                                                                 \
    if (load == l) {                                                                         \
        probe_sectors<K, ORDER, l><<<132 * 16, 256, 0, st>>>((const uint4*)buf, lines,      \
                                                            (uint32_t*)sink);                \
        return (int)cudaGetLastError();                                                      \
    }
    L(0) L(1) L(2) L(3) L(4)
#undef L
    return -1;
}

// Pattern p of PATTERNS: sectors {0}, {0, 1}, {0, 2}, {0, 1, 2}, {0, 1, 2, 3}.
extern "C" int probe_sectors_launch(const void* buf, long long lines, int p, int load,
                                    void* sink, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (p) {
        case 0: return sectors<1, 0x0u>(buf, lines, load, sink, st);
        case 1: return sectors<2, 0x10u>(buf, lines, load, sink, st);
        case 2: return sectors<2, 0x20u>(buf, lines, load, sink, st);
        case 3: return sectors<3, 0x210u>(buf, lines, load, sink, st);
        case 4: return sectors<4, 0x3210u>(buf, lines, load, sink, st);
    }
    return -1;
}

template <int C, int W>
static int gather(const void* c, const void* cts, long long bp, long long B, int planes,
                  int load, void* out, cudaStream_t st) {
    const unsigned blocks = (unsigned)((B + 255) / 256);
#define L(p, l)                                                                              \
    if (planes == p && load == l) {                                                          \
        probe_gather<C, W, p, l><<<blocks, 256, 0, st>>>(                                    \
            (const uint8_t*)c, (const uint32_t*)cts, bp, B, (uint4*)out);                    \
        return (int)cudaGetLastError();                                                      \
    }
    L(0, 0) L(0, 1) L(0, 2) L(0, 3) L(0, 4) L(1, 0)
#undef L
    return -1;
}

extern "C" int probe_gather_launch(const void* c, const void* cts, long long bp, long long B,
                                   int S, int W, int planes, int load, void* out,
                                   void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define X(s, w) \
    if (S == s && W == w) return gather<1 << s, w>(c, cts, bp, B, planes, load, out, st);
    X(2, 4) X(2, 8) X(4, 4) X(4, 8) X(6, 4) X(6, 8)
#undef X
    return -1;
}
"""


def build():
    """Compile SOURCE into the build directory (once per source) and load
    it -> (library, its path)."""
    import hashlib

    d = cuda_build.build_dir()
    d.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256((SOURCE + " ".join(cuda_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    so = d / f"libot2s_sector_probe-{tag}.so"
    if not so.exists():
        src = d / f"ot2s_sector_probe-{tag}.cu"
        src.write_text(SOURCE)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_sectors_launch.argtypes = [vp, ll, i, i, vp, vp]
    lib.probe_gather_launch.argtypes = [vp, vp, ll, ll, i, i, i, i, vp, vp]
    return lib, so


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {rc}")


LOADS = ("c++", "nc", "nc.L2::64B", "nc.L2::128B", "nc.L1::no_allocate")  # probe_ld<L>


def sector_rates(torch, lib) -> list:
    """Each pattern of PATTERNS over LINES lines with each load of LOADS:
    ms and rates."""
    buf = torch.zeros(LINES * 32, dtype=torch.int32, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    st = cuda_build.stream_ptr(buf)
    rows = []
    for p, pat in enumerate(PATTERNS):
        halves = len({s // 2 for s in pat})
        for load, load_name in enumerate(LOADS):
            fn = lambda: _ok(lib.probe_sectors_launch(buf.data_ptr(), LINES, p, load,
                                                      sink.data_ptr(), st), "sectors")
            ms = cs.cuda_ms(fn, REPS, warm=True)
            r = {"sectors": list(pat), "load": load_name, "ms": ms,
                 "useful_GB_s": LINES * 32 * len(pat) / ms / 1e6,
                 "half64_GB_s": LINES * 64 * halves / ms / 1e6,
                 "line_GB_s": LINES * 128 / ms / 1e6}
            rows.append(r)
            print(f"sectors {pat} of each of {LINES} lines, ld {load_name}: ms={ms:.4f} "
                  f"useful_GB/s={r['useful_GB_s']:.1f} half64_GB/s={r['half64_GB_s']:.1f} "
                  f"line_GB/s={r['line_GB_s']:.1f}", flush=True)
    del buf
    torch.cuda.empty_cache()
    return rows


def shape_rows(torch, lib, seed: int) -> list:
    """decrypt, the gathers (each load of LOADS) and planes at each
    OT2S_TIMING shape."""
    gc = cs._ops("gc")
    rows = []
    for i, (what, S, W, B) in enumerate(cs.OT2S_TIMING):
        g = torch.Generator(device="cuda").manual_seed(seed + i)
        bp = gc.padded_tests(B)
        t_rows = torch.randint(-2**31, 2**31, (B, S, 4), dtype=torch.int32, device="cuda",
                               generator=g)
        y = torch.randint(0, 2, (B, S), dtype=torch.bool, device="cuda", generator=g)
        c = ((y.to(torch.int32) << torch.arange(S, device="cuda", dtype=torch.int32))
             .sum(dim=1).to(torch.uint8))
        table = torch.randint(-2**31, 2**31, ((1 << S) * W * bp,), dtype=torch.int32,
                              device="cuda", generator=g)
        out = torch.empty((B, W), dtype=torch.int32, device="cuda")
        st = cuda_build.stream_ptr(table)
        want = otext_cuda.table_view(table, S, B)[c.long(), torch.arange(B, device="cuda")]
        fns = {"decrypt": lambda: otext_cuda.dec_planar(t_rows, y, table, cs.CHUNK_IDX0)}
        kinds = [(f"gather {n}", 0, load) for load, n in enumerate(LOADS)] + [("planes", 1, 0)]
        row = {"what": what, "S": S, "W": W, "B": B}
        for name, planes, load in kinds:
            fns[name] = (lambda p=planes, ld=load: _ok(lib.probe_gather_launch(
                c.data_ptr(), table.data_ptr(), bp, B, S, W, p, ld, out.data_ptr(), st),
                "gather"))
            out.zero_()
            fns[name]()
            if not torch.equal(out, want):
                raise AssertionError(f"{what}: {name} disagrees with the table's slots")
        for gr in (32, 64, 128):
            f_ms, _, sectors = cs.ot2s_floor(y, W, gr)
            row[f"sectors{gr}"] = sectors
            row[f"decrypt_floor{gr}_ms"] = f_ms
            row[f"gather_floor{gr}_ms"] = cs.bound(B * (1 + 4 * W) + sectors * gr, 0)[0]
        parts = []
        for name, fn in fns.items():
            ms = row[f"{name}_ms"] = cs.cuda_ms(fn, REPS, warm=True)
            f = "decrypt" if name == "decrypt" else "gather"
            parts.append(f"{name} {ms:.4f} ms (/floor32 {ms / row[f'{f}_floor32_ms']:.3f}, "
                         f"/floor64 {ms / row[f'{f}_floor64_ms']:.3f}, /lines "
                         f"{ms / row[f'{f}_floor128_ms']:.3f})")
        rows.append(row)
        print(f"ot2s sectors {what} S={S} W={W} B={B}: " + "; ".join(parts), flush=True)
        del t_rows, y, c, table, out, want, fns
        torch.cuda.empty_cache()
    return rows


def load_census(lib_path) -> dict:
    """{mangled function: {load opcode: count}} of a built library's SASS
    (``cuobjdump -sass``), for the kernels of this probe and of ot2s.cu."""
    import collections
    import re

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?(LDG\S*)", line)
        if cur is not None and m:
            cur[m.group(1)] += 1
    return {k: dict(v) for k, v in out.items() if v and ("dec" in k or "probe" in k)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", help="write every figure here (JSON)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ot2s_sector_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib, so = build()
    census = load_census(so) | load_census(cuda_build.build(["ot2s"])["ot2s"])
    for fn, ops in census.items():
        print(f"sass loads {fn}: {ops}", flush=True)
    doc = {"smi": smi, "sass_loads": census, "sector_rates": sector_rates(torch, lib),
           "shapes": shape_rows(torch, lib, args.seed)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps({"ot2s_sector_probe": doc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
