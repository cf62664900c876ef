// Frontier expansion: one crawl level's PRG work for one server.
//
// Replaces: fuzzyheavyhitters_tpu/ops/expand_pallas.py:expand_packed (the
// pallas_call at :182, kernel body _kernel at :59-109).
//
// What it computes, for every row b of B = F * N (frontier node f, client
// n = b % N) and every plane p of d2 = 2 * n_dims (dim, side): one ChaCha8
// expansion of the row's eval-state seed giving BOTH children, the
// t-gated seed correction of each child (ibDCF.rs:213-218), the child t/y
// flags with y accumulated along the path, and the packed share-bit word
// (bit p*2 + dir = y ^ t of that child; collect._bit_positions).
//
// Design: one thread per row b loops over the d2 planes, so it can OR the
// planes' share bits into packed[b] itself — the TPU engine's
// "pack in kernel" point.  All arrays are plane-major with the row index
// fastest, so neighbouring threads read and write neighbouring words in
// every plane (coalesced).  The correction words are per (plane, client)
// and shared by every frontier node: the TPU's N-periodic BlockSpec
// becomes the index b % N into the [.., N] cw arrays — no broadcast is
// materialised, and the cw planes (N * d2 * 17 B, ~7 MB at N = 196,608)
// stay in the 50 MB L2 across the F node passes.  Offsets are size_t: the
// child-seed array reaches ~1.6 G words at bucket 512.
//
// Bound on the H100: both.  Per (row, plane): ~400 integer ops (one
// ChaCha8 block) against ~16 B seed + 2 B flags read, 32 B child seeds +
// 1 B flags written, plus 4 B packed per row.  At 3.35 TB/s vs ~33.5 Tops/s
// (the instruction issue limit) these are within a factor of two of each
// other; PERF.md carries both figures per run.  Without a child cache (the
// last level) only output word 8 is needed, which leaves part of the last
// round and the feed-forward dead.
#include "chacha.cuh"

FHH_ERROR_STRING_FN

__global__ void __launch_bounds__(256)
fhh_expand_kernel(const uint32_t* __restrict__ seed,   // [4, d2, B]
                  const uint8_t* __restrict__ tbit,    // [d2, B] 0/1
                  const uint8_t* __restrict__ ybit,    // [d2, B] 0/1
                  const uint32_t* __restrict__ cws,    // [4, d2, N]
                  const uint8_t* __restrict__ cwf,     // [d2, N] bl|br<<1|yl<<2|yr<<3
                  uint32_t* __restrict__ packed,       // [B]
                  uint32_t* __restrict__ oseeds,       // [2, 4, d2, B]
                  uint8_t* __restrict__ oflags,        // [d2, B] bl|br<<1|yl<<2|yr<<3
                  long long B, long long N, int d2, int derived, int want_children) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t ub = (size_t)b, uB = (size_t)B, uN = (size_t)N;
    const size_t n = ub % uN;
    uint32_t pk = 0u;
    for (int p = 0; p < d2; ++p) {
        const size_t pb = (size_t)p * uB + ub, pn = (size_t)p * uN + n;
        const uint32_t t = tbit[pb] ? 1u : 0u;
        const uint32_t y = ybit[pb] ? 1u : 0u;
        const uint32_t tm = 0u - t;
        uint32_t in[4], out[16];
#pragma unroll
        for (int w = 0; w < 4; ++w) in[w] = seed[(size_t)(w * d2) * uB + pb];
        fhh_chacha_masked(in, out);
        uint32_t tl, tr, yl, yr;
        fhh_prg_bits(out, derived, tl, tr, yl, yr);
        const uint32_t cf = cwf[pn];
        const uint32_t bl = tl ^ (t & (cf & 1u));
        const uint32_t br = tr ^ (t & ((cf >> 1) & 1u));
        const uint32_t ylc = yl ^ (t & ((cf >> 2) & 1u)) ^ y;
        const uint32_t yrc = yr ^ (t & ((cf >> 3) & 1u)) ^ y;
        if (want_children) {
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                const uint32_t cw = tm & cws[(size_t)(w * d2) * uN + pn];
                oseeds[(size_t)(w * d2) * uB + pb] = out[w] ^ cw;
                oseeds[(size_t)((4 + w) * d2) * uB + pb] = out[4 + w] ^ cw;
            }
            oflags[pb] = (uint8_t)(bl | (br << 1) | (ylc << 2) | (yrc << 3));
        }
        pk |= ((bl ^ ylc) << (2 * p)) | ((br ^ yrc) << (2 * p + 1));
    }
    packed[ub] = pk;
}

extern "C" int fhh_expand_launch(const void* seed, const void* tbit, const void* ybit,
                                 const void* cws, const void* cwf, void* packed,
                                 void* oseeds, void* oflags, long long B, long long N,
                                 int d2, int derived, int want_children, void* stream) {
    if (B == 0) return 0;
    const int threads = 256;
    const long long blocks = (B + threads - 1) / threads;
    fhh_expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed, (const uint8_t*)tbit, (const uint8_t*)ybit,
        (const uint32_t*)cws, (const uint8_t*)cwf, (uint32_t*)packed,
        (uint32_t*)oseeds, (uint8_t*)oflags, B, N, d2, derived, want_children);
    return (int)cudaGetLastError();
}
