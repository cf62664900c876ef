// The 1-of-2^S chosen-payload equality OT: sender table and receiver open.
//
// Replaces: fuzzyheavyhitters_tpu/ops/otext_pallas.py:_enc_planar (the
// pallas_call at :214, kernel _ot2s_enc_kernel) and :_dec_planar (the
// pallas_call at :259, kernel _ot2s_dec_kernel).
//
// What they compute, per test t of bp (all arrays plane-major [planes, bp]
// int32 words, plane p of test t at p * bp + t):
//   encrypt: comb = GF(2^128) Horner combination of the test's S Q-rows
//     (q planes s*4 + w); for every choice c < 2^S, pad = ChaCha8(comb ^
//     o_c ^ (idx0 + t, TWEAK1, TWEAK2, TWEAK3))[:W] with the offsets o_c
//     (domain already folded into word 1) and ct[c*W + w] = (x == c ?
//     m_v1 : m_v0)[w] ^ pad[w], x the test's S bits as an integer;
//   decrypt: comb of the test's T-rows (domain folded into row 0, word 1),
//     one pad, and the payload = ct[y*W + w] ^ pad[w] for the test's own
//     choice y.
//
// Design: one thread per test.  The 2^S offsets (at most 64 x 4 words) sit
// in shared memory; the thread keeps comb, x and both payloads in
// registers and loops over c (not unrolled: at S = 6 an unrolled body would
// inline 64 ChaCha blocks), writing each choice's W words — neighbouring
// threads write neighbouring words of each plane, so every store is
// coalesced.  The TPU kernel put c on the grid only to keep its Mosaic
// program small, and its decrypt XOR-accumulated a one-hot select over all
// 2^S slots because a VMEM block holds one slot at a time; here the
// receiver reads slot y's W planes alone.
//
// Bound on the H100: encrypt is bound by operations (2^S ChaCha8 blocks per
// test against 16S + 4S + 8W bytes read and 2^S * 4W written); decrypt by
// bytes at small S (one block per test against 16S + 4S + 8W bytes).
#include "chacha.cuh"

FHH_ERROR_STRING_FN

template <int S>
__device__ __forceinline__ void fhh_comb(const uint32_t* __restrict__ rows, size_t t,
                                         size_t bp, uint32_t acc[4]) {
    // Horner: acc = rows[S-1]; acc = 2*acc ^ rows[j] for j = S-2 .. 0
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[w] = (uint32_t)rows[(size_t)((S - 1) * 4 + w) * bp + t];
#pragma unroll
    for (int j = S - 2; j >= 0; --j) {
        const uint32_t hi = acc[3] >> 31;
        acc[3] = (acc[3] << 1) | (acc[2] >> 31);
        acc[2] = (acc[2] << 1) | (acc[1] >> 31);
        acc[1] = (acc[1] << 1) | (acc[0] >> 31);
        acc[0] = (acc[0] << 1) ^ (hi * 0x87u);
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[w] ^= rows[(size_t)(j * 4 + w) * bp + t];
    }
}

template <int S, int W>
__global__ void __launch_bounds__(256)
fhh_ot2s_enc_kernel(const uint32_t* __restrict__ q,     // [4S, bp]
                    const uint32_t* __restrict__ x,     // [S, bp] 0/1
                    const uint32_t* __restrict__ mv0,   // [W, bp]
                    const uint32_t* __restrict__ mv1,   // [W, bp]
                    const uint32_t* __restrict__ offs,  // [2^S, 4]
                    uint32_t* __restrict__ cts,         // [2^S * W, bp]
                    long long bp_, uint32_t idx0) {
    constexpr int C = 1 << S;
    __shared__ uint32_t so[C * 4];
    for (int i = threadIdx.x; i < C * 4; i += blockDim.x) so[i] = offs[i];
    __syncthreads();
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= bp_) return;
    const size_t t = (size_t)tt, bp = (size_t)bp_;
    uint32_t comb[4];
    fhh_comb<S>(q, t, bp, comb);
    uint32_t xi = 0u;
#pragma unroll
    for (int j = 0; j < S; ++j) xi |= (x[(size_t)j * bp + t] & 1u) << j;
    uint32_t m0[W], m1[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        m0[w] = mv0[(size_t)w * bp + t];
        m1[w] = mv1[(size_t)w * bp + t];
    }
    const uint32_t idx = idx0 + (uint32_t)t;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
        const uint32_t row[4] = {comb[0] ^ so[4 * c], comb[1] ^ so[4 * c + 1],
                                 comb[2] ^ so[4 * c + 2], comb[3] ^ so[4 * c + 3]};
        uint32_t pad[W];
        fhh_ot_pad<W>(row, idx, pad);
        const uint32_t eq = 0u - (uint32_t)(xi == (uint32_t)c);
#pragma unroll
        for (int w = 0; w < W; ++w)
            cts[(size_t)(c * W + w) * bp + t] = (m0[w] ^ (eq & (m0[w] ^ m1[w]))) ^ pad[w];
    }
}

template <int S, int W>
__global__ void __launch_bounds__(256)
fhh_ot2s_dec_kernel(const uint32_t* __restrict__ trows,  // [4S, bp], domain folded
                    const uint32_t* __restrict__ y,      // [S, bp] 0/1
                    const uint32_t* __restrict__ cts,    // [2^S * W, bp]
                    uint32_t* __restrict__ pay,          // [W, bp]
                    long long bp_, uint32_t idx0) {
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= bp_) return;
    const size_t t = (size_t)tt, bp = (size_t)bp_;
    uint32_t comb[4];
    fhh_comb<S>(trows, t, bp, comb);
    uint32_t yi = 0u;
#pragma unroll
    for (int j = 0; j < S; ++j) yi |= (y[(size_t)j * bp + t] & 1u) << j;
    uint32_t pad[W];
    fhh_ot_pad<W>(comb, idx0 + (uint32_t)t, pad);
#pragma unroll
    for (int w = 0; w < W; ++w)
        pay[(size_t)w * bp + t] = cts[(size_t)(yi * W + w) * bp + t] ^ pad[w];
}

template <int S, int W>
static int launch_enc(const void* q, const void* x, const void* mv0, const void* mv1,
                      const void* offs, void* cts, long long bp, uint32_t idx0,
                      cudaStream_t st) {
    const long long blocks = (bp + 255) / 256;
    fhh_ot2s_enc_kernel<S, W><<<(unsigned)blocks, 256, 0, st>>>(
        (const uint32_t*)q, (const uint32_t*)x, (const uint32_t*)mv0, (const uint32_t*)mv1,
        (const uint32_t*)offs, (uint32_t*)cts, bp, idx0);
    return (int)cudaGetLastError();
}

template <int S, int W>
static int launch_dec(const void* t, const void* y, const void* cts, void* pay, long long bp,
                      uint32_t idx0, cudaStream_t st) {
    const long long blocks = (bp + 255) / 256;
    fhh_ot2s_dec_kernel<S, W><<<(unsigned)blocks, 256, 0, st>>>(
        (const uint32_t*)t, (const uint32_t*)y, (const uint32_t*)cts, (uint32_t*)pay, bp, idx0);
    return (int)cudaGetLastError();
}

#define FHH_OT2S_CASES(X)                                                        \
    X(2, 4) X(2, 8) X(4, 4) X(4, 8) X(6, 4) X(6, 8)

// Returns a CUDA error code, or -1 for an (S, W) that is not compiled.
extern "C" int fhh_ot2s_enc_launch(const void* q, const void* x, const void* mv0,
                                   const void* mv1, const void* offs, void* cts,
                                   long long bp, int S, int W, unsigned idx0, void* stream) {
    if (bp == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define X(s, w) if (S == s && W == w) return launch_enc<s, w>(q, x, mv0, mv1, offs, cts, bp, idx0, st);
    FHH_OT2S_CASES(X)
#undef X
    return -1;
}

extern "C" int fhh_ot2s_dec_launch(const void* t, const void* y, const void* cts, void* pay,
                                   long long bp, int S, int W, unsigned idx0, void* stream) {
    if (bp == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define X(s, w) if (S == s && W == w) return launch_dec<s, w>(t, y, cts, pay, bp, idx0, st);
    FHH_OT2S_CASES(X)
#undef X
    return -1;
}
