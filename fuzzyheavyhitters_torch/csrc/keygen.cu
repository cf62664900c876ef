// ibDCF key generation: the whole level recurrence of both parties in one
// kernel (ref: src/ibDCF.rs:84-164 gen_cor_word + the keygen loop).
//
// Replaces: fuzzyheavyhitters_tpu/ops/keygen_pallas.py:_gen_pallas (the
// pallas_call at :206, kernel body _kernel at :72-160).
//
// What it computes, per key k of K (a key = one (client, dim, side)):
// two ChaCha8 expansions per level (one per party), the correction words
// (seed, t bits, y bits) of that level, and each party's kept child state.
// Party 0 starts with t = 0, party 1 with t = 1 (ibDCF.rs:143-146).
//
// Design: the TPU kernel carries the recurrence across level blocks in VMEM
// scratch, relying on its grid running in order.  Hopper blocks run in no
// order, so here ONE THREAD OWNS ONE KEY and walks all L levels with both
// parties' seeds (8 words) and t bits (2) in registers; nothing goes back
// to device memory between levels.
//
// Bound on the H100: integer ALU.  Per key per level it runs 2 ChaCha8
// blocks (~400 32-bit add/xor/rotate each) against ~19 bytes of traffic
// (1 alpha byte read, 16 B cw seed + 2 + 2 B bits written), so the
// operation count, not the 3.35 TB/s memory, sets the floor.  The outputs
// keep the JAX package's [K, L, words] layout, so one thread's stores of
// consecutive levels are 16 B apart and neighbouring threads are L*16 B
// apart: each warp store touches 32 sectors.  Consecutive levels of one
// thread fill the same 32 B sectors, which L2 merges before write-back;
// the cost is recorded in PERF.md and coalescing is later work.
#include "chacha.cuh"

FHH_ERROR_STRING_FN

__global__ void __launch_bounds__(128)
fhh_keygen_kernel(const uint4* __restrict__ init_seeds,   // [K, 2] x 4 words
                  const uint8_t* __restrict__ alpha,       // [K, L] 0/1
                  const uint8_t* __restrict__ side,        // [K] 0/1
                  uint4* __restrict__ cw_seed,             // [K, L] x 4 words
                  uint16_t* __restrict__ cw_bits,          // [K, L] x 2 bytes
                  uint16_t* __restrict__ cw_y,             // [K, L] x 2 bytes
                  long long K, int L, int derived) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    uint4 s0 = init_seeds[2 * k], s1 = init_seeds[2 * k + 1];
    uint32_t t0 = 0u, t1 = 1u;
    const uint32_t sd = side[k] ? 1u : 0u;
    const size_t row = (size_t)k * (size_t)L;
    for (int l = 0; l < L; ++l) {
        uint32_t in[4], o0[16], o1[16];
        in[0] = s0.x; in[1] = s0.y; in[2] = s0.z; in[3] = s0.w;
        fhh_chacha_masked(in, o0);
        in[0] = s1.x; in[1] = s1.y; in[2] = s1.z; in[3] = s1.w;
        fhh_chacha_masked(in, o1);
        uint32_t b0l, b0r, y0l, y0r, b1l, b1r, y1l, y1r;
        fhh_prg_bits(o0, derived, b0l, b0r, y0l, y0r);
        fhh_prg_bits(o1, derived, b1l, b1r, y1l, y1r);
        const uint32_t keep = alpha[row + l] ? 1u : 0u;
        const uint32_t km = 0u - keep;
        // lose-direction child seeds XOR across parties (ibDCF.rs:95-97)
        uint32_t cw[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const uint32_t lx = o0[w] ^ o1[w], rx = o0[4 + w] ^ o1[4 + w];
            cw[w] = rx ^ (km & (lx ^ rx));  // keep ? left : right
        }
        const uint32_t cwb_l = b0l ^ b1l ^ keep ^ 1u;
        const uint32_t cwb_r = b0r ^ b1r ^ keep;
        const uint32_t cwy_l = y0l ^ y1l ^ (keep & (sd ^ 1u));
        const uint32_t cwy_r = y0r ^ y1r ^ ((keep ^ 1u) & sd);
        cw_seed[row + l] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
        cw_bits[row + l] = (uint16_t)(cwb_l | (cwb_r << 8));
        cw_y[row + l] = (uint16_t)(cwy_l | (cwy_r << 8));
        // each party keeps the alpha-direction child, corrected iff its
        // t bit is set (ibDCF.rs:109-117)
        const uint32_t cw_keep = keep ? cwb_r : cwb_l;
        const uint32_t m0 = 0u - t0, m1 = 0u - t1;
        uint32_t n0[4], n1[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const uint32_t k0 = keep ? o0[4 + w] : o0[w];
            const uint32_t k1 = keep ? o1[4 + w] : o1[w];
            n0[w] = k0 ^ (m0 & cw[w]);
            n1[w] = k1 ^ (m1 & cw[w]);
        }
        s0 = make_uint4(n0[0], n0[1], n0[2], n0[3]);
        s1 = make_uint4(n1[0], n1[1], n1[2], n1[3]);
        t0 = (keep ? b0r : b0l) ^ (t0 & cw_keep);
        t1 = (keep ? b1r : b1l) ^ (t1 & cw_keep);
    }
}

extern "C" int fhh_keygen_launch(const void* init_seeds, const void* alpha,
                                 const void* side, void* cw_seed, void* cw_bits,
                                 void* cw_y, long long K, int L, int derived,
                                 void* stream) {
    if (K == 0) return 0;
    const int threads = 128;
    const long long blocks = (K + threads - 1) / threads;
    fhh_keygen_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint4*)init_seeds, (const uint8_t*)alpha, (const uint8_t*)side,
        (uint4*)cw_seed, (uint16_t*)cw_bits, (uint16_t*)cw_y, K, L, derived);
    return (int)cudaGetLastError();
}
