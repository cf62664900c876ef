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
// Bound on the H100: integer ALU.  Per key per level it runs 2 ChaCha8
// blocks (~400 32-bit add/xor/rotate each) against ~21 bytes of traffic
// (1 alpha byte read, 16 B cw seed + 2 + 2 B bits written), so the
// operation count, not the 3.35 TB/s memory, sets the floor.
//
// Design: the TPU kernel carries the recurrence across level blocks in VMEM
// scratch, relying on its grid running in order.  Hopper blocks run in no
// order, so here ONE THREAD OWNS ONE KEY and walks all L levels with both
// parties' seeds (8 words) and t bits (2) in registers.  The outputs keep
// the JAX package's [K, L, words] layout, in which one key's levels are
// contiguous and neighbouring keys are L * 16 B apart; a thread storing
// its own level straight to device memory half-fills one 32 B sector per
// store, and the sector is completed only a level later, after thousands
// of other threads' partial writes have passed through L2.  So the block
// walks the levels in tiles of LB levels, as the TPU kernel writes a
// lane-contiguous block per grid step:
//   - each thread loads its LB alpha bytes with one uint4 load and keeps
//     them as an LB-bit mask;
//   - it runs the LB levels and writes each level's correction words into
//     a shared-memory tile [T keys][LB levels] (rows padded by one entry,
//     so the per-thread writes hit distinct banks);
//   - the block then stores the tile with consecutive lanes on consecutive
//     levels of one key: a warp store covers 32 / LB keys' whole runs of
//     LB levels, 16 * LB contiguous bytes of cw seed and 2 * LB of each bit
//     array per key, whole sectors and lines instead of halves.
// An L that is not a multiple of LB ends in a short tile, and its rows
// are not 16 B aligned, so such an L reads alpha byte by byte in every
// tile.  A block past the last key, and the threads of the last block past
// K, idle through the tile loop (they take part in its barriers).
#include "chacha.cuh"

FHH_ERROR_STRING_FN

namespace {

constexpr int T = 128;  // keys (threads) per block
constexpr int LB = 16;  // levels per tile: 16 B of alpha, 256 B of cw seed per key

// The alpha bytes of levels [l0, l0 + nl) of one key as a bit mask (bit j
// = level l0 + j).  One uint4 load when every tile is whole (L a multiple
// of LB), so that each tile starts 16 B aligned (the wrapper aligns alpha).
__device__ __forceinline__ uint32_t alpha_mask(const uint8_t* __restrict__ a, int nl,
                                               bool vec) {
    uint32_t m = 0u;
    if (vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(a);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                m |= (((w[i] >> (8 * b)) & 0xFFu) != 0u ? 1u : 0u) << (4 * i + b);
    } else {
        for (int j = 0; j < nl; ++j) m |= (a[j] != 0 ? 1u : 0u) << j;
    }
    return m;
}

}  // namespace

__global__ void __launch_bounds__(T)
fhh_keygen_kernel(const uint4* __restrict__ init_seeds,   // [K, 2] x 4 words
                  const uint8_t* __restrict__ alpha,       // [K, L] 0/1
                  const uint8_t* __restrict__ side,        // [K] 0/1
                  uint4* __restrict__ cw_seed,             // [K, L] x 4 words
                  uint16_t* __restrict__ cw_bits,          // [K, L] x 2 bytes
                  uint16_t* __restrict__ cw_y,             // [K, L] x 2 bytes
                  long long K, int L, int derived) {
    __shared__ uint4 tile_cw[T][LB + 1];
    __shared__ uint32_t tile_by[T][LB + 1];  // cw bits | cw y << 16
    const int tid = threadIdx.x;
    const long long k0 = (long long)blockIdx.x * T;
    const long long k = k0 + tid;
    const bool active = k < K;
    const int nk = (int)(K - k0 < T ? K - k0 : T);  // keys of this block
    uint4 s0 = make_uint4(0u, 0u, 0u, 0u), s1 = s0;
    uint32_t t0 = 0u, t1 = 1u, sd = 0u;
    if (active) {
        s0 = init_seeds[2 * k];
        s1 = init_seeds[2 * k + 1];
        sd = side[k] ? 1u : 0u;
    }
    const uint8_t* arow = alpha + (size_t)(active ? k : 0) * (size_t)L;
    const bool vec = (L % LB) == 0;
    for (int l0 = 0; l0 < L; l0 += LB) {
        const int nl = L - l0 < LB ? L - l0 : LB;
        if (active) {
            const uint32_t am = alpha_mask(arow + l0, nl, vec);
#pragma unroll 1
            for (int j = 0; j < nl; ++j) {
                uint32_t in[4], o0[16], o1[16];
                in[0] = s0.x; in[1] = s0.y; in[2] = s0.z; in[3] = s0.w;
                fhh_chacha_masked(in, o0);
                in[0] = s1.x; in[1] = s1.y; in[2] = s1.z; in[3] = s1.w;
                fhh_chacha_masked(in, o1);
                uint32_t b0l, b0r, y0l, y0r, b1l, b1r, y1l, y1r;
                fhh_prg_bits(o0, derived, b0l, b0r, y0l, y0r);
                fhh_prg_bits(o1, derived, b1l, b1r, y1l, y1r);
                const uint32_t keep = (am >> j) & 1u;
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
                tile_cw[tid][j] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
                tile_by[tid][j] = cwb_l | (cwb_r << 8) | (cwy_l << 16) | (cwy_r << 24);
                // each party keeps the alpha-direction child, corrected iff
                // its t bit is set (ibDCF.rs:109-117)
                const uint32_t cw_keep = keep ? cwb_r : cwb_l;
                const uint32_t m0 = 0u - t0, m1 = 0u - t1;
                uint32_t n0[4], n1[4];
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    const uint32_t k0w = keep ? o0[4 + w] : o0[w];
                    const uint32_t k1w = keep ? o1[4 + w] : o1[w];
                    n0[w] = k0w ^ (m0 & cw[w]);
                    n1[w] = k1w ^ (m1 & cw[w]);
                }
                s0 = make_uint4(n0[0], n0[1], n0[2], n0[3]);
                s1 = make_uint4(n1[0], n1[1], n1[2], n1[3]);
                t0 = (keep ? b0r : b0l) ^ (t0 & cw_keep);
                t1 = (keep ? b1r : b1l) ^ (t1 & cw_keep);
            }
        }
        __syncthreads();
        // the tile to device memory: item (key i, level j), j fastest, so
        // consecutive lanes store consecutive levels of one key (a short
        // last tile leaves the lanes of its missing levels idle)
        for (int it = tid; it < nk * LB; it += T) {
            const int i = it / LB, j = it % LB;
            if (j < nl) {
                const size_t o = (size_t)(k0 + i) * (size_t)L + (size_t)(l0 + j);
                const uint32_t by = tile_by[i][j];
                cw_seed[o] = tile_cw[i][j];
                cw_bits[o] = (uint16_t)by;
                cw_y[o] = (uint16_t)(by >> 16);
            }
        }
        __syncthreads();  // the next tile overwrites this one
    }
}

extern "C" int fhh_keygen_launch(const void* init_seeds, const void* alpha,
                                 const void* side, void* cw_seed, void* cw_bits,
                                 void* cw_y, long long K, int L, int derived,
                                 void* stream) {
    if (K == 0 || L == 0) return 0;
    const long long blocks = (K + T - 1) / T;
    fhh_keygen_kernel<<<(unsigned)blocks, T, 0, (cudaStream_t)stream>>>(
        (const uint4*)init_seeds, (const uint8_t*)alpha, (const uint8_t*)side,
        (uint4*)cw_seed, (uint16_t*)cw_bits, (uint16_t*)cw_y, K, L, derived);
    return (int)cudaGetLastError();
}
