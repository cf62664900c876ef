// Fixed-key ChaCha8 block function for one thread, shared by the keygen
// and expand kernels.  Bit-identical to fuzzyheavyhitters_torch/ops/prg.py
// (and to the JAX package's ops/prg.py): 4 constant words, the 8 fixed-key
// words (pi), the 4 input-block words; N_ROUNDS = 8 rounds; feed-forward add.
// The 16 state words live in registers; rotations are one funnel shift.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FHH_CHACHA_ROUNDS 8
#define FHH_SEED_MASK 0xFFFFFFF0u  // prg.rs:97 key_short on word 0

__device__ __forceinline__ uint32_t fhh_rotl(uint32_t x, int n) {
    return __funnelshift_l(x, x, n);
}

#define FHH_QR(a, b, c, d)                      \
    a += b; d ^= a; d = fhh_rotl(d, 16);        \
    c += d; b ^= c; b = fhh_rotl(b, 12);        \
    a += b; d ^= a; d = fhh_rotl(d, 8);         \
    c += d; b ^= c; b = fhh_rotl(b, 7);

// out[16] = ChaCha8(in[4]) with the seed mask applied to in[0] first.
__device__ __forceinline__ void fhh_chacha_masked(const uint32_t in[4], uint32_t out[16]) {
    const uint32_t i0 = in[0] & FHH_SEED_MASK;
    uint32_t x0 = 0x61707865u, x1 = 0x3320646Eu, x2 = 0x79622D32u, x3 = 0x6B206574u;
    uint32_t x4 = 0x243F6A88u, x5 = 0x85A308D3u, x6 = 0x13198A2Eu, x7 = 0x03707344u;
    uint32_t x8 = 0xA4093822u, x9 = 0x299F31D0u, x10 = 0x082EFA98u, x11 = 0xEC4E6C89u;
    uint32_t x12 = i0, x13 = in[1], x14 = in[2], x15 = in[3];
#pragma unroll
    for (int r = 0; r < FHH_CHACHA_ROUNDS / 2; ++r) {
        FHH_QR(x0, x4, x8, x12)
        FHH_QR(x1, x5, x9, x13)
        FHH_QR(x2, x6, x10, x14)
        FHH_QR(x3, x7, x11, x15)
        FHH_QR(x0, x5, x10, x15)
        FHH_QR(x1, x6, x11, x12)
        FHH_QR(x2, x7, x8, x13)
        FHH_QR(x3, x4, x9, x14)
    }
    out[0] = x0 + 0x61707865u;  out[1] = x1 + 0x3320646Eu;
    out[2] = x2 + 0x79622D32u;  out[3] = x3 + 0x6B206574u;
    out[4] = x4 + 0x243F6A88u;  out[5] = x5 + 0x85A308D3u;
    out[6] = x6 + 0x13198A2Eu;  out[7] = x7 + 0x03707344u;
    out[8] = x8 + 0xA4093822u;  out[9] = x9 + 0x299F31D0u;
    out[10] = x10 + 0x082EFA98u; out[11] = x11 + 0xEC4E6C89u;
    out[12] = x12 + i0;         out[13] = x13 + in[1];
    out[14] = x14 + in[2];      out[15] = x15 + in[3];
}

// t/y bits of one expansion (prg.rs:103-104): derived from output word 8,
// or the reference's constant (1, 1)/(1, 1) quirk.  Bits as 0/1 words.
__device__ __forceinline__ void fhh_prg_bits(const uint32_t out[16], int derived,
                                             uint32_t& tl, uint32_t& tr,
                                             uint32_t& yl, uint32_t& yr) {
    if (derived) {
        const uint32_t w8 = out[8];
        tl = (w8 & 1u) ^ 1u;
        tr = ((w8 >> 1) & 1u) ^ 1u;
        yl = ((w8 >> 2) & 1u) ^ 1u;
        yr = ((w8 >> 3) & 1u) ^ 1u;
    } else {
        tl = tr = yl = yr = 1u;
    }
}

#define FHH_ERROR_STRING_FN                                          \
    extern "C" const char* fhh_error_string(int code) {              \
        return cudaGetErrorString(static_cast<cudaError_t>(code));   \
    }
