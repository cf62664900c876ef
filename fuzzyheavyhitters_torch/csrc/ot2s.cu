// The 1-of-2^S chosen-payload equality OT: sender table and receiver open.
//
// Replaces: fuzzyheavyhitters_tpu/ops/otext_pallas.py:_enc_planar (the
// pallas_call at :214, kernel _ot2s_enc_kernel) and :_dec_planar (the
// pallas_call at :259, kernel _ot2s_dec_kernel), each with the planarize
// and domain-fold passes around it: the kernels take the rows test-major,
// as those two functions do.
//
// What they compute, per test t:
//   encrypt (t < bp, one thread a test): comb = GF(2^128) Horner
//     combination of the test's S Q-rows q[t, s, :]; for every choice
//     c < 2^S, pad = ChaCha8(comb ^ o_c ^ (idx0 + t, TWEAK1, TWEAK2,
//     TWEAK3))[:W] with the offsets o_c (domain already folded into word
//     1) and ct[(c*W + w) * bp + t] = (x == c ? m_v1 : m_v0)[t, w] ^ pad[w],
//     x the test's S choice bytes as an integer.  A pad test t in [B, bp)
//     has zero rows, zero choice and zero payload, so its slots are the
//     bare pads (the planar wire's padding);
//   decrypt (t < B): comb of the test's T-rows with the domain folded into
//     row 0, word 1 (comb's coefficient there is 1, so into comb's word 1),
//     one pad, and pay[t, w] = ct[y, t, w] ^ pad[w] for the test's own
//     choice y, the table at any strides (the planar wire, or the mesh's
//     test-major [2^S, B, W]).
//
// Bound on the H100: encrypt by operations (2^S ChaCha8 blocks a test
// against 17S + 8W bytes read and 2^S * 4W written), decrypt by bytes (one
// block a test against 17S + 4W bytes read besides the opened slot, 4W
// written).  The planar table puts each (slot, word) of a test in its own
// plane, so a warp's 32 tests, opening slots by their own choices, touch a
// 32-byte sector of slot y's planes wherever one of 8 neighbouring tests
// chose y: decrypt's floor is those sectors, not the opened words alone.
//
// Design:
// - rows and payloads in 16-byte vector loads (a test's rows are
//   contiguous, so a warp's loads cover one contiguous span), choices as
//   bytes, decrypt's output as one or two 16-byte stores a test; encrypt's
//   planar stores are coalesced (neighbouring threads, neighbouring words).
// - encrypt hashes U pads side by side in one thread: U = 2^S = 4 at S = 2
//   (the whole table); at S = 4, 6 a rolled loop of two-pad steps, since a
//   fully unrolled S = 6 body would inline 64 ChaCha blocks (four-pad steps,
//   and rotations by 16 and 8 as byte permutes, ran no faster on an H100).
//   The 2^S offsets, computed on the host from s, ride the kernel's
//   parameters.  The TPU kernel put c on the grid only to keep its Mosaic
//   program small.
// - decrypt loads the choice first and issues slot y's W loads before the
//   Horner combination and the hash, which run while those loads are in
//   flight; the TPU kernel XOR-accumulated a one-hot select over all 2^S
//   slots because a VMEM block held one slot at a time.  At S = 2 a block
//   copying its whole [2^S * W, 256] slice of the table into shared memory
//   by one TMA 2-D copy read the same lines and ran slower at every shape.
//   The table's loads are plain LDG.E.CONSTANT, with no L2 prefetch size:
//   an H100 then fetches the 64-byte half of a line that a sector lies in,
//   not the whole line (scripts/ot2s_sector_probe.py), and an L2::128B hint
//   made a sparse gather slower.  At S >= 4 the opened sectors lie sparse,
//   and decrypt runs at the rate of a bare gather of the same words, above
//   its 32-byte and 64-byte floors (chip_smoke.py's ot2s timing line).
#include "chacha.cuh"

FHH_ERROR_STRING_FN

#define FHH_OT2S_THREADS 256

// The feed-forward words of the first 8 state words (constants, then key).
__device__ __forceinline__ constexpr uint32_t ot2s_feed(int w) {
    return w == 0 ? 0x61707865u : w == 1 ? 0x3320646Eu : w == 2 ? 0x79622D32u
         : w == 3 ? 0x6B206574u : w == 4 ? 0x243F6A88u : w == 5 ? 0x85A308D3u
         : w == 6 ? 0x13198A2Eu : 0x03707344u;
}

// pad[u][:W] = ChaCha8(row[u] ^ (idx, TWEAK1, TWEAK2, TWEAK3))[:W] for U
// independent rows, hashed side by side (fhh_ot_pad of chacha.cuh, U-wide).
template <int U, int W>
__device__ __forceinline__ void ot2s_pads(const uint32_t (&row)[U][4], uint32_t idx,
                                          uint32_t (&pad)[U][W]) {
    uint32_t x[U][16];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        x[u][0] = 0x61707865u; x[u][1] = 0x3320646Eu; x[u][2] = 0x79622D32u;
        x[u][3] = 0x6B206574u; x[u][4] = 0x243F6A88u; x[u][5] = 0x85A308D3u;
        x[u][6] = 0x13198A2Eu; x[u][7] = 0x03707344u; x[u][8] = 0xA4093822u;
        x[u][9] = 0x299F31D0u; x[u][10] = 0x082EFA98u; x[u][11] = 0xEC4E6C89u;
        x[u][12] = row[u][0] ^ idx;
        x[u][13] = row[u][1] ^ FHH_OT_TWEAK1;
        x[u][14] = row[u][2] ^ FHH_OT_TWEAK2;
        x[u][15] = row[u][3] ^ FHH_OT_TWEAK3;
    }
#pragma unroll
    for (int r = 0; r < FHH_CHACHA_ROUNDS / 2; ++r) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            FHH_QR(x[u][0], x[u][4], x[u][8], x[u][12])
            FHH_QR(x[u][1], x[u][5], x[u][9], x[u][13])
            FHH_QR(x[u][2], x[u][6], x[u][10], x[u][14])
            FHH_QR(x[u][3], x[u][7], x[u][11], x[u][15])
            FHH_QR(x[u][0], x[u][5], x[u][10], x[u][15])
            FHH_QR(x[u][1], x[u][6], x[u][11], x[u][12])
            FHH_QR(x[u][2], x[u][7], x[u][8], x[u][13])
            FHH_QR(x[u][3], x[u][4], x[u][9], x[u][14])
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int w = 0; w < W; ++w) pad[u][w] = x[u][w] + ot2s_feed(w);
}

// Horner over a test's S rows (rows[s] at rows + s): acc = rows[S-1];
// acc = 2*acc ^ rows[j] for j = S-2 .. 0.
template <int S>
__device__ __forceinline__ void ot2s_comb(const uint4* __restrict__ rows, uint32_t acc[4]) {
    uint4 r[S];
#pragma unroll
    for (int s = 0; s < S; ++s) r[s] = rows[s];
    acc[0] = r[S - 1].x; acc[1] = r[S - 1].y; acc[2] = r[S - 1].z; acc[3] = r[S - 1].w;
#pragma unroll
    for (int j = S - 2; j >= 0; --j) {
        const uint32_t hi = acc[3] >> 31;
        acc[3] = ((acc[3] << 1) | (acc[2] >> 31)) ^ r[j].w;
        acc[2] = ((acc[2] << 1) | (acc[1] >> 31)) ^ r[j].z;
        acc[1] = ((acc[1] << 1) | (acc[0] >> 31)) ^ r[j].y;
        acc[0] = ((acc[0] << 1) ^ (hi * 0x87u)) ^ r[j].x;
    }
}

template <int S>
__device__ __forceinline__ uint32_t ot2s_choice(const uint8_t* __restrict__ bits) {
    uint32_t v = 0u;
#pragma unroll
    for (int j = 0; j < S; ++j) v |= ((uint32_t)bits[j] & 1u) << j;
    return v;
}

// The 2^S offsets o_c (word k at w[4c + k], the domain folded into word 1),
// computed on the host and passed by value: a warp reads slot c's words
// together, one constant-bank broadcast.
struct ot2s_offs {
    uint32_t w[64 * 4];
};

template <int S, int W, int U>
__global__ void __launch_bounds__(FHH_OT2S_THREADS)
fhh_ot2s_enc_kernel(const uint4* __restrict__ q,        // [B, S] rows
                    const uint8_t* __restrict__ x,      // [B, S] choice bytes
                    const uint4* __restrict__ mv0,      // [B, W / 4]
                    const uint4* __restrict__ mv1,      // [B, W / 4]
                    const __grid_constant__ ot2s_offs offs,
                    uint32_t* __restrict__ cts,         // [2^S * W, bp]
                    long long B, long long bp, uint32_t idx0) {
    constexpr int C = 1 << S;
    static_assert(C % U == 0, "U divides 2^S");
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= bp) return;
    uint32_t comb[4] = {0u, 0u, 0u, 0u}, xi = 0u, m0[W], m1[W];
#pragma unroll
    for (int w = 0; w < W; ++w) m0[w] = m1[w] = 0u;
    if (t < B) {  // a pad test keeps its zero rows, choice and payload
        ot2s_comb<S>(q + t * S, comb);
        xi = ot2s_choice<S>(x + t * S);
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
            const uint4 a = mv0[t * (W / 4) + k], b = mv1[t * (W / 4) + k];
            m0[4 * k] = a.x; m0[4 * k + 1] = a.y; m0[4 * k + 2] = a.z; m0[4 * k + 3] = a.w;
            m1[4 * k] = b.x; m1[4 * k + 1] = b.y; m1[4 * k + 2] = b.z; m1[4 * k + 3] = b.w;
        }
    }
    const uint32_t idx = idx0 + (uint32_t)t;
    uint32_t* out = cts + t;
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += U) {
        uint32_t row[U][4], pad[U][W];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int w = 0; w < 4; ++w) row[u][w] = comb[w] ^ offs.w[4 * (c0 + u) + w];
        ot2s_pads<U, W>(row, idx, pad);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const uint32_t eq = 0u - (uint32_t)(xi == (uint32_t)(c0 + u));
#pragma unroll
            for (int w = 0; w < W; ++w)
                out[(size_t)((c0 + u) * W + w) * (size_t)bp] =
                    (m0[w] ^ (eq & (m0[w] ^ m1[w]))) ^ pad[u][w];
        }
    }
}

// The receiver's pad of test t: comb of its T rows, the domain folded into
// word 1, hashed under index idx0 + t.
template <int S, int W>
__device__ __forceinline__ void ot2s_open_pad(const uint4* __restrict__ rows, uint32_t idx,
                                              uint32_t dom, uint32_t pad[W]) {
    uint32_t comb[4];
    ot2s_comb<S>(rows, comb);
    comb[1] ^= dom;
    fhh_ot_pad<W>(comb, idx, pad);
}

template <int W>
__device__ __forceinline__ void ot2s_store(uint4* __restrict__ pay, long long t,
                                           const uint32_t ct[W], const uint32_t pad[W]) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
        pay[t * (W / 4) + k] = make_uint4(ct[4 * k] ^ pad[4 * k], ct[4 * k + 1] ^ pad[4 * k + 1],
                                          ct[4 * k + 2] ^ pad[4 * k + 2],
                                          ct[4 * k + 3] ^ pad[4 * k + 3]);
}

// Slot c, test t, word w of the table at cts[c * sc + t * st + w * sw].
template <int S, int W>
__global__ void __launch_bounds__(FHH_OT2S_THREADS)
fhh_ot2s_dec_kernel(const uint4* __restrict__ trows,   // [B, S] rows
                    const uint8_t* __restrict__ y,     // [B, S] choice bytes
                    const uint32_t* __restrict__ cts,  // the table
                    long long sc, long long st, long long sw,
                    uint4* __restrict__ pay,           // [B, W / 4]
                    long long B, uint32_t idx0, uint32_t dom) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    const uint32_t yi = ot2s_choice<S>(y + t * S);
    const uint32_t* slot = cts + (long long)yi * sc + t * st;
    uint32_t ct[W];
#pragma unroll
    for (int w = 0; w < W; ++w) ct[w] = slot[w * sw];
    uint32_t pad[W];
    ot2s_open_pad<S, W>(trows + t * S, idx0 + (uint32_t)t, dom, pad);
    ot2s_store<W>(pay, t, ct, pad);
}

// Four pads side by side at S = 2 (the whole table), two a step above.
template <int S, int W>
static int launch_enc(const void* q, const void* x, const void* mv0, const void* mv1,
                      const ot2s_offs& offs, void* cts, long long B, long long bp, uint32_t idx0,
                      cudaStream_t st) {
    const long long blocks = (bp + FHH_OT2S_THREADS - 1) / FHH_OT2S_THREADS;
    fhh_ot2s_enc_kernel<S, W, S == 2 ? 4 : 2><<<(unsigned)blocks, FHH_OT2S_THREADS, 0, st>>>(
        (const uint4*)q, (const uint8_t*)x, (const uint4*)mv0, (const uint4*)mv1, offs,
        (uint32_t*)cts, B, bp, idx0);
    return (int)cudaGetLastError();
}

template <int S, int W>
static int launch_dec(const void* t, const void* y, const void* cts, long long sc,
                      long long st_, long long sw, void* pay, long long B, uint32_t idx0,
                      uint32_t dom, cudaStream_t st) {
    const long long blocks = (B + FHH_OT2S_THREADS - 1) / FHH_OT2S_THREADS;
    fhh_ot2s_dec_kernel<S, W><<<(unsigned)blocks, FHH_OT2S_THREADS, 0, st>>>(
        (const uint4*)t, (const uint8_t*)y, (const uint32_t*)cts, sc, st_, sw, (uint4*)pay, B,
        idx0, dom);
    return (int)cudaGetLastError();
}

#define FHH_OT2S_CASES(X)                                                        \
    X(2, 4) X(2, 8) X(4, 4) X(4, 8) X(6, 4) X(6, 8)

// o_c = XOR over the bits j of c of x^j * s in GF(2^128) (x^128 + x^7 + x^2
// + x + 1; ops/otext.py:gf128_offsets), the domain XORed into word 1.
static void ot2s_offsets(const uint32_t s[4], int S, uint32_t dom, ot2s_offs& o) {
    uint32_t p[4] = {s[0], s[1], s[2], s[3]};
    for (int i = 0; i < (4 << S); ++i) o.w[i] = (i & 3) == 1 ? dom : 0u;
    for (int j = 0; j < S; ++j) {
        for (int c = 0; c < (1 << S); ++c)
            if ((c >> j) & 1)
                for (int k = 0; k < 4; ++k) o.w[4 * c + k] ^= p[k];
        const uint32_t top = p[3] >> 31;
        p[3] = (p[3] << 1) | (p[2] >> 31);
        p[2] = (p[2] << 1) | (p[1] >> 31);
        p[1] = (p[1] << 1) | (p[0] >> 31);
        p[0] = (p[0] << 1) ^ (top * 0x87u);
    }
}

// Returns a CUDA error code, or -1 for an (S, W) that is not compiled.
// sblk: the sender's s_block (4 words), dom: the pad domain.
extern "C" int fhh_ot2s_enc_launch(const void* q, const void* x, const void* mv0,
                                   const void* mv1, const unsigned* sblk, unsigned dom, void* cts,
                                   long long B, long long bp, int S, int W, unsigned idx0,
                                   void* stream) {
    if (bp == 0) return 0;
    if (S < 1 || S > 6) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    ot2s_offs offs;
    ot2s_offsets(sblk, S, dom, offs);
#define X(s, w) \
    if (S == s && W == w) return launch_enc<s, w>(q, x, mv0, mv1, offs, cts, B, bp, idx0, st);
    FHH_OT2S_CASES(X)
#undef X
    return -1;
}

// The table's slot, test and word strides (sc, st_, sw) in words.
extern "C" int fhh_ot2s_dec_launch(const void* t, const void* y, const void* cts, long long sc,
                                   long long st_, long long sw, void* pay, long long B, int S,
                                   int W, unsigned idx0, unsigned dom, void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define X(s, w)                                                                           \
    if (S == s && W == w)                                                                 \
        return launch_dec<s, w>(t, y, cts, sc, st_, sw, pay, B, idx0, dom, st);
    FHH_OT2S_CASES(X)
#undef X
    return -1;
}

