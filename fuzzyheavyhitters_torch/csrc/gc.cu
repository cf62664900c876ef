// Half-gates garbled S-bit equality with b2a payloads: garble and evaluate.
//
// Replaces: fuzzyheavyhitters_tpu/ops/gc_pallas.py:_garble_call (the
// pallas_call at :279, kernel _garble_kernel) and :_eval_call (the
// pallas_call at :336, kernel _eval_kernel).
//
// What they compute, per test t of bp (arrays plane-major [planes, bp]
// int32 words, plane p of test t at p * bp + t):
//   garble: Z0_s = X0_s ^ Y0_s ^ R (free XNOR); an AND tree of S-1
//     half-gates, pairing wires (0,1), (2,3), ... and carrying the gate
//     outputs, then any leftover wire, to the next layer; gate g hashes
//     A0, A0^R (half 0) and B0, B0^R (half 1) as ChaCha8(label ^ (g, half,
//     TWEAK2, TWEAK3))[:4] and writes T_G, T_E to planes (g*2 + {0,1})*4 + w;
//     decode = lsb(out0) ^ mask; the garbler's labels X0_s ^ x_s*R; the
//     payload ciphertexts m_v ^ OT-pad(out0 [^ R], idx0 + t), slot order
//     by lsb(out0);
//   eval: the same tree on active labels with 2 hashes per gate; e =
//     lsb(out) ^ decode; payload = cts[lsb(out)] ^ OT-pad(out, idx0 + t).
//
// Design: one thread per test, templated on S (even, 2..16) and W (4, 8),
// the tree unrolled at compile time (GcLayer), so the 4S label words stay
// in registers (64 at S = 16; ptxas -v reports registers and spills).  The
// garbler's randomness (X0, mask) is drawn outside, from the same stream
// draw as the plain version (ops/gc.py:_carve_label_words), as on the TPU.
// Every plane access is t-fastest, so loads and stores are coalesced.
//
// Bound on the H100: operations.  Garbling hashes 4(S-1) + 2 ChaCha8
// blocks per test against ~(32S + 4S + 8W + 8) bytes in and (32(S-1) +
// 16S + 4 + 8W) out; evaluation 2(S-1) + 1 blocks.
#include "chacha.cuh"

FHH_ERROR_STRING_FN

#define FHH_GC_TWEAK2 0x9E3779B9u
#define FHH_GC_TWEAK3 0x7F4A7C15u

__device__ __forceinline__ void fhh_gate_hash(const uint32_t l[4], uint32_t gid, uint32_t half,
                                              uint32_t h[4]) {
    const uint32_t in[4] = {l[0] ^ gid, l[1] ^ half, l[2] ^ FHH_GC_TWEAK2,
                            l[3] ^ FHH_GC_TWEAK3};
    uint32_t out[16];
    fhh_chacha(in, out);
#pragma unroll
    for (int w = 0; w < 4; ++w) h[w] = out[w];
}

// One layer of N wires held in w[0..N): gates GATE .. GATE + N/2 - 1 write
// their outputs to w[0..N/2), a leftover wire moves to w[N/2].
template <int N, int GATE, int S>
struct GcLayer {
    __device__ __forceinline__ static void garble(uint32_t (&w)[S][4], const uint32_t R[4],
                                                  uint32_t* __restrict__ tab, size_t t,
                                                  size_t bp) {
        constexpr int K = N / 2;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const uint32_t gid = GATE + i;
            uint32_t a[4], b[4], ar[4], br[4], ha0[4], ha1[4], hb0[4], hb1[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                a[k] = w[2 * i][k]; b[k] = w[2 * i + 1][k];
                ar[k] = a[k] ^ R[k]; br[k] = b[k] ^ R[k];
            }
            fhh_gate_hash(a, gid, 0u, ha0);
            fhh_gate_hash(ar, gid, 0u, ha1);
            fhh_gate_hash(b, gid, 1u, hb0);
            fhh_gate_hash(br, gid, 1u, hb1);
            const uint32_t pam = 0u - (a[0] & 1u), pbm = 0u - (b[0] & 1u);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t tg = ha0[k] ^ ha1[k] ^ (pbm & R[k]);
                const uint32_t wg = ha0[k] ^ (pam & tg);
                const uint32_t te = hb0[k] ^ hb1[k] ^ a[k];
                const uint32_t we = hb0[k] ^ (pbm & (te ^ a[k]));
                tab[(size_t)(((GATE + i) * 2 + 0) * 4 + k) * bp + t] = tg;
                tab[(size_t)(((GATE + i) * 2 + 1) * 4 + k) * bp + t] = te;
                w[i][k] = wg ^ we;
            }
        }
        if (N % 2) {
#pragma unroll
            for (int k = 0; k < 4; ++k) w[K][k] = w[N - 1][k];
        }
        GcLayer<K + N % 2, GATE + K, S>::garble(w, R, tab, t, bp);
    }

    __device__ __forceinline__ static void eval(uint32_t (&w)[S][4],
                                                const uint32_t* __restrict__ tab, size_t t,
                                                size_t bp) {
        constexpr int K = N / 2;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const uint32_t gid = GATE + i;
            uint32_t a[4], b[4], ha[4], hb[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) { a[k] = w[2 * i][k]; b[k] = w[2 * i + 1][k]; }
            fhh_gate_hash(a, gid, 0u, ha);
            fhh_gate_hash(b, gid, 1u, hb);
            const uint32_t am = 0u - (a[0] & 1u), bm = 0u - (b[0] & 1u);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t tg = tab[(size_t)(((GATE + i) * 2 + 0) * 4 + k) * bp + t];
                const uint32_t te = tab[(size_t)(((GATE + i) * 2 + 1) * 4 + k) * bp + t];
                w[i][k] = (ha[k] ^ (am & tg)) ^ (hb[k] ^ (bm & (te ^ a[k])));
            }
        }
        if (N % 2) {
#pragma unroll
            for (int k = 0; k < 4; ++k) w[K][k] = w[N - 1][k];
        }
        GcLayer<K + N % 2, GATE + K, S>::eval(w, tab, t, bp);
    }
};

template <int GATE, int S>
struct GcLayer<1, GATE, S> {
    __device__ __forceinline__ static void garble(uint32_t (&)[S][4], const uint32_t*,
                                                  uint32_t*, size_t, size_t) {}
    __device__ __forceinline__ static void eval(uint32_t (&)[S][4], const uint32_t*, size_t,
                                                size_t) {}
};

template <int S, int W>
__global__ void __launch_bounds__(256)
fhh_gc_garble_kernel(const uint32_t* __restrict__ x0,    // [4S, bp]
                     const uint32_t* __restrict__ y0,    // [4S, bp]
                     const uint32_t* __restrict__ xb,    // [S, bp] 0/1
                     const uint32_t* __restrict__ mask,  // [1, bp] 0/1
                     const uint32_t* __restrict__ mv0,   // [W, bp]
                     const uint32_t* __restrict__ mv1,   // [W, bp]
                     uint32_t* __restrict__ tab,         // [8(S-1), bp]
                     uint32_t* __restrict__ gbl,         // [4S, bp]
                     uint32_t* __restrict__ dec,         // [1, bp]
                     uint32_t* __restrict__ cts,         // [2W, bp]
                     long long bp_, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                     uint32_t idx0) {
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= bp_) return;
    const size_t t = (size_t)tt, bp = (size_t)bp_;
    const uint32_t R[4] = {r0, r1, r2, r3};
    uint32_t w[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const uint32_t xm = 0u - (xb[(size_t)s * bp + t] & 1u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const size_t p = (size_t)(s * 4 + k) * bp + t;
            const uint32_t xl = x0[p];
            w[s][k] = xl ^ y0[p] ^ R[k];
            gbl[p] = xl ^ (xm & R[k]);
        }
    }
    GcLayer<S, 0, S>::garble(w, R, tab, t, bp);
    const uint32_t p = w[0][0] & 1u;
    dec[t] = p ^ (mask[t] & 1u);
    const uint32_t idx = idx0 + (uint32_t)t;
    const uint32_t o1[4] = {w[0][0] ^ R[0], w[0][1] ^ R[1], w[0][2] ^ R[2], w[0][3] ^ R[3]};
    uint32_t pad0[W], pad1[W];
    fhh_ot_pad<W>(w[0], idx, pad0);
    fhh_ot_pad<W>(o1, idx, pad1);
    const uint32_t pm = 0u - p;
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const uint32_t c0 = mv0[(size_t)k * bp + t] ^ pad0[k];
        const uint32_t c1 = mv1[(size_t)k * bp + t] ^ pad1[k];
        const uint32_t sw = pm & (c0 ^ c1);
        cts[(size_t)k * bp + t] = c0 ^ sw;            // p ? c1 : c0
        cts[(size_t)(W + k) * bp + t] = c1 ^ sw;      // p ? c0 : c1
    }
}

template <int S, int W>
__global__ void __launch_bounds__(256)
fhh_gc_eval_kernel(const uint32_t* __restrict__ gbl,  // [4S, bp]
                   const uint32_t* __restrict__ evl,  // [4S, bp]
                   const uint32_t* __restrict__ tab,  // [8(S-1), bp]
                   const uint32_t* __restrict__ dec,  // [1, bp]
                   const uint32_t* __restrict__ cts,  // [2W, bp]
                   uint32_t* __restrict__ e,          // [1, bp]
                   uint32_t* __restrict__ pay,        // [W, bp]
                   long long bp_, uint32_t idx0) {
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= bp_) return;
    const size_t t = (size_t)tt, bp = (size_t)bp_;
    uint32_t w[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const size_t p = (size_t)(s * 4 + k) * bp + t;
            w[s][k] = gbl[p] ^ evl[p];
        }
    }
    GcLayer<S, 0, S>::eval(w, tab, t, bp);
    const uint32_t sb = w[0][0] & 1u;
    e[t] = sb ^ (dec[t] & 1u);
    uint32_t pad[W];
    fhh_ot_pad<W>(w[0], idx0 + (uint32_t)t, pad);
    const size_t slot = sb ? (size_t)W : 0;
#pragma unroll
    for (int k = 0; k < W; ++k) pay[(size_t)k * bp + t] = cts[(slot + k) * bp + t] ^ pad[k];
}

#define FHH_GC_CASES(X)                                                          \
    X(2, 4) X(2, 8) X(4, 4) X(4, 8) X(6, 4) X(6, 8) X(8, 4) X(8, 8)              \
    X(10, 4) X(10, 8) X(12, 4) X(12, 8) X(14, 4) X(14, 8) X(16, 4) X(16, 8)

// Returns a CUDA error code, or -1 for an (S, W) that is not compiled.
extern "C" int fhh_gc_garble_launch(const void* x0, const void* y0, const void* xb,
                                    const void* mask, const void* mv0, const void* mv1,
                                    void* tab, void* gbl, void* dec, void* cts, long long bp,
                                    int S, int W, unsigned r0, unsigned r1, unsigned r2,
                                    unsigned r3, unsigned idx0, void* stream) {
    if (bp == 0) return 0;
    const unsigned blocks = (unsigned)((bp + 255) / 256);
    cudaStream_t st = (cudaStream_t)stream;
#define X(s, w)                                                                        \
    if (S == s && W == w) {                                                            \
        fhh_gc_garble_kernel<s, w><<<blocks, 256, 0, st>>>(                            \
            (const uint32_t*)x0, (const uint32_t*)y0, (const uint32_t*)xb,             \
            (const uint32_t*)mask, (const uint32_t*)mv0, (const uint32_t*)mv1,         \
            (uint32_t*)tab, (uint32_t*)gbl, (uint32_t*)dec, (uint32_t*)cts, bp,        \
            r0, r1, r2, r3, idx0);                                                     \
        return (int)cudaGetLastError();                                                \
    }
    FHH_GC_CASES(X)
#undef X
    return -1;
}

extern "C" int fhh_gc_eval_launch(const void* gbl, const void* evl, const void* tab,
                                  const void* dec, const void* cts, void* e, void* pay,
                                  long long bp, int S, int W, unsigned idx0, void* stream) {
    if (bp == 0) return 0;
    const unsigned blocks = (unsigned)((bp + 255) / 256);
    cudaStream_t st = (cudaStream_t)stream;
#define X(s, w)                                                                        \
    if (S == s && W == w) {                                                            \
        fhh_gc_eval_kernel<s, w><<<blocks, 256, 0, st>>>(                              \
            (const uint32_t*)gbl, (const uint32_t*)evl, (const uint32_t*)tab,          \
            (const uint32_t*)dec, (const uint32_t*)cts, (uint32_t*)e, (uint32_t*)pay,  \
            bp, idx0);                                                                 \
        return (int)cudaGetLastError();                                                \
    }
    FHH_GC_CASES(X)
#undef X
    return -1;
}
