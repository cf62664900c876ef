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
// Bound on the H100: operations.  Garbling hashes 4(S-1) + 2 ChaCha8
// blocks per test against ~(32S + 4S + 8W + 8) bytes in and (32(S-1) +
// 16S + 4 + 8W) out; evaluation 2(S-1) + 1 blocks.
//
// Design: one thread per test, FHH_GC_THREADS a block, S a kernel argument
// (2..16) and W (4, 8) a template parameter, so the compiled body does not
// grow with S.  A tree unrolled at compile time inlines 4(S-1) + 2 ChaCha8
// blocks per instantiation (62 for garble at S = 16, 23,880 SASS
// instructions), and its time over bound grows with that count (3.8x at
// S = 16 on an H100 80GB HBM3 at 700 W, with no spills and at most 128
// registers): the body outgrows the SM's instruction caches.  So:
// - the gate loop is rolled (#pragma unroll 1): garble holds six ChaCha8
//   bodies (a gate's four, the two OT pads), eval three, whatever S is;
// - the tree's schedule is built on the host (ops/gc_cuda.py:gate_schedule)
//   and read from shared memory, one word a gate: inputs a and b, each a
//   leaf wire or an earlier gate's output slot, and the output slot o;
// - a leaf's label words (and, for garble, its x bit; for eval, its table
//   rows too) are fetched one gate ahead, so that each gate's global loads
//   are in flight while the gate before it hashes.  Loading every label
//   into shared memory first left the warps of a block loading in step and
//   then hashing in step, and eval's bytes come near its operations' time
//   (1.32 against 1.40 ms at S = 4, bp = 2^24 on the H100): eval ran
//   slower that way at every shape measured (PERF.md);
// - gate outputs live in dynamic shared memory, S/2 slots laid out
//   [slot][word][thread], thread-fastest, so a warp's accesses hit the 32
//   banks once: 16 KB a block at S = 16;
// - garble's four hashes of a gate are written side by side in one thread
//   (the label and label ^ R of each half).  Against two states a step
//   (half a gate), the form measured faster at every shape (PERF.md), with
//   64 registers to 80-95 and no spills either way; ptxas keeps part of
//   the four states in flight, not all 64 words.  A quad of threads
//   splitting a gate with __shfl_sync would add shuffles to the same hash
//   work;
// - each kernel asks for the largest shared-memory carveout, so that its
//   registers, not the carveout, bound the resident blocks;
// - every global plane access stays thread-fastest, so loads and stores
//   are coalesced; the garbler's randomness (X0, mask) is drawn outside,
//   from the same stream draw as the plain version
//   (ops/gc.py:_carve_label_words), as on the TPU.
#include "chacha.cuh"

FHH_ERROR_STRING_FN

#define FHH_GC_TWEAK2 0x9E3779B9u
#define FHH_GC_TWEAK3 0x7F4A7C15u
#define FHH_GC_THREADS 128
#define FHH_GC_MAX_S 16
#define FHH_GC_LEAF_A (1u << 24)  // schedule word: input a is a leaf wire
#define FHH_GC_LEAF_B (1u << 25)  // schedule word: input b is a leaf wire

// h[0..N) = ChaCha8(l ^ tw)[0..N)
template <int N>
__device__ __forceinline__ void fhh_gc_hash(const uint32_t l[4], const uint32_t tw[4],
                                            uint32_t h[N]) {
    const uint32_t in[4] = {l[0] ^ tw[0], l[1] ^ tw[1], l[2] ^ tw[2], l[3] ^ tw[3]};
    uint32_t out[16];
    fhh_chacha(in, out);
#pragma unroll
    for (int w = 0; w < N; ++w) h[w] = out[w];
}

// The schedule into shared memory: gate g's word is a | b << 8 | o << 16,
// with the leaf flags of a and b.
__device__ __forceinline__ void fhh_gc_load_schedule(const uint32_t* __restrict__ sched, int S,
                                                     uint32_t* gates) {
    if ((int)threadIdx.x < S - 1) gates[threadIdx.x] = sched[threadIdx.x];
    __syncthreads();
}

// Word k of output slot o of this thread: [slot][word][thread] in dynamic
// shared memory, thread-fastest.
#define FHH_GC_SLOT(lab, o, k) (lab)[((o) * 4 + (k)) * FHH_GC_THREADS]

// Gate gs's leaf words, fetched a gate ahead of their use: planes 4a..4a+3
// of p and q into r[0..4) and u[0..4), b's into r[4..8) and u[4..8), and
// the leaves' bit planes of c (if given) into v[0], v[1].
__device__ __forceinline__ void fhh_gc_fetch_leaves(uint32_t gs, const uint32_t* __restrict__ p,
                                                    const uint32_t* __restrict__ q,
                                                    const uint32_t* __restrict__ c, size_t t,
                                                    size_t bp, uint32_t (&r)[8],
                                                    uint32_t (&u)[8], uint32_t (&v)[2]) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
        if (gs & (side ? FHH_GC_LEAF_B : FHH_GC_LEAF_A)) {
            const size_t w = (gs >> (8 * side)) & 0xFFu;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                r[4 * side + k] = p[(w * 4 + k) * bp + t];
                u[4 * side + k] = q[(w * 4 + k) * bp + t];
            }
            if (c != nullptr) v[side] = c[w * bp + t];
        }
    }
}

template <int W>
__global__ void __launch_bounds__(FHH_GC_THREADS)
fhh_gc_garble_kernel(const uint32_t* __restrict__ x0,     // [4S, bp]
                     const uint32_t* __restrict__ y0,     // [4S, bp]
                     const uint32_t* __restrict__ xb,     // [S, bp] 0/1
                     const uint32_t* __restrict__ mask,   // [1, bp] 0/1
                     const uint32_t* __restrict__ mv0,    // [W, bp]
                     const uint32_t* __restrict__ mv1,    // [W, bp]
                     const uint32_t* __restrict__ sched,  // [S-1]
                     uint32_t* __restrict__ tab,          // [8(S-1), bp]
                     uint32_t* __restrict__ gbl,          // [4S, bp]
                     uint32_t* __restrict__ dec,          // [1, bp]
                     uint32_t* __restrict__ cts,          // [2W, bp]
                     long long bp_, int S, uint32_t r0, uint32_t r1, uint32_t r2,
                     uint32_t r3, uint32_t idx0) {
    extern __shared__ uint32_t fhh_gc_labels[];  // [S/2][4][FHH_GC_THREADS]
    __shared__ uint32_t gates[FHH_GC_MAX_S - 1];
    fhh_gc_load_schedule(sched, S, gates);
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= bp_) return;
    const size_t t = (size_t)tt, bp = (size_t)bp_;
    const uint32_t R[4] = {r0, r1, r2, r3};
    uint32_t* outs = fhh_gc_labels + threadIdx.x;
    uint32_t lx[8], ly[8], lb[2];  // the next gate's leaves: X0, Y0 and x bits
    fhh_gc_fetch_leaves(gates[0], x0, y0, xb, t, bp, lx, ly, lb);
    const uint32_t m = mask[t];
    uint32_t out[4];
#pragma unroll 1
    for (int g = 0; g < S - 1; ++g) {
        const uint32_t gs = gates[g];
        uint32_t A[4], B[4];  // Z0 = X0 ^ Y0 ^ R of a leaf (its garbler label goes out), or a slot
#pragma unroll
        for (int side = 0; side < 2; ++side) {
            uint32_t* in = side ? B : A;
            const uint32_t w = (gs >> (8 * side)) & 0xFFu;
            if (gs & (side ? FHH_GC_LEAF_B : FHH_GC_LEAF_A)) {
                const uint32_t xm = 0u - (lb[side] & 1u);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const uint32_t xl = lx[4 * side + k];
                    in[k] = xl ^ ly[4 * side + k] ^ R[k];
                    gbl[((size_t)w * 4 + k) * bp + t] = xl ^ (xm & R[k]);
                }
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) in[k] = FHH_GC_SLOT(outs, w, k);
            }
        }
        if (g + 2 < S)  // the next gate's leaves, in flight while this one hashes
            fhh_gc_fetch_leaves(gates[g + 1], x0, y0, xb, t, bp, lx, ly, lb);
        uint32_t ar[4], br[4], ha0[4], ha1[4], hb0[4], hb1[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) { ar[k] = A[k] ^ R[k]; br[k] = B[k] ^ R[k]; }
        const uint32_t tw0[4] = {(uint32_t)g, 0u, FHH_GC_TWEAK2, FHH_GC_TWEAK3};
        const uint32_t tw1[4] = {(uint32_t)g, 1u, FHH_GC_TWEAK2, FHH_GC_TWEAK3};
        fhh_gc_hash<4>(A, tw0, ha0);
        fhh_gc_hash<4>(ar, tw0, ha1);
        fhh_gc_hash<4>(B, tw1, hb0);
        fhh_gc_hash<4>(br, tw1, hb1);
        const uint32_t pam = 0u - (A[0] & 1u), pbm = 0u - (B[0] & 1u);
        const uint32_t o = (gs >> 16) & 0xFFu;
        uint32_t* row = tab + (size_t)g * 8 * bp + t;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t tg = ha0[k] ^ ha1[k] ^ (pbm & R[k]);
            const uint32_t te = hb0[k] ^ hb1[k] ^ A[k];
            row[(size_t)k * bp] = tg;
            row[(size_t)(4 + k) * bp] = te;
            out[k] = (ha0[k] ^ (pam & tg)) ^ (hb0[k] ^ (pbm & (te ^ A[k])));
            FHH_GC_SLOT(outs, o, k) = out[k];
        }
    }
    const uint32_t o1[4] = {out[0] ^ R[0], out[1] ^ R[1], out[2] ^ R[2], out[3] ^ R[3]};
    const uint32_t p = out[0] & 1u, pm = 0u - p;
    dec[t] = p ^ (m & 1u);
    const uint32_t idx = idx0 + (uint32_t)t;
    uint32_t c0[W], c1[W], pad0[W], pad1[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {  // in flight over the pads
        c0[k] = mv0[(size_t)k * bp + t];
        c1[k] = mv1[(size_t)k * bp + t];
    }
    fhh_ot_pad<W>(out, idx, pad0);
    fhh_ot_pad<W>(o1, idx, pad1);
#pragma unroll
    for (int k = 0; k < W; ++k) {
        c0[k] ^= pad0[k];
        c1[k] ^= pad1[k];
        const uint32_t sw = pm & (c0[k] ^ c1[k]);
        cts[(size_t)k * bp + t] = c0[k] ^ sw;        // p ? c1 : c0
        cts[(size_t)(W + k) * bp + t] = c1[k] ^ sw;  // p ? c0 : c1
    }
}

template <int W>
__global__ void __launch_bounds__(FHH_GC_THREADS)
fhh_gc_eval_kernel(const uint32_t* __restrict__ gbl,    // [4S, bp]
                   const uint32_t* __restrict__ evl,    // [4S, bp]
                   const uint32_t* __restrict__ tab,    // [8(S-1), bp]
                   const uint32_t* __restrict__ dec,    // [1, bp]
                   const uint32_t* __restrict__ cts,    // [2W, bp]
                   const uint32_t* __restrict__ sched,  // [S-1]
                   uint32_t* __restrict__ e,            // [1, bp]
                   uint32_t* __restrict__ pay,          // [W, bp]
                   long long bp_, int S, uint32_t idx0) {
    extern __shared__ uint32_t fhh_gc_labels[];  // [S/2][4][FHH_GC_THREADS]
    __shared__ uint32_t gates[FHH_GC_MAX_S - 1];
    fhh_gc_load_schedule(sched, S, gates);
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= bp_) return;
    const size_t t = (size_t)tt, bp = (size_t)bp_;
    uint32_t* lab = fhh_gc_labels + threadIdx.x;
    uint32_t lg[8], le[8], tb[8], nobits[2];  // the next gate's leaves and table rows
    fhh_gc_fetch_leaves(gates[0], gbl, evl, nullptr, t, bp, lg, le, nobits);
#pragma unroll
    for (int k = 0; k < 8; ++k) tb[k] = tab[(size_t)k * bp + t];
    const uint32_t d = dec[t];
    uint32_t out[4];
#pragma unroll 1
    for (int g = 0; g < S - 1; ++g) {
        const uint32_t gs = gates[g];
        uint32_t ab[2][4], tg[4], te[4];
#pragma unroll
        for (int side = 0; side < 2; ++side) {
            const uint32_t w = (gs >> (8 * side)) & 0xFFu;
            if (gs & (side ? FHH_GC_LEAF_B : FHH_GC_LEAF_A)) {
#pragma unroll
                for (int k = 0; k < 4; ++k) ab[side][k] = lg[4 * side + k] ^ le[4 * side + k];
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) ab[side][k] = FHH_GC_SLOT(lab, w, k);
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) { tg[k] = tb[k]; te[k] = tb[4 + k]; }
        if (g + 2 < S) {  // the next gate's global words, while this one hashes
            fhh_gc_fetch_leaves(gates[g + 1], gbl, evl, nullptr, t, bp, lg, le, nobits);
            const uint32_t* row = tab + (size_t)(g + 1) * 8 * bp + t;
#pragma unroll
            for (int k = 0; k < 8; ++k) tb[k] = row[(size_t)k * bp];
        }
        const uint32_t tw0[4] = {(uint32_t)g, 0u, FHH_GC_TWEAK2, FHH_GC_TWEAK3};
        const uint32_t tw1[4] = {(uint32_t)g, 1u, FHH_GC_TWEAK2, FHH_GC_TWEAK3};
        uint32_t ha[4], hb[4];
        fhh_gc_hash<4>(ab[0], tw0, ha);
        fhh_gc_hash<4>(ab[1], tw1, hb);
        const uint32_t am = 0u - (ab[0][0] & 1u), bm = 0u - (ab[1][0] & 1u);
        const uint32_t o = (gs >> 16) & 0xFFu;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            out[k] = (ha[k] ^ (am & tg[k])) ^ (hb[k] ^ (bm & (te[k] ^ ab[0][k])));
            FHH_GC_SLOT(lab, o, k) = out[k];
        }
    }
    const uint32_t sb = out[0] & 1u;
    e[t] = sb ^ (d & 1u);
    const size_t slot = sb ? (size_t)W : 0;
    uint32_t ct[W], pad[W];
#pragma unroll
    for (int k = 0; k < W; ++k) ct[k] = cts[(slot + k) * bp + t];  // in flight over the pad
    fhh_ot_pad<W>(out, idx0 + (uint32_t)t, pad);
#pragma unroll
    for (int k = 0; k < W; ++k) pay[(size_t)k * bp + t] = ct[k] ^ pad[k];
}

static bool fhh_gc_takes(int S, int W) {
    return S >= 2 && S <= FHH_GC_MAX_S && (W == 4 || W == 8);
}

static unsigned fhh_gc_blocks(long long bp) {
    return (unsigned)((bp + FHH_GC_THREADS - 1) / FHH_GC_THREADS);
}

// S / 2 output slots of 4 words a thread
static size_t fhh_gc_smem(int S) {
    return (size_t)(S / 2) * 4 * FHH_GC_THREADS * sizeof(uint32_t);
}

// Each kernel asks for the largest shared-memory carveout once, so that as
// many blocks as its registers allow are resident (the default carveout
// held eval at S = 4 to fewer).
template <class K>
static void fhh_gc_prefer_shared(K kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
}

template <int W>
static int fhh_gc_garble_go(const void* x0, const void* y0, const void* xb, const void* mask,
                            const void* mv0, const void* mv1, const void* sched, void* tab,
                            void* gbl, void* dec, void* cts, long long bp, int S, unsigned r0,
                            unsigned r1, unsigned r2, unsigned r3, unsigned idx0,
                            cudaStream_t st) {
    static const bool preferred = (fhh_gc_prefer_shared(fhh_gc_garble_kernel<W>), true);
    (void)preferred;
    fhh_gc_garble_kernel<W><<<fhh_gc_blocks(bp), FHH_GC_THREADS, fhh_gc_smem(S), st>>>(
        (const uint32_t*)x0, (const uint32_t*)y0, (const uint32_t*)xb, (const uint32_t*)mask,
        (const uint32_t*)mv0, (const uint32_t*)mv1, (const uint32_t*)sched, (uint32_t*)tab,
        (uint32_t*)gbl, (uint32_t*)dec, (uint32_t*)cts, bp, S, r0, r1, r2, r3, idx0);
    return (int)cudaGetLastError();
}

template <int W>
static int fhh_gc_eval_go(const void* gbl, const void* evl, const void* tab, const void* dec,
                          const void* cts, const void* sched, void* e, void* pay, long long bp,
                          int S, unsigned idx0, cudaStream_t st) {
    static const bool preferred = (fhh_gc_prefer_shared(fhh_gc_eval_kernel<W>), true);
    (void)preferred;
    fhh_gc_eval_kernel<W><<<fhh_gc_blocks(bp), FHH_GC_THREADS, fhh_gc_smem(S), st>>>(
        (const uint32_t*)gbl, (const uint32_t*)evl, (const uint32_t*)tab, (const uint32_t*)dec,
        (const uint32_t*)cts, (const uint32_t*)sched, (uint32_t*)e, (uint32_t*)pay, bp, S,
        idx0);
    return (int)cudaGetLastError();
}

// Returns a CUDA error code, or -1 for an (S, W) the kernel does not take.
extern "C" int fhh_gc_garble_launch(const void* x0, const void* y0, const void* xb,
                                    const void* mask, const void* mv0, const void* mv1,
                                    const void* sched, void* tab, void* gbl, void* dec,
                                    void* cts, long long bp, int S, int W, unsigned r0,
                                    unsigned r1, unsigned r2, unsigned r3, unsigned idx0,
                                    void* stream) {
    if (!fhh_gc_takes(S, W)) return -1;
    if (bp == 0) return 0;
    return (W == 4 ? fhh_gc_garble_go<4> : fhh_gc_garble_go<8>)(
        x0, y0, xb, mask, mv0, mv1, sched, tab, gbl, dec, cts, bp, S, r0, r1, r2, r3, idx0,
        (cudaStream_t)stream);
}

extern "C" int fhh_gc_eval_launch(const void* gbl, const void* evl, const void* tab,
                                  const void* dec, const void* cts, const void* sched, void* e,
                                  void* pay, long long bp, int S, int W, unsigned idx0,
                                  void* stream) {
    if (!fhh_gc_takes(S, W)) return -1;
    if (bp == 0) return 0;
    return (W == 4 ? fhh_gc_eval_go<4> : fhh_gc_eval_go<8>)(
        gbl, evl, tab, dec, cts, sched, e, pay, bp, S, idx0, (cudaStream_t)stream);
}
