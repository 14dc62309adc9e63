// The additive joint's log-partition for Hopper (sm_90a), fp32 accuracy on
// the TF32 tensor cores.
//
// Replaces ops/pallas/logz_kernel.py :: _logz_pallas (_logz_kernel) --
// ttx_additive_logz below.  The wrapper and the plain version are
// ops/cuda/logz_kernel.py.
//
//   logZ[b, t, u] = logsumexp_v(A[b, t, v] + L[b, u, v])
//
// A (B, T, V), L (B, U1, V), out (B, T, U1), all contiguous fp32; any
// B <= 65535 and T, U1, V >= 1.
//
// ---- The product form
//
// With a = A log2(e) and l = L log2(e), each rounded once and the same way
// wherever it is used (__fmul_rn: no contraction into an FMA, so a row's
// largest term is exactly 1), mA[t] = max_v a[t, v], mL[u] = max_v l[u, v],
// p = 2^(a - mA) and q = 2^(l - mL), the sum factorises exactly:
//
//   logZ[t, u] = (mA[t] + mL[u] + log2 S[t, u]) ln 2,  S = sum_v p[t, v] q[u, v]
//
// a (T x V).(V x U1) product per batch row, as k2's simple pruned RNN-T
// loss computes its normalizer.  It needs B (T + U1) V exponentials, not
// B T U1 V.
//
// ---- Why every cell is exact to 2^-24: the underflow certificate
//
// p, q <= 1, so every term p q <= 1 and S <= V.  Where A[t] and L[u] peak on
// different symbols, terms can fall below fp32's normal range.  What the
// product can lose beyond its 3xTF32 rounding (about 2^-21 of each term) is
// a value under 2^-126: p or q itself (the exponential), a split's lo half,
// or a TF32 product (lo.hi', hi.lo', hi.hi') flushed to zero.  Each of a
// term's three products loses less than 2^-126 (the other factor is <= 1),
// so a term loses less than 3 2^-126 < 2^-124, and the sum less than
// V 2^-124.  Where S >= V 2^-100, that is under 2^-24 of S: the product form
// is as exact as fp32.  Every other cell (and a NaN S) is marked and
// recomputed by the exact two-pass max / exp2-sum over V.  On logits of
// moderate range every cell passes; the exact pass is for adversarial
// inputs (a peak 100 nats above the rest in both A[t] and L[u], on
// different symbols).
//
// ---- Bound on the card (H100 SXM, 700 W)
//
// At the flagship training shapes (B = 4, T = 410, U1 = 43, V = 6485): A
// 42.5 MB, L 4.5 MB and logZ 0.3 MB move in 14.1 us at 3.35 TB/s; the
// product's 0.915 GFLOP as 3xTF32 (three TF32 products a product) take
// 5.5 us at 495 TFLOP/s, its 11.8 M exponentials about 3 us at 16 per SM
// per clock.  So bytes bound it.  (The exact form's 457 M exponentials
// alone take 0.109 ms: the parent kernel's bound.)  As built the launches
// move about 113 MB, 34 us: A twice (the row maxima, then the product),
// the split q written and read, the slices' partial sums written and read
// (chip_smoke.py prints both bounds and the kernel's time; PERF.md keeps
// them, measured on an NVIDIA H100 80GB HBM3 at 700 W).
//
// ---- Design: four launches on the caller's stream, no atomics
//
// 1. logz_rowmax: one block of 128 threads a row of A or L, four float4
//    loads in flight a thread, a scalar head and tail (any V, any 4-byte
//    alignment): mA then mL, in log2 units.  A row of L has four blocks,
//    which each take its maximum, read it again (from L2) and write a
//    quarter of q = 2^(l - mL) split into TF32 (hi, lo), zero up to vq (V
//    rounded up to KC), to the workspace: the L rows are few (B U1 of
//    B (T + U1)) and every frame tile needs them; their blocks go first.
// 2. logz_product<NT>: a block owns one b, a tile of TM = 64 frames, a
//    tile of 8 NT <= 64 label rows (U1 spread evenly on ceil(U1 / 64)
//    tiles, rounded up to 8; the tiles on grid y) and one slice of V.  The
//    slices are sized so that the grid fills the card (as many blocks as
//    the occupancy calculator lets the SMs hold, at least one slice).
//    Chunks of KC = 32 columns are copied with 16-byte cp.async into a
//    ring of NSTAGE = 3 stages, two chunks ahead: the A rows raw (a raw
//    row holds the 9 aligned 16-byte blocks around the chunk, so rows that
//    start off a 16-byte boundary, V not a multiple of 4, need no narrower
//    copies) and the split q straight into its swizzled tile (at2).  p =
//    2^(a - mA) is computed and split by the one warp that uses it,
//    straight into its A fragments; zero past the slice or V and on rows
//    past T or U1.  Eight warps: warp w takes frames 16 (w % 4) and half
//    of each chunk's k-steps (w / 4) with mma.sync.m16n8k8 in 3xTF32 into
//    NT fp32 accumulator tiles.  One barrier a chunk.  At the end the two
//    k halves are added in a fixed order and the slice's partial S leaves
//    with plain stores to the workspace (n_split, B, T, U1).
// 3. logz_combine: one thread a cell sums the slices in order; where the
//    certificate holds it writes logZ, else it marks the cell: each block
//    of CB = 256 cells writes its count and its marked cells' indices
//    (compacted by ballot, in cell order).
// 4. logz_exact: one block a combine block, launched every call with the
//    same grid (no host read, so a call can be captured in a CUDA graph);
//    a block whose count is 0 returns at once, else one warp a marked cell
//    runs the two-pass max / exp2-sum over V.
// Every sum is taken in a fixed order: two launches give the same bits.
// The wrapper allocates the workspace (ttx_additive_logz_workspace gives
// its size and where the counts lie); the kernels allocate nothing.
//
// Plain C interface (loaded with ctypes); each launch's error is returned.

#include "tensor_core.cuh"

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

using namespace ttx;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int NWARP = 8;
constexpr int NTHREADS = 32 * NWARP;
constexpr int TM = 64;                 // frames a block: 16 for each of 4 warps,
static_assert(NWARP == 2 * (TM / 16));  // each pair splitting a chunk's k-steps
constexpr int UC = 64;                 // label rows a block, at most
constexpr int KC = 32;                 // columns a chunk
constexpr int RW = KC + 4;             // a raw row: 9 aligned 16-byte blocks
constexpr int NSTAGE = 3;              // stages: two chunks in flight
constexpr int RM_THREADS = 128;        // threads a row, for its maximum
constexpr int RM_UNROLL = 4;           // loads in flight a thread
constexpr int RM_QSPLIT = 4;           // blocks a row of L, for its split q
constexpr int CB = 256;                // cells a combine block
constexpr int CERT_EXP = -100;         // certificate: S >= V 2^CERT_EXP
constexpr int MAX_DEVICES = 64;

// ---- 1. row maxima

__global__ void __launch_bounds__(RM_THREADS)
logz_rowmax(const float* __restrict__ A, const float* __restrict__ L,
            float* __restrict__ m, float2* __restrict__ qs, int n_a, int n_l, int V, int vq) {
    __shared__ float warp_max[RM_THREADS / 32];
    const int tid = threadIdx.x;
    // the rows of L first, RM_QSPLIT blocks each, whose blocks have more to
    // do; m holds mA, then mL
    const bool is_l = blockIdx.x < n_l * RM_QSPLIT;
    const int row = is_l ? n_a + blockIdx.x / RM_QSPLIT : blockIdx.x - n_l * RM_QSPLIT;
    const int part = is_l ? blockIdx.x % RM_QSPLIT : 0;
    const float* p = is_l ? L + (long long)(row - n_a) * V : A + (long long)row * V;
    const int head = min(V, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
    const int n4 = (V - head) >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(p + head);
    float mx = NEG;
    if (tid < head) mx = __fmul_rn(p[tid], LOG2E);
    if (tid < V - head - 4 * n4) mx = fmaxf(mx, __fmul_rn(p[head + 4 * n4 + tid], LOG2E));
    // RM_UNROLL independent 16-byte loads in flight a thread
    for (int i0 = tid; i0 < n4; i0 += RM_UNROLL * RM_THREADS) {
        float4 x[RM_UNROLL];
#pragma unroll
        for (int j = 0; j < RM_UNROLL; ++j) {
            const int i = i0 + j * RM_THREADS;
            x[j] = i < n4 ? __ldg(p4 + i) : make_float4(NEG, NEG, NEG, NEG);
        }
#pragma unroll
        for (int j = 0; j < RM_UNROLL; ++j)
            mx = fmaxf(mx, fmaxf(fmaxf(__fmul_rn(x[j].x, LOG2E), __fmul_rn(x[j].y, LOG2E)),
                                 fmaxf(__fmul_rn(x[j].z, LOG2E), __fmul_rn(x[j].w, LOG2E))));
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if ((tid & 31) == 0) warp_max[tid >> 5] = mx;
    __syncthreads();
    mx = warp_max[0];
    for (int w = 1; w < RM_THREADS / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    if (tid == 0 && part == 0) m[row] = mx;
    if (!is_l) return;
    // a row of L again (from L2), each of its blocks every RM_QSPLIT-th run
    // of RM_THREADS columns: q, split, zero up to vq; 2 RM_UNROLL loads in
    // flight a thread
    constexpr int NQ = 2 * RM_UNROLL, STEP = RM_QSPLIT * RM_THREADS;
    float2* q = qs + (long long)(row - n_a) * vq;
    for (int v0 = part * RM_THREADS + tid; v0 < vq; v0 += NQ * STEP) {
        float x[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            const int v = v0 + j * STEP;
            x[j] = v < V ? p[v] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            const int v = v0 + j * STEP;
            if (v < vq) q[v] = split2(v < V ? exp2f(__fmul_rn(x[j], LOG2E) - mx) : 0.f);
        }
    }
}

// ---- 2. the product, per slice

struct ProdArgs {
    const float* A;
    const float2* qs;      // q split, (B, U1, vq) pairs
    const float* m;        // mA (B*T) then mL (B*U1)
    float* part;           // (n_split, B, T, U1)
    int B, T, U1, V, vq;
    int n_ut;              // tiles of 8 NT label rows
    int slice;             // columns a slice, a multiple of KC
};

template <int NT>
constexpr int prod_smem() {
    return NSTAGE * (TM * RW * (int)sizeof(float) + 8 * NT * KC * (int)sizeof(float2));
}

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
logz_product(ProdArgs a) {
    constexpr int NCP = TM * RW / 4;                   // 16-byte copies of A a chunk
    constexpr int NPP = (NCP + NTHREADS - 1) / NTHREADS;
    constexpr int NCQ = 8 * NT * KC / 2;               // 16-byte copies of q a chunk
    constexpr int NPQ = (NCQ + NTHREADS - 1) / NTHREADS;
    constexpr int QT = 8 * NT * KC;                    // pairs a q stage
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* raw = reinterpret_cast<float*>(smem_raw);   // NSTAGE x TM x RW
    float2* qst = reinterpret_cast<float2*>(raw + NSTAGE * TM * RW);   // NSTAGE x 8NT x KC, at2

    const int tid = threadIdx.x, warp = tid >> 5;
    const int T = a.T, U1 = a.U1;
    const int t0 = blockIdx.x * TM;
    const int u0 = (blockIdx.y % a.n_ut) * 8 * NT;
    const int sp = blockIdx.y / a.n_ut;
    const int b = blockIdx.z;
    const int v_lo = sp * a.slice;
    const int v_hi = min(a.V, v_lo + a.slice);

    // Frame row r of the block from column v_lo, whether it is live, and
    // its shift: the floats from the 16-byte boundary below.  A raw row
    // holds the RW / 4 aligned 16-byte blocks from there, so a chunk's
    // column c sits at raw column shift + c, whatever V is.
    auto row_at = [&](int r, bool& live, int& shift) {
        live = r < TM && t0 + r < T;
        const float* p = a.A + ((long long)b * T + min(t0 + r, T - 1)) * a.V + v_lo;
        shift = (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
        return p - shift;
    };

    // this thread's copies of A, the same in every chunk: block k of row r,
    // columns 4k - shift .. +3 of the chunk; a block is copied where it
    // holds a column of the slice (so it lies in the row's pages), and
    // zero-filled elsewhere
    const float* a_src[NPP];
    int first[NPP];                                    // 4k - shift, or past KC
#pragma unroll
    for (int n = 0; n < NPP; ++n) {
        const int idx = tid + n * NTHREADS;
        bool live;
        int shift;
        a_src[n] = row_at(idx / (RW / 4), live, shift) + 4 * (idx % (RW / 4));
        first[n] = live && idx < NCP ? 4 * (idx % (RW / 4)) - shift : KC;
    }
    // and of q: pairs c, c+1 of label row r (zero past V already), into
    // their swizzled place; zero-filled on rows past U1
    const float2* q_src[NPQ];
    bool q_live[NPQ];
#pragma unroll
    for (int n = 0; n < NPQ; ++n) {
        const int idx = tid + n * NTHREADS;
        const int r = idx / (KC / 2), c = 2 * (idx % (KC / 2));
        q_live[n] = idx < NCQ && u0 + r < U1;
        q_src[n] = a.qs + ((long long)b * U1 + min(u0 + r, U1 - 1)) * a.vq + v_lo + c;
    }
    // this lane's p, converted into its A fragments: frames 16 mw + g and
    // + 8, columns t4 and t4 + 4 of each of the warp's k-steps
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int mw = warp % (TM / 16), kw = warp / (TM / 16);
    const int k0 = KC / 2 * kw;                        // the warp's half of a chunk
    const bool rows_live = t0 + 16 * mw < T;
    float pm[2];
    int p_at[2];                                       // raw index of column k0 + t4, or -1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = 16 * mw + g + 8 * i;
        bool live;
        int shift;
        row_at(r, live, shift);
        p_at[i] = live ? r * RW + shift + k0 + t4 : -1;
        pm[i] = live ? a.m[(long long)b * T + t0 + r] : 0.f;
    }

    auto issue = [&](int ch, int stage) {
        float* dst = raw + stage * TM * RW;
        const int lim = min(KC, v_hi - v_lo - ch * KC);   // live columns of the chunk
#pragma unroll
        for (int n = 0; n < NPP; ++n) {
            const int idx = tid + n * NTHREADS;
            if (idx >= NCP) continue;
            const bool ok = first[n] < lim;
            cp16(dst + 4 * idx, ok ? a_src[n] + ch * KC : a.A, ok);
        }
        float2* qdst = qst + stage * QT;
#pragma unroll
        for (int n = 0; n < NPQ; ++n) {
            const int idx = tid + n * NTHREADS;
            if (idx >= NCQ) continue;
            const int r = idx / (KC / 2), c = 2 * (idx % (KC / 2));
            cp16(reinterpret_cast<float*>(qdst + at2(r, c, KC)),
                 q_live[n] ? reinterpret_cast<const float*>(q_src[n] + ch * KC) : a.A,
                 q_live[n]);
        }
    };

    float acc[NT][4];
    zero(acc);
    const int n_chunks = (v_hi - v_lo + KC - 1) / KC;
    constexpr int AHEAD = NSTAGE - 1;          // chunks in flight beside the current
#pragma unroll
    for (int ch = 0; ch < AHEAD; ++ch) {
        if (ch < n_chunks) issue(ch, ch);
        cp_commit();
    }
    cp_wait<AHEAD - 1>();
    __syncthreads();                           // chunk 0 has landed, for every thread
    for (int ch = 0; ch < n_chunks; ++ch) {
        // stage ch + AHEAD was last read by chunk ch - 1's products, which
        // every warp finished before the last barrier
        if (ch + AHEAD < n_chunks) issue(ch + AHEAD, (ch + AHEAD) % NSTAGE);
        cp_commit();
        if (rows_live) {
            const float* stage = raw + (ch % NSTAGE) * TM * RW;
            const int lim = min(KC, v_hi - v_lo - ch * KC);
            const RowView2<KC> q_rows(qst + (ch % NSTAGE) * QT, 0);
#pragma unroll
            for (int k = 0; k < KC / 2; k += 8) {
                unsigned ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
                for (int x = 0; x < 4; ++x) {  // A's (g, t4), (g+8, t4), (g, t4+4), (g+8, t4+4)
                    const int i = x & 1, h = x >> 1;
                    const float p = p_at[i] >= 0 && k0 + k + t4 + 4 * h < lim
                        ? exp2f(__fmul_rn(stage[p_at[i] + k + 4 * h], LOG2E) - pm[i]) : 0.f;
                    split(p, ah[x], al[x]);
                }
                load_b(q_rows, k0 + k, bh, bl);
                mma3(acc, ah, al, bh, bl);
            }
        }
        cp_wait<AHEAD - 1>();                  // this thread's copies of chunk ch + 1
        __syncthreads();                       // chunk ch + 1 landed; chunk ch is read
    }
    cp_wait<0>();

    // the two k halves added in a fixed order; the slice's partial S out
    float* red = reinterpret_cast<float*>(qst);    // TM x 8 NT
    if (kw == 1 && rows_live) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                red[(16 * mw + g + 8 * (e >> 1)) * 8 * NT + 8 * j + 2 * t4 + (e & 1)] = acc[j][e];
    }
    __syncthreads();
    if (kw != 0 || !rows_live) return;
    float* out = a.part + ((long long)sp * a.B + b) * T * U1;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = 16 * mw + g + 8 * (e >> 1), col = 8 * j + 2 * t4 + (e & 1);
            const int t = t0 + r, u = u0 + col;
            if (t < T && u < U1)
                out[(long long)t * U1 + u] = acc[j][e] + red[r * 8 * NT + col];
        }
}

// ---- 3. the slices summed, the certificate, the marks

__global__ void __launch_bounds__(CB)
logz_combine(const float* __restrict__ part, const float* __restrict__ m,
             float* __restrict__ out, int* __restrict__ counts, int* __restrict__ list,
             int B, int T, int U1, int V, int n_split) {
    __shared__ int warp_n[CB / 32];
    const long long cells = (long long)B * T * U1;
    const long long c = (long long)blockIdx.x * CB + threadIdx.x;
    bool marked = false;
    if (c < cells) {
        float s = 0.f;
        for (int i = 0; i < n_split; ++i) s += part[i * cells + c];
        const long long bt = c / U1;
        const int u = (int)(c - bt * U1);
        const long long b = bt / T;
        if (s >= ldexpf((float)V, CERT_EXP))
            out[c] = (m[bt] + m[(long long)B * T + b * U1 + u] + log2f(s)) * LN2;
        else
            marked = true;                     // also a NaN S
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(FULL, marked);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < CB / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
    }
    if (marked)
        list[(long long)blockIdx.x * CB + before + __popc(ballot & ((1u << lane) - 1u))] = (int)c;
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// ---- 4. the exact pass over the marked cells

__global__ void __launch_bounds__(CB)
logz_exact(const float* __restrict__ A, const float* __restrict__ L,
           float* __restrict__ out, const int* __restrict__ counts,
           const int* __restrict__ list, int T, int U1, int V) {
    const int n = counts[blockIdx.x];
    if (n == 0) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < n; i += CB / 32) {
        const int c = list[(long long)blockIdx.x * CB + i];
        const int bt = c / U1, u = c - bt * U1, b = bt / T;
        const float* pa = A + (long long)bt * V;
        const float* pl = L + ((long long)b * U1 + u) * V;
        float mx = NEG;
        for (int v = lane; v < V; v += 32)
            mx = fmaxf(mx, __fmul_rn(pa[v], LOG2E) + __fmul_rn(pl[v], LOG2E));
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        float s = 0.f;
        for (int v = lane; v < V; v += 32)
            s += exp2f(__fmul_rn(pa[v], LOG2E) + __fmul_rn(pl[v], LOG2E) - mx);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        if (lane == 0) out[c] = (mx + log2f(s)) * LN2;
    }
}

// ---- host side

// f(std::integral_constant<int, NT>) for the NT tiles of 8 label rows a
// block holds.
template <class F>
int with_nt(int nt, F f) {
    switch (nt) {
        case 1: return f(std::integral_constant<int, 1>{});
        case 2: return f(std::integral_constant<int, 2>{});
        case 3: return f(std::integral_constant<int, 3>{});
        case 4: return f(std::integral_constant<int, 4>{});
        case 5: return f(std::integral_constant<int, 5>{});
        case 6: return f(std::integral_constant<int, 6>{});
        case 7: return f(std::integral_constant<int, 7>{});
        case 8: return f(std::integral_constant<int, 8>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

struct Plan {
    int nt, n_tt, n_ut, n_split, slice, n_cb, vq;
    long long cells, part, maxima, counts, list, words;   // offsets and size, in 4-byte words
};

// The launch geometry and the workspace layout of a shape: the slices of V
// are as many as fill the card (blocks the SMs hold at once, from the
// occupancy calculator) and no more than V has chunks.
int make_plan(int B, int T, int U1, int V, Plan& p) {
    if (B < 1 || T < 1 || U1 < 1 || V < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    p.cells = (long long)B * T * U1;
    p.n_tt = (T + TM - 1) / TM;
    p.n_ut = (U1 + UC - 1) / UC;
    p.nt = ((U1 + p.n_ut - 1) / p.n_ut + 7) / 8;       // rows spread evenly on the tiles
    if (p.cells >= INT_MAX || (long long)B * (T + RM_QSPLIT * U1) >= INT_MAX
        || p.n_ut > 65535)
        return (int)cudaErrorInvalidValue;
    // the SMs and the product's blocks an SM holds, asked once a device and
    // NT (the answers do not change; a call in a CUDA graph capture asks
    // nothing)
    static int cache[MAX_DEVICES][UC / 8 + 1][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int* known = cache[dev][p.nt];
    if (known[0] == 0) {
        int n_sm = 0, occ = 0;
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
        const int code = with_nt(p.nt, [&](auto nt) {
            constexpr int NT = decltype(nt)::value;
            cudaError_t e = cudaFuncSetAttribute(
                logz_product<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, prod_smem<NT>());
            if (e == cudaSuccess)
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, logz_product<NT>,
                                                                  NTHREADS, prod_smem<NT>());
            return (int)e;
        });
        if (code != 0) return code;
        known[1] = std::max(occ, 1) * n_sm;
        known[0] = 1;
    }
    const long long n_chunks = (V + KC - 1) / KC;
    long long want = known[1] / ((long long)p.n_tt * p.n_ut * B);
    want = std::max(1LL, std::min({want, n_chunks, 65535LL / p.n_ut}));
    const long long per = (n_chunks + want - 1) / want;        // chunks a slice
    p.slice = (int)(per * KC);
    p.n_split = (int)((n_chunks + per - 1) / per);
    p.n_cb = (int)((p.cells + CB - 1) / CB);
    p.vq = (int)(n_chunks * KC);
    p.part = 2LL * B * U1 * p.vq;                       // after q, split, at 0
    p.maxima = p.part + p.n_split * p.cells;
    p.counts = p.maxima + (long long)B * (T + U1);
    p.list = p.counts + p.n_cb;
    p.words = p.list + (long long)p.n_cb * CB;
    return 0;
}

}  // namespace

extern "C" {

// 4-byte words of the workspace ttx_additive_logz takes (a negative CUDA
// error code for a shape it does not take); info, when given, gets the
// number of slices, the columns a slice, the number of combine blocks and
// the offset of their counts of marked cells (int32) in the workspace.
long long ttx_additive_logz_workspace(int B, int T, int U1, int V, long long* info) {
    Plan p;
    const int code = make_plan(B, T, U1, V, p);
    if (code != 0) return -code;
    if (info != nullptr) {
        info[0] = p.n_split;
        info[1] = p.slice;
        info[2] = p.n_cb;
        info[3] = p.counts;
    }
    return p.words;
}

int ttx_additive_logz(const void* a, const void* l, void* out, void* work, int B, int T,
                      int U1, int V, void* stream) {
    Plan p;
    int code = make_plan(B, T, U1, V, p);
    if (code != 0) return code;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* A = static_cast<const float*>(a);
    const float* L = static_cast<const float*>(l);
    float* w = static_cast<float*>(work);
    float* maxima = w + p.maxima;
    int* counts = reinterpret_cast<int*>(w + p.counts);
    int* list = reinterpret_cast<int*>(w + p.list);
    const int n_rm = B * (T + RM_QSPLIT * U1);         // row-max blocks
    cudaError_t err;

    float2* qs = reinterpret_cast<float2*>(w);
    logz_rowmax<<<n_rm, RM_THREADS, 0, st>>>(A, L, maxima, qs, B * T, B * U1, V, p.vq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    ProdArgs pa{A, qs, maxima, w + p.part, B, T, U1, V, p.vq, p.n_ut, p.slice};
    const dim3 grid(p.n_tt, p.n_ut * p.n_split, B);
    code = with_nt(p.nt, [&](auto nt) {
        constexpr int NT = decltype(nt)::value;
        logz_product<NT><<<grid, NTHREADS, prod_smem<NT>(), st>>>(pa);
        return (int)cudaGetLastError();
    });
    if (code != 0) return code;

    logz_combine<<<p.n_cb, CB, 0, st>>>(w + p.part, maxima, static_cast<float*>(out), counts, list,
                                        B, T, U1, V, p.n_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    logz_exact<<<p.n_cb, CB, 0, st>>>(A, L, static_cast<float*>(out), counts, list, T, U1, V);
    return (int)cudaGetLastError();
}

}  // extern "C"
