// The pruned RNN-T loss's band DP for Hopper (sm_90a), fp32.
//
// Replaces two TPU kernels of the JAX package:
//   * ops/pallas/band_kernel.py :: band_alpha_pallas (_alpha_kernel)
//     -- ttx_band_alpha below;
//   * ops/pallas/band_kernel.py :: band_beta_pallas (_beta_kernel)
//     -- ttx_band_beta below.
// The wrappers and plain PyTorch versions are ops/cuda/band_kernel.py.  (The
// pruned loss's third kernel, the additive logZ, is csrc/additive_logz.cu.)
// Plain C interface (loaded with ctypes); each kernel runs on the caller's
// stream, allocates nothing (the alpha sweep's workspace comes from the
// caller) and returns cudaGetLastError() after its launches.
//
// ---- ttx_band_alpha / ttx_band_beta: the band DP over T
//
// lp_b, lp_l (B, T, S) fp32, d (B, T) int32, tf, sf (B,) int32, out
// (B, T, S) fp32, S <= 128.  Cell (t, s) is lattice cell (t, rs[t] + s).
// With lae(a, b) = max(a, b) + log1p(exp(-|a - b|)) (finite for two NEGs):
//
//   alpha[0][s] = s == 0 ? 0 : NEG, then the chain below
//   alpha[t][s] = ok(d[t], s + d[t]) ? alpha[t-1][s+d[t]] + lp_b[t-1][s+d[t]]
//                                    : NEG,
//                 then for s = 1 .. S-1:
//                   alpha[t][s] = lae(alpha[t][s], alpha[t][s-1] + lp_l[t][s-1])
//
//   beta[t][s]  = t == tf ? (s == sf ? lp_b[t][s] : NEG)
//                         : lp_b[t][s] + (ok(d[t], s - d[t]) ? beta[t+1][s-d[t]]
//                                                             : NEG),
//                 then for s = S-2 .. 0:
//                   beta[t][s] = lae(beta[t][s], lp_l[t][s] + beta[t][s+1])
//
// where ok(d, src) is 0 <= d < S and 0 <= src < S: a shift outside [0, S)
// means "no in-band source", as in the Pallas kernels, and beta[T] is NEG.
//
// Bound on the card: at the flagship shapes (B = 4, T = 410, S = 5) each
// sweep moves about 33 KB per array, well under a microsecond of memory
// time.  What bounds it is its chain of dependent steps: a row is a shuffle
// for the blank edge and S - 1 dependent shuffle + lae steps for the label
// chain, about 0.6 us at S = 5 with its inputs in shared memory, so a sweep
// row by row takes T - 1 = 409 of them.
//
// The alpha sweep, in chunks of T.  The recurrence is linear in the log
// semiring: row t is M_t (x) row t - 1, M_t the blank edge (the shift by
// d[t], plus lp_b[t-1]) followed by the row's label chain.  So T is cut into
// C chunks of rows [r0, r1) (band_kernel.py::band_alpha_plan picks C,
// ::band_alpha_chunks the rows: T = C q + rem, the first rem chunks q + 1
// long), and:
//   * phase A, parallel over (sequence, chunk, start slot k): chunk c >= 1
//     runs its rows from e_k (0 at slot k, NEG elsewhere) as the state of
//     row r0 - 1, and its end state is column k of its transfer matrix P_c
//     (S x S, to work[b][c][k][s]); chunk 0 runs from row 0's start, writes
//     its alpha rows and leaves its end state E_0;
//   * phase B, over the chunk boundaries: E_c = max(NEG, P_c (x) E_{c-1}),
//     an S-term log-sum-exp a slot; the clamp keeps a slot no path reaches
//     at NEG, as the row-by-row sweep leaves it.  At S <= 32 in two levels
//     over groups of H boundaries (each group's composite from the unit
//     vectors, in parallel; the groups' end states one after another; the
//     states inside each group, in parallel): about 2 H + (C - 2) / H steps,
//     H near sqrt((C - 2) / 2); one boundary after another beyond;
//   * phase C, parallel over chunks: chunk c >= 1 re-runs its rows from
//     E_{c-1} and writes its alpha rows.
// The chain falls from T rows to 2 ceil(T / C) rows plus phase B's steps
// (band_kernel.py::band_alpha_chain); phase A's work grows about S + 1 fold
// (S start vectors a chunk).
// Two launches: band_alpha_transfer (phase A; at C = 1 the whole sweep, one
// warp a sequence) and band_alpha_rows (phases B and C, a block a group of
// chunks, each block repeating phase B up to its last chunk, so every block
// reads the same E).  The second is a programmatic dependent launch: its
// blocks start while the first runs and stage their rows' inputs, then wait
// (griddepcontrol.wait) before they read P and E_0.
//
// A start vector spans W lanes, W the power of two >= S at S <= 32 (32 / W
// of them a warp, moved by segmented shuffles), else the warp with NS =
// ceil(S / 32) slots a lane.  Before its chain begins each block copies its
// chunks' lp_b, lp_l and d rows into shared memory with cp.async (in tiles
// of rows where they do not fit 48 KB), so no row waits on global memory.
// At S <= 32 the in-row label chain is a scan over the slots, ceil(log2 S)
// shuffle + lae steps in place of S - 1.  The sweep's exponentials and
// logarithms run on the special function units (lae_sfu).  A segment holds
// its state as a float64 offset K plus float32 values near 0: every 8th row
// its largest value moves into K, so a row's sums round at the size of the
// row's own log-probs, not at that of the log-alpha (which reaches -17600
// in the card test's inputs at S = 128, T = 410, where the row-by-row
// float32 sweep drifts 1.7x the tolerance from float64).  The log-sums are
// reassociated, so alpha matches the plain version to rounding, not bit for
// bit; no atomics, the order of every sum is fixed, so two launches agree
// to the bit.  work holds B C S S floats.
//
// The beta sweep: one warp per sequence, lane s holding band slots s,
// s + 32, ... (NS = ceil(S / 32) of them, a template parameter), so the
// wavefront lives in registers and moves by warp shuffles (no shared memory,
// no barrier).  The blank edge gathers slot s - d from lane (s - d) % 32: one
// shuffle of each of the NS registers, the right one kept.  The in-row label
// chain steps from slot s + 1 to s by one shuffle down (by lane 0's register
// j + 1 into lane 31's register j where it crosses a 32-slot block).  Each
// lane loads the next row's lp_b, lp_l and d before it works on the current
// row, so the loads overlap the chain.  The terminal (tf, sf) is injected
// inside the sweep, so rows past a sequence's end stay near NEG.  No 128-lane
// padding or rolls: those fit the TPU's vector unit and VMEM.

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int BAND_MAX_S = 128;

__device__ __forceinline__ float lae(float a, float b) {
    return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// lae for the alpha sweep, its exponential and logarithm each one special
// function unit op: absolute error about 3e-7, under an ulp of the values
// the sweep adds it to (kept near 0 by its offsets, see renorm)
__device__ __forceinline__ float lae_sfu(float a, float b) {
    return fmaxf(a, b) + __logf(1.f + __expf(-fabsf(a - b)));
}

// The value of slot src across the warp's registers x (slot s is x[s / 32]
// of lane s % 32): one shuffle of each register, the right one kept; 0
// where src lies outside [0, 32 NS), where the callers do not use it.
template <int NS>
__device__ __forceinline__ float gather(const float (&x)[NS], int src) {
    float got = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const float v = __shfl_sync(FULL, x[j], src & 31);
        if ((src >> 5) == j) got = v;
    }
    return got;
}

// ---- the alpha sweep in chunks of T (see the header)

constexpr int ALPHA_K_WARPS = 16;     // start slots a block of the transfer launch
constexpr int ALPHA_C_WARPS = 16;     // warps a block of the rows launch
constexpr int SMEM_FLOATS = 48 * 1024 / 4;

// Boundaries a group of phase B's two levels: the H that minimises its chain
// of 2 H + ceil(n / H) steps over n = C - 2 boundaries
// (band_kernel.py::band_alpha_group).
__host__ __device__ inline int alpha_group(int C) {
    const int n = C - 2;
    int h = 1;
    while (n > 0 && 2 * (h + 1) + (n + h) / (h + 1) < 2 * h + (n + h - 1) / h) ++h;
    return h;
}

// Floats of phase B's scratch in shared memory: the two levels' Q and F at
// one slot a lane, two vectors beyond.
__host__ __device__ inline int alpha_phase_b_floats(int C, int S, int H) {
    if (S > 32) return 2 * S;
    const int G = (C - 2 + H - 1) / H;
    return G * S * S + (G + 1) * S;
}

// Lanes a segment spans: the power of two >= S at S <= 32, else the warp.
__host__ __device__ inline int seg_width(int S) {
    int w = 1;
    while (w < S && w < 32) w *= 2;
    return w;
}

// The first row of chunk c: T = C q + rem rows, the first rem chunks q + 1
// long, the others q (band_kernel.py::band_alpha_chunks).
__device__ __forceinline__ int chunk_row(int c, int T, int C) {
    const int q = T / C;
    return c * q + min(c, T - q * C);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
}

// The staged inputs of nc chunks, R rows each: row i of chunk slot cl holds
// lp_l and d of row t = chunk_row(c) + i0 + i and lp_b of row t - 1.
struct Stage {
    float* l;
    float* b;
    int* d;
    int R;
};

__device__ __forceinline__ Stage carve(float* smem, int nc, int R, int S) {
    return {smem, smem + nc * R * S, reinterpret_cast<int*>(smem + 2 * nc * R * S), R};
}

// Copy rows i0 .. i0 + R - 1 of chunks c_lo .. c_lo + nc - 1 into the stage
// (by the whole block; rows past a chunk's end are not copied) and, with
// wait, wait for the copies and the block.
__device__ void stage_rows(const Stage& st, const float* pb, const float* pl,
                           const int* pd, int c_lo, int nc, int i0, int T, int C,
                           int S, bool wait = true) {
    const int R = st.R;
    for (int e = threadIdx.x; e < nc * R * S; e += blockDim.x) {
        const int row = e / S, s = e - row * S, cl = row / R;
        const int c = c_lo + cl, t = chunk_row(c, T, C) + i0 + row - cl * R;
        if (t < chunk_row(c + 1, T, C)) {
            cp_async4(&st.l[e], pl + (long long)t * S + s);
            if (t > 0) cp_async4(&st.b[e], pb + (long long)(t - 1) * S + s);
        }
    }
    for (int e = threadIdx.x; e < nc * R; e += blockDim.x) {
        const int cl = e / R, c = c_lo + cl, t = chunk_row(c, T, C) + i0 + e - cl * R;
        if (t < chunk_row(c + 1, T, C)) cp_async4(&st.d[e], pd + t);
    }
    if (wait) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }
}

// The value of slot src across the segment's registers x (slot s is x[s / 32]
// of the segment's lane s % W); 0 where src lies outside [0, 32 NS), where
// the callers do not use it.
template <int NS>
__device__ __forceinline__ float gather(const float (&x)[NS], int src, int W) {
    float got = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const float v = __shfl_sync(FULL, x[j], src & (W - 1), W);
        if ((src >> 5) == j) got = v;
    }
    return got;
}

// Row t of a segment whose state K + a[] holds row t - 1 (at t = 0, the
// start: no blank edge into row 0), from row il of chunk slot cl of the
// stage.  Every lane of the warp takes every step (the shuffles); a segment
// that is not on keeps its state.  Writes the row, K + a, to out where given.
template <int NS>
__device__ __forceinline__ void row_step(float (&a)[NS], double K, const Stage& st, int cl,
                                         int il, int t, bool on, int S, int W, int sub,
                                         float* out) {
    const int idx = cl * st.R + il;
    const int dt = st.d[idx];
    const float* lb = st.b + idx * S;
    const float* ll = st.l + idx * S;
    float x[NS], c[NS], l[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {        // (slots past S read slot S - 1, unused)
        const int s = sub + 32 * j, sc = min(s, S - 1);
        x[j] = s < S ? a[j] + lb[sc] : NEG;
        l[j] = s < S ? ll[sc] : NEG;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {        // blank edges out of row t - 1
        const int src = sub + 32 * j + dt;
        const float got = gather(x, src, W);
        c[j] = t == 0 ? a[j] : (dt >= 0 && dt < S && src < S) ? got : NEG;
    }
    if (NS == 1) {
        // the in-row label chain as a scan over the segment's slots: (w, v)
        // = (lp_l of the slot before, the slot's value), combined as
        // (w1, v1) o (w2, v2) = (w1 + w2, lae_sfu(v2, v1 + w2)); ceil(log2 S) steps
        float w = __shfl_up_sync(FULL, l[0], 1, W), v = c[0];
        for (int o = 1; o < S; o <<= 1) {
            const float wo = __shfl_up_sync(FULL, w, o, W);
            const float vo = __shfl_up_sync(FULL, v, o, W);
            if (sub >= o) {
                v = lae_sfu(v, vo + w);
                w += wo;
            }
        }
        c[0] = v;
    } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {    // the chain slot by slot, slots 32j..
            const int k_end = min(S, 32 * j + 32);
            if (j > 0 && 32 * j < S) {    // slot 32j from slot 32j - 1
                const float cand = __shfl_sync(FULL, c[j - 1] + l[j - 1], 31);
                if (sub == 0) c[j] = lae_sfu(c[j], cand);
            }
            for (int k = max(1, 32 * j + 1); k < k_end; ++k) {
                const float cand = __shfl_up_sync(FULL, c[j] + l[j], 1, W);
                if (sub + 32 * j == k) c[j] = lae_sfu(c[j], cand);
            }
        }
    }
    if (on) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int s = sub + 32 * j;
            a[j] = c[j];
            if (out != nullptr && s < S) out[(long long)t * S + s] = (float)(K + c[j]);
        }
    }
}

// Moves the segment's largest value m into its offset (K += m, a -= m), so
// the state stays near 0, where its sums round finely; a row no path
// reaches (m at NEG) is left as it is.
template <int NS>
__device__ __forceinline__ void renorm(float (&a)[NS], double& K, int S, int W, int sub) {
    float m = NEG;
#pragma unroll
    for (int j = 0; j < NS; ++j)
        if (sub + 32 * j < S) m = fmaxf(m, a[j]);
    for (int o = W >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o, W));
    if (m > NEG / 2) {
        K += m;
#pragma unroll
        for (int j = 0; j < NS; ++j) a[j] -= m;
    }
}

constexpr int RENORM_ROWS = 8;        // rows between two renorms

// Phase A: grid (B, chunk groups of P, start-slot groups), a warp per start
// slot k, its P segments on P consecutive chunks.  Chunk c >= 1 runs from e_k
// as the state of the row before it and leaves its end state as column k of
// P_c in work[b][c][k][.]; chunk 0 runs from row 0's start (segment k = 0),
// writes its alpha rows and leaves its end state E_0 in work[b][0][0][.].
template <int NS>
__global__ void band_alpha_transfer(const float* __restrict__ lpb,
                                    const float* __restrict__ lpl,
                                    const int* __restrict__ d,
                                    float* __restrict__ alpha,
                                    float* __restrict__ work, int T, int S, int C,
                                    int R) {
    extern __shared__ float smem[];
    asm volatile("griddepcontrol.launch_dependents;");
    const int W = seg_width(S), P = 32 / W;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = lane & (W - 1), seg = lane / W;
    const int b = blockIdx.x, c_lo = blockIdx.y * P, nc = min(P, C - c_lo);
    const int c = c_lo + seg, k = blockIdx.z * (blockDim.x >> 5) + warp;
    const bool live = seg < nc && k < S && (c > 0 || k == 0);
    const long long base = (long long)b * T * S;
    const Stage st = carve(smem, min(P, C), R, S);

    float a[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) a[j] = (sub + 32 * j == k) ? 0.f : NEG;
    const int r0 = live ? chunk_row(c, T, C) : 0;
    const int n = live ? chunk_row(c + 1, T, C) - r0 : 0;
    const int L = (T + C - 1) / C, cl = min(seg, nc - 1);
    float* out = (live && c == 0) ? alpha + base : nullptr;
    double K = 0.0;
    for (int i0 = 0; i0 < L; i0 += R) {
        if (i0 > 0) __syncthreads();      // the last tile is read
        stage_rows(st, lpb + base, lpl + base, d + (long long)b * T, c_lo, nc, i0, T, C, S);
        for (int i = i0; i < min(L, i0 + R); ++i) {
            row_step(a, K, st, cl, i - i0, r0 + i, i < n, S, W, sub, out);
            if (i % RENORM_ROWS == RENORM_ROWS - 1) renorm(a, K, S, W, sub);
        }
    }
    if (live) {
        float* pw = work + (((long long)b * C + c) * S + k) * S;
#pragma unroll
        for (int j = 0; j < NS; ++j)
            if (sub + 32 * j < S) pw[sub + 32 * j] = (float)(K + a[j]);
    }
}

// One boundary step of a segment (lane sub holds slot sub): e <- max(NEG,
// M (x) e), M[k][s] at m[k S + s], e[k] from the segment's lane k.  Terms
// k >= S are NEG (their exponentials 0), selected, not branched around, so
// the K exponentials issue together; the largest term, then the
// exponentials summed over k in order.
template <int K>
__device__ __forceinline__ float vec_step(float e, const float* m, int S, int W, int sub) {
    const int sl = min(sub, S - 1);
    float x[K], mx;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const float ek = __shfl_sync(FULL, e, k, W);
        x[k] = k < S ? ek + m[min(k, S - 1) * S + sl] : NEG;
        mx = k == 0 ? x[0] : fmaxf(mx, x[k]);
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) sum += __expf(x[k] - mx);
    return fmaxf(mx + __logf(sum), NEG);
}

// Phase B at one slot a lane (S <= K = W <= 32), by the whole block, in two
// levels over groups of H boundaries: E_c = max(NEG, P_c (x) E_{c-1}) for
// c = 1 .. n.  B1, parallel over (group g, start slot k): the group's
// matrices applied to e_k give column k of its composite Q_g.  B2, one
// segment: F_{g+1} = Q_g (x) F_g from F_0 = E_0, the E at each group's end.
// B3, parallel over groups: the E inside each group from F_g.  A chain of
// about 2 H + G steps in place of n.  Stores E_{c-1} of chunks c_lo ..
// c_last in ends; q (G S S floats) and f ((G + 1) S) are scratch.
template <int K>
__device__ void boundaries_two_level(float* ends, float* q, float* f, const float* pmat,
                                     const float* wp, int S, int c_lo, int c_last, int H) {
    const int W = K, P = 32 / W, nw = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = lane & (W - 1), seg = lane / W, sl = min(sub, S - 1);
    const int n = c_last - 1, G = (n + H - 1) / H;
    const auto keep = [&](int c, float e) {        // E_c, wanted by chunk c + 1
        if (c + 1 >= c_lo && c + 1 <= c_last && sub < S) ends[(c + 1 - c_lo) * S + sub] = e;
    };
    for (int base = warp * P; base < G * S; base += nw * P) {     // B1
        const int sg = base + seg, g = sg / S, k = sg - g * S;
        const int c0 = g * H + 1, c1 = min(n, c0 + H - 1);
        float e = sub == k ? 0.f : NEG;
        for (int i = 0; i < H; ++i) {
            const float ne = vec_step<K>(e, pmat + (long long)(min(c0 + i, n) - 1) * S * S,
                                         S, W, sub);
            if (sg < G * S && c0 + i <= c1) e = ne;
        }
        if (sg < G * S && sub < S) q[(g * S + k) * S + sub] = e;
    }
    __syncthreads();
    if (warp == 0) {                                                // B2
        float e = wp[sl];
        if (seg == 0) {
            keep(0, e);
            if (sub < S) f[sub] = e;
        }
        for (int g = 0; g < G; ++g) {
            e = vec_step<K>(e, q + g * S * S, S, W, sub);
            if (seg == 0) {
                keep(min(n, (g + 1) * H), e);
                if (sub < S) f[(g + 1) * S + sub] = e;
            }
        }
    }
    __syncthreads();
    for (int base = warp * P; base < G; base += nw * P) {          // B3
        const int g = base + seg, c1 = min(n, g * H + H);
        float e = g < G ? f[g * S + sl] : NEG;
        for (int i = 1; i < H; ++i) {
            const int c = g * H + i;
            const float ne = vec_step<K>(e, pmat + (long long)(min(c, n) - 1) * S * S, S, W,
                                         sub);
            if (g < G && c < c1) {
                e = ne;
                keep(c, e);
            }
        }
    }
}

// Phases B and C: grid (B, groups of CB = P x warps chunks from chunk 1).
// The block carries the end states across the chunk boundaries, E_c =
// max(NEG, P_c (x) E_{c-1}), up to its last chunk (every block of a sequence
// takes the same steps, so all read the same E): in two levels over groups
// of H at one slot a lane, boundary by boundary by warp 0 beyond.  Then each
// segment re-runs its chunk from E_{c-1} and writes the alpha rows.  P_c is
// staged in shared memory when it fits (p_staged), else read from work.
template <int NS>
__global__ void band_alpha_rows(const float* __restrict__ lpb,
                                const float* __restrict__ lpl,
                                const int* __restrict__ d, float* __restrict__ alpha,
                                const float* __restrict__ work, int T, int S, int C,
                                int R, int H, int p_staged) {
    extern __shared__ float smem[];
    const int W = seg_width(S), P = 32 / W;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = lane & (W - 1), seg = lane / W;
    const int cb = P * (blockDim.x >> 5);
    const int b = blockIdx.x, c_lo = 1 + blockIdx.y * cb, nc = min(cb, C - c_lo);
    const int c_last = c_lo + nc - 1;
    const long long base = (long long)b * T * S;
    const float* wp = work + (long long)b * C * S * S;     // [c][k][s]
    const Stage st = carve(smem, cb, R, S);
    float* ends = smem + cb * R * (2 * S + 1);             // E_{c-1} of chunk slot c - c_lo
    float* buf = ends + cb * S;                            // phase B's scratch
    float* pm = buf + alpha_phase_b_floats(C, S, H);       // P_1 .. P_{c_last - 1}
    // the rows' inputs first, while the transfer launch may still run; then
    // wait for its P and E_0
    stage_rows(st, lpb + base, lpl + base, d + (long long)b * T, c_lo, nc, 0, T, C, S, false);
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (p_staged)
        for (int e = threadIdx.x; e < (c_last - 1) * S * S; e += blockDim.x)
            cp_async4(&pm[e], wp + S * S + e);
    const float* pmat = p_staged ? pm : wp + S * S;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (NS == 1) {
        const int G = (C - 2 + H - 1) / H;
        float* q = buf;
        float* f = buf + G * S * S;
        switch (W) {
            case 1: boundaries_two_level<1>(ends, q, f, pmat, wp, S, c_lo, c_last, H); break;
            case 2: boundaries_two_level<2>(ends, q, f, pmat, wp, S, c_lo, c_last, H); break;
            case 4: boundaries_two_level<4>(ends, q, f, pmat, wp, S, c_lo, c_last, H); break;
            case 8: boundaries_two_level<8>(ends, q, f, pmat, wp, S, c_lo, c_last, H); break;
            case 16: boundaries_two_level<16>(ends, q, f, pmat, wp, S, c_lo, c_last, H); break;
            default: boundaries_two_level<32>(ends, q, f, pmat, wp, S, c_lo, c_last, H); break;
        }
    } else if (warp == 0) {               // phase B, slots lane + 32 j
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int s = lane + 32 * j;
            if (s < S) {
                buf[s] = wp[s];
                if (c_lo == 1) ends[s] = wp[s];
            }
        }
        __syncwarp();
        for (int c = 1; c < c_last; ++c) {
            const float* cur = buf + ((c - 1) & 1) * S;
            float* nxt = buf + (c & 1) * S;
            const float* pc = pmat + (long long)(c - 1) * S * S;
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int s = lane + 32 * j;
                if (s < S) {
                    float m = pc[s] + cur[0], sum = 0.f;
                    for (int k = 1; k < S; ++k) m = fmaxf(m, pc[k * S + s] + cur[k]);
                    for (int k = 0; k < S; ++k) sum += __expf(pc[k * S + s] + cur[k] - m);
                    const float e = fmaxf(m + __logf(sum), NEG);
                    nxt[s] = e;
                    if (c + 1 >= c_lo) ends[(c + 1 - c_lo) * S + s] = e;
                }
            }
            __syncwarp();
        }
    }
    __syncthreads();

    const int cl = warp * P + seg, c = c_lo + cl;          // phase C
    const bool live = cl < nc;
    float a[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const int s = sub + 32 * j;
        a[j] = NEG;
        if (live && s < S) a[j] = ends[cl * S + s];
    }
    double K = 0.0;
    renorm(a, K, S, W, sub);
    const int r0 = live ? chunk_row(c, T, C) : 0;
    const int n = live ? chunk_row(c + 1, T, C) - r0 : 0;
    const int L = (T + C - 1) / C;
    for (int i0 = 0; i0 < L; i0 += R) {
        if (i0 > 0) {
            __syncthreads();
            stage_rows(st, lpb + base, lpl + base, d + (long long)b * T, c_lo, nc, i0, T, C, S);
        }
        for (int i = i0; i < min(L, i0 + R); ++i) {
            row_step(a, K, st, cl, i - i0, r0 + i, i < n, S, W, sub, alpha + base);
            if (i % RENORM_ROWS == RENORM_ROWS - 1) renorm(a, K, S, W, sub);
        }
    }
}

template <int NS>
__global__ void band_beta_kernel(const float* __restrict__ lpb,
                                 const float* __restrict__ lpl,
                                 const int* __restrict__ d,
                                 const int* __restrict__ tf,
                                 const int* __restrict__ sf,
                                 float* __restrict__ beta, int T, int S) {
    const int lane = threadIdx.x;
    const long long base = (long long)blockIdx.x * T * S;
    const float* pb = lpb + base;
    const float* pl = lpl + base;
    const int* pd = d + (long long)blockIdx.x * T;
    float* po = beta + base;
    const int t_final = tf[blockIdx.x];
    const int s_final = sf[blockIdx.x];

    // register j holds slot lane + 32 j
    float nxt[NS], b_cur[NS], l_cur[NS];  // beta[t+1][s], lp_b[t][s], lp_l[t][s]
    const long long last = (long long)(T - 1) * S;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const int s = lane + 32 * j;
        nxt[j] = NEG;
        b_cur[j] = s < S ? pb[last + s] : NEG;
        l_cur[j] = s < S ? pl[last + s] : NEG;
    }
    int d_cur = pd[T - 1];
    for (int t = T - 1; t >= 0; --t) {
        float b_next[NS], l_next[NS];
        int d_next = 0;
#pragma unroll
        for (int j = 0; j < NS; ++j) b_next[j] = l_next[j] = NEG;
        if (t > 0) {                      // row t-1's inputs, ahead of the chain
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int s = lane + 32 * j;
                if (s < S) {
                    b_next[j] = pb[(long long)(t - 1) * S + s];
                    l_next[j] = pl[(long long)(t - 1) * S + s];
                }
            }
            d_next = pd[t - 1];
        }
        // blank edge to row t+1, or the terminal blank at the sequence's end
        float bt[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int s = lane + 32 * j;
            const int src = s - d_cur;
            const float got = gather(nxt, src);
            const float shifted = (d_cur >= 0 && d_cur < S && src >= 0) ? got : NEG;
            bt[j] = (t == t_final) ? ((s == s_final) ? b_cur[j] : NEG) : b_cur[j] + shifted;
        }
#pragma unroll
        for (int j = NS - 1; j >= 0; --j) {   // reverse label chain, slots ..32j
            const int k_top = min(S - 2, 32 * j + 30);
            if (j + 1 < NS && 32 * j + 31 <= S - 2) {   // slot 32j+31 from 32j+32
                const float cand = l_cur[j] + __shfl_sync(FULL, bt[min(j + 1, NS - 1)], 0);
                if (lane == 31) bt[j] = lae(bt[j], cand);
            }
            for (int k = k_top; k >= 32 * j; --k) {
                const float cand = l_cur[j] + __shfl_down_sync(FULL, bt[j], 1);
                if (lane + 32 * j == k) bt[j] = lae(bt[j], cand);
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int s = lane + 32 * j;
            if (s < S) po[(long long)t * S + s] = bt[j];
            nxt[j] = bt[j];
            b_cur[j] = b_next[j];
            l_cur[j] = l_next[j];
        }
        d_cur = d_next;
    }
}

// f(std::integral_constant<int, NS>) for the NS = ceil(S / 32) registers a
// lane needs.
template <class F>
int with_slots(int S, F f) {
    switch ((S + 31) / 32) {
        case 1: return f(std::integral_constant<int, 1>{});
        case 2: return f(std::integral_constant<int, 2>{});
        case 3: return f(std::integral_constant<int, 3>{});
        case 4: return f(std::integral_constant<int, 4>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int ttx_band_alpha(const void* lpb, const void* lpl, const void* d, void* alpha,
                   void* work, int B, int T, int S, int n_chunks, void* stream) {
    if (B < 1 || T < 1 || S < 1 || S > BAND_MAX_S || n_chunks < 1)
        return (int)cudaErrorInvalidValue;
    const int P = 32 / seg_width(S), row = 2 * S + 1;
    // C is cut to T, and to the most chunks whose phase B scratch and one
    // staged row a chunk fit the rows launch's 48 KB (the plan stays below)
    int C = std::min(n_chunks, T);
    for (; C > 2; --C) {
        const int cb = P * std::min(ALPHA_C_WARPS, (C - 1 + P - 1) / P);
        if (cb * S + alpha_phase_b_floats(C, S, alpha_group(C)) + cb * row <= SMEM_FLOATS) break;
    }
    return with_slots(S, [&](auto ns) {
        constexpr int NS = decltype(ns)::value;
        const auto st = static_cast<cudaStream_t>(stream);
        const auto* pb = static_cast<const float*>(lpb);
        const auto* pl = static_cast<const float*>(lpl);
        const auto* pd = static_cast<const int*>(d);
        auto* pa = static_cast<float*>(alpha);
        auto* pw = static_cast<float*>(work);
        const int L = (T + C - 1) / C;
        // phase A (at C = 1 the whole sweep): a warp per start slot
        const int kw = C == 1 ? 1 : std::min(S, ALPHA_K_WARPS), slots = std::min(P, C);
        int R = std::min(L, SMEM_FLOATS / (slots * row));
        band_alpha_transfer<NS><<<dim3(B, (C + P - 1) / P, (S + kw - 1) / kw), 32 * kw,
                                  (size_t)slots * R * row * 4, st>>>(pb, pl, pd, pa, pw,
                                                                     T, S, C, R);
        const int err = (int)cudaGetLastError();
        if (err != 0 || C == 1) return err;
        // phases B and C: cb chunks a block
        const int wc = std::min(ALPHA_C_WARPS, (C - 1 + P - 1) / P), cb = P * wc;
        const int H = alpha_group(C), pn = (C - 2) * S * S;
        const int extra = cb * S + alpha_phase_b_floats(C, S, H);
        const bool p_staged = extra + pn + cb * row * L <= SMEM_FLOATS;
        R = std::min(L, (SMEM_FLOATS - extra - (p_staged ? pn : 0)) / (cb * row));
        // programmatic dependent launch: its blocks may start, and stage the
        // rows' inputs, while the transfer launch runs
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(B, (C - 1 + cb - 1) / cb);
        cfg.blockDim = dim3(32 * wc);
        cfg.dynamicSmemBytes = (size_t)(cb * R * row + extra + (p_staged ? pn : 0)) * 4;
        cfg.stream = st;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        return (int)cudaLaunchKernelEx(&cfg, band_alpha_rows<NS>, pb, pl, pd, pa,
                                       static_cast<const float*>(pw), T, S, C, R, H,
                                       (int)p_staged);
    });
}

int ttx_band_beta(const void* lpb, const void* lpl, const void* d,
                  const void* tf, const void* sf, void* beta, int B, int T,
                  int S, void* stream) {
    if (B < 1 || T < 1 || S < 1 || S > BAND_MAX_S) return (int)cudaErrorInvalidValue;
    return with_slots(S, [&](auto ns) {
        band_beta_kernel<decltype(ns)::value><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(lpb), static_cast<const float*>(lpl),
            static_cast<const int*>(d), static_cast<const int*>(tf),
            static_cast<const int*>(sf), static_cast<float*>(beta), T, S);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
