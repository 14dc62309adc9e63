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
// stream, allocates nothing (the sweeps' workspace comes from the
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
// Both sweeps run in chunks of their steps, in one code with a direction
// (BETA).  The alpha steps up through rows 0 .. T - 1.  The beta steps down
// through rows tf .. 0 of each sequence, its step u being row tf - u (Steps
// below): below its terminal row it is linear in the log semiring, and row
// tf is a reset, the injection at slot sf, which does not read row tf + 1.
// So step u is M_u (x) the state of step u - 1, M_u the blank edge (the
// alpha's: the shift by d[t], plus lp_b[t-1]; the beta's: the shift by
// -d[t], plus lp_b[t]) followed by the row's label chain (up the slots for
// the alpha, down for the beta).  The n steps of a sequence (T for the
// alpha, tf + 1 for the beta) are cut into C chunks of steps [r0, r1)
// (band_kernel.py::band_alpha_plan picks C from T for both,
// ::band_alpha_chunks the rows: n = C q + rem, the first rem chunks q + 1
// long; where a beta's tf + 1 < C the last chunks are empty, their
// transfer matrices the identity), and:
//   * phase A, parallel over (sequence, chunk, start slot k): chunk c >= 1
//     runs its steps from e_k (0 at slot k, NEG elsewhere) as the state of
//     step r0 - 1, and its end state is column k of its transfer matrix P_c
//     (S x S, to work[b][c][k][s]); chunk 0 runs from the known start (the
//     alpha's row 0 from e_0; the beta's row tf, the injection, from e_sf
//     plus lp_b[tf]), writes its rows and leaves its end state E_0; the
//     beta's rows past tf are written NEG, as the plain sweep leaves them;
//   * phase B, over the chunk boundaries: E_c = max(NEG, P_c (x) E_{c-1}),
//     an S-term log-sum-exp a slot; the clamp keeps a slot no path reaches
//     at NEG, as the row-by-row sweep leaves it.  At S <= 32 in two levels
//     over groups of H boundaries (each group's composite from the unit
//     vectors, in parallel; the groups' end states one after another; the
//     states inside each group, in parallel): about 2 H + (C - 2) / H steps,
//     H near sqrt((C - 2) / 2); one boundary after another beyond;
//   * phase C, parallel over chunks: chunk c >= 1 re-runs its steps from
//     E_{c-1} and writes its rows.
// The chain falls from n rows to 2 ceil(n / C) rows plus phase B's steps
// (band_kernel.py::band_chain); phase A's work grows about S + 1 fold
// (S start vectors a chunk).
// Two launches: band_transfer (phase A; at C = 1 the whole sweep, one warp
// a sequence) and band_rows (phases B and C, a block a group of chunks,
// each block repeating phase B up to its last chunk, so every block reads
// the same E).  The second is a programmatic dependent launch: its blocks
// start while the first runs and stage their rows' inputs, then wait
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
// row's own log-probs, not at that of the log-alpha or log-beta (which
// reach -17600 and -20800 in the card test's inputs at S = 128, T = 410,
// where the row-by-row float32 sweeps drift 1.7x and 0.9x the tolerance
// from float64).  The log-sums are reassociated, so a sweep matches its
// plain version to rounding, not bit for bit; no atomics, the order of
// every sum is fixed, so two launches agree to the bit.  work holds B C S S
// floats.  No 128-lane padding or rolls: those fit the TPU's vector unit
// and VMEM.

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int BAND_MAX_S = 128;

// lae with its exponential and logarithm each one special function unit op:
// absolute error about 3e-7, under an ulp of the values the sweeps add it to
// (kept near 0 by their offsets, see renorm)
__device__ __forceinline__ float lae_sfu(float a, float b) {
    return fmaxf(a, b) + __logf(1.f + __expf(-fabsf(a - b)));
}

// ---- the sweeps in chunks (see the header)

constexpr int K_WARPS = 16;           // start slots a block of the transfer launch
constexpr int C_WARPS = 16;           // warps a block of the rows launch
constexpr int SMEM_FLOATS = 48 * 1024 / 4;

// Boundaries a group of phase B's two levels: the H that minimises its chain
// of 2 H + ceil(n / H) steps over n = C - 2 boundaries
// (band_kernel.py::band_alpha_group).
__host__ __device__ inline int boundary_group(int C) {
    const int n = C - 2;
    int h = 1;
    while (n > 0 && 2 * (h + 1) + (n + h) / (h + 1) < 2 * h + (n + h - 1) / h) ++h;
    return h;
}

// Floats of phase B's scratch in shared memory: the two levels' Q and F at
// one slot a lane, two vectors beyond.
__host__ __device__ inline int phase_b_floats(int C, int S, int H) {
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

// The first step of chunk c: n = C q + rem steps, the first rem chunks q + 1
// long, the others q (band_kernel.py::band_alpha_chunks).
__device__ __forceinline__ int chunk_row(int c, int n, int C) {
    const int q = n / C;
    return c * q + min(c, n - q * C);
}

// The steps of a sweep in one sequence: n of them, step u on row(u).  The
// alpha's are rows 0 .. T - 1; the beta's rows tf .. 0, none where tf lies
// outside [0, T) (the plain sweep then injects nothing: every row NEG).
template <bool BETA>
struct Steps {
    int n, top;
    __device__ int row(int u) const { return BETA ? top - u : u; }
};

template <bool BETA>
__device__ __forceinline__ Steps<BETA> steps_of(const int* tf, int b, int T) {
    if constexpr (BETA) {
        const int f = tf[b];
        return {f >= 0 && f < T ? f + 1 : 0, f};
    } else {
        return {T, 0};
    }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
}

// The staged inputs of nc chunks, R steps each: step i of chunk slot cl holds
// lp_l and d of the step's row t and lp_b of the row its blank edge leaves
// (the alpha's t - 1, the beta's t).
struct Stage {
    float* l;
    float* b;
    int* d;
    int R;
};

__device__ __forceinline__ Stage carve(float* smem, int nc, int R, int S) {
    return {smem, smem + nc * R * S, reinterpret_cast<int*>(smem + 2 * nc * R * S), R};
}

// Copy steps i0 .. i0 + R - 1 of chunks c_lo .. c_lo + nc - 1 into the stage
// (by the whole block; steps past a chunk's end are not copied) and, with
// wait, wait for the copies and the block.
template <bool BETA>
__device__ void stage_rows(const Stage& st, const float* pb, const float* pl,
                           const int* pd, int c_lo, int nc, int i0, Steps<BETA> sw, int C,
                           int S, bool wait = true) {
    const int R = st.R;
    for (int e = threadIdx.x; e < nc * R * S; e += blockDim.x) {
        const int row = e / S, s = e - row * S, cl = row / R;
        const int c = c_lo + cl, u = chunk_row(c, sw.n, C) + i0 + row - cl * R;
        if (u < chunk_row(c + 1, sw.n, C)) {
            const int t = sw.row(u), tb = BETA ? t : t - 1;
            cp_async4(&st.l[e], pl + (long long)t * S + s);
            if (tb >= 0) cp_async4(&st.b[e], pb + (long long)tb * S + s);
        }
    }
    for (int e = threadIdx.x; e < nc * R; e += blockDim.x) {
        const int cl = e / R, c = c_lo + cl, u = chunk_row(c, sw.n, C) + i0 + e - cl * R;
        if (u < chunk_row(c + 1, sw.n, C)) cp_async4(&st.d[e], pd + sw.row(u));
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

// A row's label chain in place, l[] holding its lp_l: the alpha's up the
// slots, c[s] = lae(c[s], c[s-1] + lp_l[s-1]); the beta's down, c[s] =
// lae(c[s], lp_l[s] + c[s+1]).
template <int NS, bool BETA>
__device__ __forceinline__ void label_chain(float (&c)[NS], const float (&l)[NS], int S, int W,
                                            int sub) {
    if (NS == 1) {
        // a scan over the segment's slots: (w, v) = (lp_l of the edge into
        // the slot, the slot's value), each element combined with the one o
        // slots before it along the chain, (w, v) <- (w + w_o, lae_sfu(v,
        // v_o + w)); ceil(log2 S) steps
        const auto back = [&](float x, int o) {
            return BETA ? __shfl_down_sync(FULL, x, o, W) : __shfl_up_sync(FULL, x, o, W);
        };
        float w = BETA ? l[0] : back(l[0], 1), v = c[0];
        for (int o = 1; o < S; o <<= 1) {
            const float wo = back(w, o);
            const float vo = back(v, o);
            if (BETA ? sub + o < S : sub >= o) {
                v = lae_sfu(v, vo + w);
                w += wo;
            }
        }
        c[0] = v;
    } else if (BETA) {
#pragma unroll
        for (int j = NS - 1; j >= 0; --j) {   // the chain slot by slot, slots ..32j
            if (32 * j + 32 < S) {            // slot 32j + 31 from slot 32j + 32
                const float cand = l[j] + __shfl_sync(FULL, c[min(j + 1, NS - 1)], 0);
                if (sub == 31) c[j] = lae_sfu(c[j], cand);
            }
            for (int k = min(S, 32 * j + 32) - 2; k >= 32 * j; --k) {
                const float cand = l[j] + __shfl_down_sync(FULL, c[j], 1);
                if (sub + 32 * j == k) c[j] = lae_sfu(c[j], cand);
            }
        }
    } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {        // the chain slot by slot, slots 32j..
            const int k_end = min(S, 32 * j + 32);
            if (j > 0 && 32 * j < S) {        // slot 32j from slot 32j - 1
                const float cand = __shfl_sync(FULL, c[j - 1] + l[j - 1], 31);
                if (sub == 0) c[j] = lae_sfu(c[j], cand);
            }
            for (int k = max(1, 32 * j + 1); k < k_end; ++k) {
                const float cand = __shfl_up_sync(FULL, c[j] + l[j], 1, W);
                if (sub + 32 * j == k) c[j] = lae_sfu(c[j], cand);
            }
        }
    }
}

// A step of a segment whose state K + a[] holds the step before, on row t,
// from row il of chunk slot cl of the stage.  The alpha's blank edge brings
// slot s + d of the row before with its lp_b, the beta's slot s - d of the
// row after, lp_b of slot s added where it lands; at the first step (first)
// no edge comes in: the alpha keeps its start, the beta adds lp_b to its
// start e_sf (the injection).  Then the row's label chain.  Every lane of
// the warp takes every step (the shuffles); a segment that is not on keeps
// its state.  Writes the row, K + a, to out where given.
template <int NS, bool BETA>
__device__ __forceinline__ void row_step(float (&a)[NS], double K, const Stage& st, int cl,
                                         int il, bool first, int t, bool on, int S, int W,
                                         int sub, float* out) {
    const int idx = cl * st.R + il;
    const int dt = st.d[idx];
    const float* lb = st.b + idx * S;
    const float* ll = st.l + idx * S;
    float x[NS], c[NS], l[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {        // (slots past S read slot S - 1, unused)
        const int s = sub + 32 * j, sc = min(s, S - 1);
        x[j] = s < S ? (BETA ? a[j] : a[j] + lb[sc]) : NEG;
        l[j] = s < S ? ll[sc] : NEG;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {        // blank edges
        const int s = sub + 32 * j, src = BETA ? s - dt : s + dt;
        const float got = gather(x, src, W);
        const bool ok = dt >= 0 && dt < S && (BETA ? src >= 0 : src < S);
        c[j] = first ? a[j] : ok ? got : NEG;
        if (BETA) c[j] = s < S ? c[j] + lb[min(s, S - 1)] : NEG;
    }
    label_chain<NS, BETA>(c, l, S, W, sub);
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
// as the state of the step before it and leaves its end state as column k
// of P_c in work[b][c][k][.]; chunk 0 runs from the known start (segment
// k = 0), writes its rows and leaves its end state E_0 in work[b][0][0][.].
// The beta's blocks also write NEG to their sequence's rows past tf.
template <int NS, bool BETA>
__global__ void band_transfer(const float* __restrict__ lpb, const float* __restrict__ lpl,
                              const int* __restrict__ d, const int* __restrict__ tf,
                              const int* __restrict__ sf, float* __restrict__ out,
                              float* __restrict__ work, int T, int S, int C, int R) {
    extern __shared__ float smem[];
    asm volatile("griddepcontrol.launch_dependents;");
    const int W = seg_width(S), P = 32 / W;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = lane & (W - 1), seg = lane / W;
    const int b = blockIdx.x, c_lo = blockIdx.y * P, nc = min(P, C - c_lo);
    const int c = c_lo + seg, k = blockIdx.z * (blockDim.x >> 5) + warp;
    const bool live = seg < nc && k < S && (c > 0 || k == 0);
    const long long base = (long long)b * T * S;
    const Steps<BETA> sw = steps_of<BETA>(tf, b, T);
    const Stage st = carve(smem, min(P, C), R, S);
    if (BETA) {
        const long long nb = (long long)gridDim.y * gridDim.z * blockDim.x;
        for (long long e = ((long long)blockIdx.y * gridDim.z + blockIdx.z) * blockDim.x +
                           threadIdx.x;
             e < (long long)(T - sw.n) * S; e += nb)
            out[base + (long long)sw.n * S + e] = NEG;
    }

    const int k0 = c > 0 ? k : BETA ? sf[b] : 0;        // the start's slot
    float a[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) a[j] = (sub + 32 * j == k0) ? 0.f : NEG;
    const int r0 = live ? chunk_row(c, sw.n, C) : 0;
    const int n = live ? chunk_row(c + 1, sw.n, C) - r0 : 0;
    const int L = (sw.n + C - 1) / C, cl = min(seg, nc - 1);
    float* o = (live && c == 0) ? out + base : nullptr;
    double K = 0.0;
    for (int i0 = 0; i0 < L; i0 += R) {
        if (i0 > 0) __syncthreads();      // the last tile is read
        stage_rows(st, lpb + base, lpl + base, d + (long long)b * T, c_lo, nc, i0, sw, C, S);
        for (int i = i0; i < min(L, i0 + R); ++i) {
            row_step<NS, BETA>(a, K, st, cl, i - i0, r0 + i == 0, sw.row(r0 + i), i < n, S,
                               W, sub, o);
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
// segment re-runs its chunk from E_{c-1} and writes its rows.  P_c is
// staged in shared memory when it fits (p_staged), else read from work.
template <int NS, bool BETA>
__global__ void band_rows(const float* __restrict__ lpb, const float* __restrict__ lpl,
                          const int* __restrict__ d, const int* __restrict__ tf,
                          float* __restrict__ out, const float* __restrict__ work, int T,
                          int S, int C, int R, int H, int p_staged) {
    extern __shared__ float smem[];
    const int W = seg_width(S), P = 32 / W;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = lane & (W - 1), seg = lane / W;
    const int cb = P * (blockDim.x >> 5);
    const int b = blockIdx.x, c_lo = 1 + blockIdx.y * cb, nc = min(cb, C - c_lo);
    const int c_last = c_lo + nc - 1;
    const long long base = (long long)b * T * S;
    const Steps<BETA> sw = steps_of<BETA>(tf, b, T);
    const float* wp = work + (long long)b * C * S * S;     // [c][k][s]
    const Stage st = carve(smem, cb, R, S);
    float* ends = smem + cb * R * (2 * S + 1);             // E_{c-1} of chunk slot c - c_lo
    float* buf = ends + cb * S;                            // phase B's scratch
    float* pm = buf + phase_b_floats(C, S, H);       // P_1 .. P_{c_last - 1}
    // the rows' inputs first, while the transfer launch may still run; then
    // wait for its P and E_0
    stage_rows(st, lpb + base, lpl + base, d + (long long)b * T, c_lo, nc, 0, sw, C, S, false);
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
    const int r0 = live ? chunk_row(c, sw.n, C) : 0;
    const int n = live ? chunk_row(c + 1, sw.n, C) - r0 : 0;
    const int L = (sw.n + C - 1) / C;
    for (int i0 = 0; i0 < L; i0 += R) {
        if (i0 > 0) {
            __syncthreads();
            stage_rows(st, lpb + base, lpl + base, d + (long long)b * T, c_lo, nc, i0, sw, C, S);
        }
        for (int i = i0; i < min(L, i0 + R); ++i) {
            row_step<NS, BETA>(a, K, st, cl, i - i0, r0 + i == 0, sw.row(r0 + i), i < n, S,
                               W, sub, out + base);
            if (i % RENORM_ROWS == RENORM_ROWS - 1) renorm(a, K, S, W, sub);
        }
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

// Either sweep: phase A, then (C > 1) phases B and C as a dependent launch.
template <bool BETA>
int band_sweep(const void* lpb, const void* lpl, const void* d, const void* tf,
               const void* sf, void* out, void* work, int B, int T, int S, int n_chunks,
               void* stream) {
    if (B < 1 || T < 1 || S < 1 || S > BAND_MAX_S || n_chunks < 1)
        return (int)cudaErrorInvalidValue;
    const int P = 32 / seg_width(S), row = 2 * S + 1;
    // C is cut to T, and to the most chunks whose phase B scratch and one
    // staged row a chunk fit the rows launch's 48 KB (the plan stays below)
    int C = std::min(n_chunks, T);
    for (; C > 2; --C) {
        const int cb = P * std::min(C_WARPS, (C - 1 + P - 1) / P);
        if (cb * S + phase_b_floats(C, S, boundary_group(C)) + cb * row <= SMEM_FLOATS) break;
    }
    return with_slots(S, [&](auto ns) {
        constexpr int NS = decltype(ns)::value;
        const auto st = static_cast<cudaStream_t>(stream);
        const auto* pb = static_cast<const float*>(lpb);
        const auto* pl = static_cast<const float*>(lpl);
        const auto* pd = static_cast<const int*>(d);
        const auto* ptf = static_cast<const int*>(tf);
        auto* po = static_cast<float*>(out);
        auto* pw = static_cast<float*>(work);
        // the longest sequence's steps a chunk (the beta's tf + 1 <= T)
        const int L = (T + C - 1) / C;
        // phase A (at C = 1 the whole sweep): a warp per start slot
        const int kw = C == 1 ? 1 : std::min(S, K_WARPS), slots = std::min(P, C);
        int R = std::min(L, SMEM_FLOATS / (slots * row));
        band_transfer<NS, BETA><<<dim3(B, (C + P - 1) / P, (S + kw - 1) / kw), 32 * kw,
                                  (size_t)slots * R * row * 4, st>>>(
            pb, pl, pd, ptf, static_cast<const int*>(sf), po, pw, T, S, C, R);
        const int err = (int)cudaGetLastError();
        if (err != 0 || C == 1) return err;
        // phases B and C: cb chunks a block
        const int wc = std::min(C_WARPS, (C - 1 + P - 1) / P), cb = P * wc;
        const int H = boundary_group(C), pn = (C - 2) * S * S;
        const int extra = cb * S + phase_b_floats(C, S, H);
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
        return (int)cudaLaunchKernelEx(&cfg, band_rows<NS, BETA>, pb, pl, pd, ptf, po,
                                       static_cast<const float*>(pw), T, S, C, R, H,
                                       (int)p_staged);
    });
}

}  // namespace

extern "C" {

int ttx_band_alpha(const void* lpb, const void* lpl, const void* d, void* alpha,
                   void* work, int B, int T, int S, int n_chunks, void* stream) {
    return band_sweep<false>(lpb, lpl, d, nullptr, nullptr, alpha, work, B, T, S, n_chunks,
                             stream);
}

int ttx_band_beta(const void* lpb, const void* lpl, const void* d, const void* tf,
                  const void* sf, void* beta, void* work, int B, int T, int S, int n_chunks,
                  void* stream) {
    return band_sweep<true>(lpb, lpl, d, tf, sf, beta, work, B, T, S, n_chunks, stream);
}

}  // extern "C"
