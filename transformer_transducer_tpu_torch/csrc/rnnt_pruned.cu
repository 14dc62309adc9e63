// Pruned RNN-T loss kernels for Hopper (sm_90a), fp32.
//
// Replaces three TPU kernels of the JAX package:
//   * ops/pallas/logz_kernel.py :: _logz_pallas (_logz_kernel)
//     -- ttx_additive_logz below;
//   * ops/pallas/band_kernel.py :: band_alpha_pallas (_alpha_kernel)
//     -- ttx_band_alpha below;
//   * ops/pallas/band_kernel.py :: band_beta_pallas (_beta_kernel)
//     -- ttx_band_beta below.
// The wrappers and plain PyTorch versions are ops/cuda/logz_kernel.py and
// ops/cuda/band_kernel.py.  Plain C interface (loaded with ctypes); each
// kernel runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() after the launch.
//
// ---- ttx_additive_logz: logZ[b, t, u] = logsumexp_v(A[b, t, v] + L[b, u, v])
//
// A (B, T, V), L (B, U1, V), out (B, T, U1), all contiguous fp32, U1 <= 64.
// The exact log-sum-exp of every cell: no factorisation into
// exp(A - maxA) @ exp(L - maxL)^T, whose terms underflow to 0 when A[t] and
// L[u] peak on different symbols.
//
// Bound on the card (H100 SXM): at the flagship training shapes (B = 4,
// T = 410, U1 = 43, V = 6485) the inputs are 47 MB, 14 us at 3.35 TB/s, and
// the work is B*T*U1*V = 457 M exponentials, about 0.11 ms at the special
// function units' 16 per SM per clock (132 SMs, 1.98 GHz).  So the
// exponentials bound it, then the adds and maxima beside them (about five
// fp32 operations a cell-column).
//
// Design: one block per (b, tile of LZ_TT = 8 frames) with all U1 label rows.
// The loop over V goes in chunks of LZ_VC = 128 columns; each chunk's A tile
// (8 x 128) and L rows (U1 x 128) are staged in shared memory, pre-scaled by
// log2(e) so the sums use exp2.  A is read from device memory once and L
// once per frame tile (from L2), which is what the TPU kernel keeps out of
// HBM.  Each thread owns a register tile of LZ_RT = 2 frames x LZ_RU = 4
// labels (6 shared loads feed 8 cells) and a quarter of each chunk's
// columns (LZ_NVG = 4 column groups, so a block has 16 * ceil(U1 / 4)
// threads).  Per chunk a thread takes its cells' maximum over its 32 columns,
// rescales its running sum once if that maximum grew, then adds the 32
// exponentials: one exponential per cell-column plus one per chunk.  At the
// end the four column groups' (max, sum) pairs are merged through shared
// memory.  Ragged edges: columns past V read A = NEG (a zero term), frames
// past T are computed and not stored.
//
// ---- ttx_band_alpha / ttx_band_beta: the band DP over T
//
// lp_b, lp_l (B, T, S) fp32, d (B, T) int32, tf, sf (B,) int32, out
// (B, T, S) fp32, S <= 32.  Cell (t, s) is lattice cell (t, rs[t] + s).
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
// time.  What bounds it is the chain of T - 1 = 409 dependent rows, each a
// shuffle for the blank edge and S - 1 dependent shuffle + lae steps for the
// label chain.
//
// Design: one warp per sequence, lane s holding band slot s, so the
// wavefront lives in registers and moves by warp shuffles (no shared memory,
// no barrier).  Each lane loads the next row's lp_b, lp_l and d before it
// works on the current row, so the loads overlap the chain.  The terminal
// (tf, sf) is injected inside the beta sweep, so rows past a sequence's end
// stay near NEG.  No 128-lane padding, row chunks or rolls: those fit the
// TPU's vector unit and VMEM.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int LZ_TT = 8;                  // frames per block
constexpr int LZ_RT = 2;                  // frames per thread
constexpr int LZ_RU = 4;                  // label rows per thread
constexpr int LZ_NTG = LZ_TT / LZ_RT;     // frame groups
constexpr int LZ_NVG = 4;                 // column groups
constexpr int LZ_VC = 128;                // columns per chunk
constexpr int LZ_VPT = LZ_VC / LZ_NVG;    // columns per thread per chunk
constexpr int LZ_MAX_U1 = 64;
constexpr int LZ_STRIDE = LZ_VC + 1;      // padded shared row: no bank conflicts
                                          // between neighbouring rows

constexpr int BAND_MAX_S = 32;

__device__ __forceinline__ float lae(float a, float b) {
    return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__global__ void logz_kernel(const float* __restrict__ A,
                            const float* __restrict__ L,
                            float* __restrict__ out, int T, int U1, int V,
                            int n_ug) {
    __shared__ float tile[(LZ_TT + LZ_MAX_U1) * LZ_STRIDE];
    float* As = tile;
    float* Ls = tile + LZ_TT * LZ_STRIDE;
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * LZ_TT;
    const int tid = threadIdx.x;
    const int n_threads = blockDim.x;
    const int ug = tid % n_ug;
    const int tg = (tid / n_ug) % LZ_NTG;
    const int vg = tid / (n_ug * LZ_NTG);
    const int n_rows = n_ug * LZ_RU;      // label rows staged (>= U1)
    const float* Ab = A + (long long)b * T * V;
    const float* Lb = L + (long long)b * U1 * V;
    // this thread's cells: frames tg + LZ_NTG * i, labels ug + n_ug * k
    // (interleaved, so neighbouring threads read neighbouring rows)
    float m[LZ_RT][LZ_RU], s[LZ_RT][LZ_RU];
#pragma unroll
    for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
        for (int k = 0; k < LZ_RU; ++k) {
            m[i][k] = NEG;
            s[i][k] = 0.f;
        }

    for (int v0 = 0; v0 < V; v0 += LZ_VC) {
        __syncthreads();                  // the previous chunk is consumed
        for (int i = tid; i < LZ_TT * LZ_VC; i += n_threads) {
            const int r = i / LZ_VC, c = i % LZ_VC;
            const int t = t0 + r, v = v0 + c;
            As[r * LZ_STRIDE + c] =
                (t < T && v < V) ? Ab[(long long)t * V + v] * LOG2E : NEG;
        }
        for (int i = tid; i < n_rows * LZ_VC; i += n_threads) {
            const int r = i / LZ_VC, c = i % LZ_VC;
            const int v = v0 + c;
            Ls[r * LZ_STRIDE + c] =
                (r < U1 && v < V) ? Lb[(long long)r * V + v] * LOG2E : 0.f;
        }
        __syncthreads();
        const float* as = As + tg * LZ_STRIDE + vg * LZ_VPT;
        const float* ls = Ls + ug * LZ_STRIDE + vg * LZ_VPT;
        float cm[LZ_RT][LZ_RU];
#pragma unroll
        for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
            for (int k = 0; k < LZ_RU; ++k) cm[i][k] = m[i][k];
#pragma unroll 8
        for (int j = 0; j < LZ_VPT; ++j) {
            float a[LZ_RT], l[LZ_RU];
#pragma unroll
            for (int i = 0; i < LZ_RT; ++i) a[i] = as[i * LZ_NTG * LZ_STRIDE + j];
#pragma unroll
            for (int k = 0; k < LZ_RU; ++k) l[k] = ls[k * n_ug * LZ_STRIDE + j];
#pragma unroll
            for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
                for (int k = 0; k < LZ_RU; ++k) cm[i][k] = fmaxf(cm[i][k], a[i] + l[k]);
        }
#pragma unroll
        for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
            for (int k = 0; k < LZ_RU; ++k)
                if (cm[i][k] > m[i][k]) {
                    s[i][k] *= exp2f(m[i][k] - cm[i][k]);
                    m[i][k] = cm[i][k];
                }
#pragma unroll 8
        for (int j = 0; j < LZ_VPT; ++j) {
            float a[LZ_RT], l[LZ_RU];
#pragma unroll
            for (int i = 0; i < LZ_RT; ++i) a[i] = as[i * LZ_NTG * LZ_STRIDE + j];
#pragma unroll
            for (int k = 0; k < LZ_RU; ++k) l[k] = ls[k * n_ug * LZ_STRIDE + j];
#pragma unroll
            for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
                for (int k = 0; k < LZ_RU; ++k)
                    s[i][k] += exp2f(a[i] + l[k] - m[i][k]);
        }
    }

    // merge the column groups' (max, sum) pairs
    __syncthreads();
    const int n_cells = LZ_TT * n_rows;
    float* red_m = tile;                  // LZ_NVG * n_cells
    float* red_s = tile + LZ_NVG * n_cells;
#pragma unroll
    for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
        for (int k = 0; k < LZ_RU; ++k) {
            const int cell = (tg + LZ_NTG * i) * n_rows + ug + n_ug * k;
            red_m[vg * n_cells + cell] = m[i][k];
            red_s[vg * n_cells + cell] = s[i][k];
        }
    __syncthreads();
    if (vg != 0) return;
#pragma unroll
    for (int i = 0; i < LZ_RT; ++i)
#pragma unroll
        for (int k = 0; k < LZ_RU; ++k) {
            const int t = t0 + tg + LZ_NTG * i, u = ug + n_ug * k;
            const int cell = (tg + LZ_NTG * i) * n_rows + u;
            float mx = red_m[cell];
#pragma unroll
            for (int g = 1; g < LZ_NVG; ++g) mx = fmaxf(mx, red_m[g * n_cells + cell]);
            float sum = 0.f;
#pragma unroll
            for (int g = 0; g < LZ_NVG; ++g)
                sum += red_s[g * n_cells + cell] * exp2f(red_m[g * n_cells + cell] - mx);
            if (t < T && u < U1)
                out[((long long)b * T + t) * U1 + u] = (mx + log2f(sum)) * LN2;
        }
}

__global__ void band_alpha_kernel(const float* __restrict__ lpb,
                                  const float* __restrict__ lpl,
                                  const int* __restrict__ d,
                                  float* __restrict__ alpha, int T, int S) {
    const int s = threadIdx.x;
    const bool live = s < S;
    const long long base = (long long)blockIdx.x * T * S;
    const float* pb = lpb + base;
    const float* pl = lpl + base;
    const int* pd = d + (long long)blockIdx.x * T;
    float* pa = alpha + base;

    float a = (s == 0) ? 0.f : NEG;
    float l_cur = live ? pl[s] : NEG;     // lp_l[t][s]
    float b_prev = NEG;                   // lp_b[t-1][s]
    int d_cur = 0;                        // d[t]
    for (int t = 0; t < T; ++t) {
        float l_next = NEG, b_next = NEG;
        int d_next = 0;
        if (t + 1 < T) {                  // row t+1's inputs, ahead of the chain
            if (live) {
                l_next = pl[(long long)(t + 1) * S + s];
                b_next = pb[(long long)t * S + s];
            }
            d_next = pd[t + 1];
        }
        if (t > 0) {                      // blank edges out of row t-1
            const int src = s + d_cur;
            const float got = __shfl_sync(FULL, a + b_prev, src & 31);
            a = (d_cur >= 0 && d_cur < S && src < S) ? got : NEG;
        }
        for (int k = 1; k < S; ++k) {     // in-row label chain
            const float cand = __shfl_up_sync(FULL, a + l_cur, 1);
            if (s == k) a = lae(a, cand);
        }
        if (live) pa[(long long)t * S + s] = a;
        l_cur = l_next;
        b_prev = b_next;
        d_cur = d_next;
    }
}

__global__ void band_beta_kernel(const float* __restrict__ lpb,
                                 const float* __restrict__ lpl,
                                 const int* __restrict__ d,
                                 const int* __restrict__ tf,
                                 const int* __restrict__ sf,
                                 float* __restrict__ beta, int T, int S) {
    const int s = threadIdx.x;
    const bool live = s < S;
    const long long base = (long long)blockIdx.x * T * S;
    const float* pb = lpb + base;
    const float* pl = lpl + base;
    const int* pd = d + (long long)blockIdx.x * T;
    float* po = beta + base;
    const int t_final = tf[blockIdx.x];
    const int s_final = sf[blockIdx.x];

    float nxt = NEG;                      // beta[t+1][s]
    const long long last = (long long)(T - 1) * S;
    float b_cur = live ? pb[last + s] : NEG;
    float l_cur = live ? pl[last + s] : NEG;
    int d_cur = pd[T - 1];
    for (int t = T - 1; t >= 0; --t) {
        float b_next = NEG, l_next = NEG;
        int d_next = 0;
        if (t > 0) {                      // row t-1's inputs, ahead of the chain
            if (live) {
                b_next = pb[(long long)(t - 1) * S + s];
                l_next = pl[(long long)(t - 1) * S + s];
            }
            d_next = pd[t - 1];
        }
        // blank edge to row t+1, or the terminal blank at the sequence's end
        const int src = s - d_cur;
        const float got = __shfl_sync(FULL, nxt, src & 31);
        const float shifted = (d_cur >= 0 && d_cur < S && src >= 0) ? got : NEG;
        float bt = (t == t_final) ? ((s == s_final) ? b_cur : NEG) : b_cur + shifted;
        for (int k = S - 2; k >= 0; --k) {   // reverse label chain
            const float cand = l_cur + __shfl_down_sync(FULL, bt, 1);
            if (s == k) bt = lae(bt, cand);
        }
        if (live) po[(long long)t * S + s] = bt;
        nxt = bt;
        b_cur = b_next;
        l_cur = l_next;
        d_cur = d_next;
    }
}

}  // namespace

extern "C" {

int ttx_logz_max_u1() { return LZ_MAX_U1; }

int ttx_additive_logz(const void* a, const void* l, void* out, int B, int T,
                      int U1, int V, void* stream) {
    if (B < 1 || T < 1 || U1 < 1 || U1 > LZ_MAX_U1 || V < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const int n_ug = (U1 + LZ_RU - 1) / LZ_RU;
    const dim3 grid((T + LZ_TT - 1) / LZ_TT, B);
    logz_kernel<<<grid, LZ_NTG * n_ug * LZ_NVG, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(l),
        static_cast<float*>(out), T, U1, V, n_ug);
    return (int)cudaGetLastError();
}

int ttx_band_alpha(const void* lpb, const void* lpl, const void* d,
                   void* alpha, int B, int T, int S, void* stream) {
    if (B < 1 || T < 1 || S < 1 || S > BAND_MAX_S) return (int)cudaErrorInvalidValue;
    band_alpha_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lpb), static_cast<const float*>(lpl),
        static_cast<const int*>(d), static_cast<float*>(alpha), T, S);
    return (int)cudaGetLastError();
}

int ttx_band_beta(const void* lpb, const void* lpl, const void* d,
                  const void* tf, const void* sf, void* beta, int B, int T,
                  int S, void* stream) {
    if (B < 1 || T < 1 || S < 1 || S > BAND_MAX_S) return (int)cudaErrorInvalidValue;
    band_beta_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lpb), static_cast<const float*>(lpl),
        static_cast<const int*>(d), static_cast<const int*>(tf),
        static_cast<const int*>(sf), static_cast<float*>(beta), T, S);
    return (int)cudaGetLastError();
}

}  // extern "C"
