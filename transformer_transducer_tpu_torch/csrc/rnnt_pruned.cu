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
// stream, allocates nothing and returns cudaGetLastError() after the launch.
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
// time.  What bounds it is the chain of T - 1 = 409 dependent rows, each a
// shuffle for the blank edge and S - 1 dependent shuffle + lae steps for the
// label chain.
//
// Design: one warp per sequence, lane s holding band slots s, s + 32, ...
// (NS = ceil(S / 32) of them, a template parameter), so the wavefront lives
// in registers and moves by warp shuffles (no shared memory, no barrier).
// The blank edge gathers slot s + d from lane (s + d) % 32: one shuffle of
// each of the NS registers, the right one kept.  The in-row label chain
// steps from slot s - 1 to s by one shuffle up (by lane 31's register j - 1
// into lane 0's register j where it crosses a 32-slot block).  At S <= 32
// (NS = 1) the arithmetic is the single-register kernel's, in its order.
// Each lane loads the next row's lp_b, lp_l and d before it works on the
// current row, so the loads overlap the chain.  The terminal
// (tf, sf) is injected inside the beta sweep, so rows past a sequence's end
// stay near NEG.  No 128-lane padding, row chunks or rolls: those fit the
// TPU's vector unit and VMEM.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int BAND_MAX_S = 128;

__device__ __forceinline__ float lae(float a, float b) {
    return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
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

template <int NS>
__global__ void band_alpha_kernel(const float* __restrict__ lpb,
                                  const float* __restrict__ lpl,
                                  const int* __restrict__ d,
                                  float* __restrict__ alpha, int T, int S) {
    const int lane = threadIdx.x;
    const long long base = (long long)blockIdx.x * T * S;
    const float* pb = lpb + base;
    const float* pl = lpl + base;
    const int* pd = d + (long long)blockIdx.x * T;
    float* pa = alpha + base;

    // register j holds slot lane + 32 j
    float a[NS], l_cur[NS], b_prev[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const int s = lane + 32 * j;
        a[j] = (s == 0) ? 0.f : NEG;
        l_cur[j] = s < S ? pl[s] : NEG;   // lp_l[t][s]
        b_prev[j] = NEG;                  // lp_b[t-1][s]
    }
    int d_cur = 0;                        // d[t]
    for (int t = 0; t < T; ++t) {
        float l_next[NS], b_next[NS];
        int d_next = 0;
#pragma unroll
        for (int j = 0; j < NS; ++j) l_next[j] = b_next[j] = NEG;
        if (t + 1 < T) {                  // row t+1's inputs, ahead of the chain
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int s = lane + 32 * j;
                if (s < S) {
                    l_next[j] = pl[(long long)(t + 1) * S + s];
                    b_next[j] = pb[(long long)t * S + s];
                }
            }
            d_next = pd[t + 1];
        }
        if (t > 0) {                      // blank edges out of row t-1
            float x[NS];
#pragma unroll
            for (int j = 0; j < NS; ++j) x[j] = a[j] + b_prev[j];
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int src = lane + 32 * j + d_cur;
                const float got = gather(x, src);
                a[j] = (d_cur >= 0 && d_cur < S && src < S) ? got : NEG;
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {    // in-row label chain, slots 32j..
            const int k_end = min(S, 32 * j + 32);
            if (j > 0 && 32 * j < S) {    // slot 32j from slot 32j - 1
                const float cand = __shfl_sync(FULL, a[j - 1] + l_cur[j - 1], 31);
                if (lane == 0) a[j] = lae(a[j], cand);
            }
            for (int k = max(1, 32 * j + 1); k < k_end; ++k) {
                const float cand = __shfl_up_sync(FULL, a[j] + l_cur[j], 1);
                if (lane + 32 * j == k) a[j] = lae(a[j], cand);
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int s = lane + 32 * j;
            if (s < S) pa[(long long)t * S + s] = a[j];
            l_cur[j] = l_next[j];
            b_prev[j] = b_next[j];
        }
        d_cur = d_next;
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

int ttx_band_alpha(const void* lpb, const void* lpl, const void* d,
                   void* alpha, int B, int T, int S, void* stream) {
    if (B < 1 || T < 1 || S < 1 || S > BAND_MAX_S) return (int)cudaErrorInvalidValue;
    return with_slots(S, [&](auto ns) {
        band_alpha_kernel<decltype(ns)::value><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(lpb), static_cast<const float*>(lpl),
            static_cast<const int*>(d), static_cast<float*>(alpha), T, S);
        return (int)cudaGetLastError();
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
