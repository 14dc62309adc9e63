// Rel-position self-attention forward for Hopper (sm_90a), fp32.
//
// Replaces two TPU kernels of the JAX package:
//   * ops/pallas/banded_attention.py :: banded_attention forward
//     (_fwd_impl, _band_kernel) -- ttx_banded_attention_fwd below;
//   * ops/pallas/flash_rel_attention.py :: flash_rel_attention forward
//     (_fwd_impl, _fwd_kernel) -- ttx_flash_rel_attention_fwd below.
//
// Both compute one score rule (models/attention.py dense branch), with the
// tables already sliced to T rows, o = j - i and scale = 1/sqrt(Dh):
//
//   score(i,j) = scale * [ (q_i + r_w_bias).k_j + BD(i,j) ]
//   BD(i,j) = q_i.re[T-1+o]     + rb[T-1+o]   if o <= 0
//           = 0                                if o == 1  (rel-shift zero column)
//           = q_{i+1}.re[o-2]   + rb[o-2]      if o >= 2  (cross-row wrap)
//
// then a softmax over j and a product with v.  The banded kernel keeps only
// -left <= o <= right; the flash kernel keeps every 0 <= j < T.  Tables are
// anchored at the true last row T-1: nothing is padded to a tile multiple.
// At i = T-1 there is no q_{i+1}; that row of the shared q tile is zero,
// and only cells with j >= T+1 (never live) would read it.
//
// Bounds on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 without tensor
// cores), at the flagship serving shape B=8, T=410, H=8, Dh=64:
//   * banded (left 10, right 2): about 28 MB moved (q, k, v, out, tables)
//     and 0.13 GFLOP, so memory-bound: about 8 us.
//   * flash: the same 28 MB but 4.1 GFLOP (AC, BD and AV over every (i, j)),
//     so bound by fp32 arithmetic: about 62 us.
//
// Design (simple and exact first; wgmma/TMA tiling is later work):
//   * one block of 256 threads per (query tile of TQ=32 rows, head, batch);
//   * q + r_w_bias, q (and the row after the tile, for the wrap term), a
//     chunk of TK=64 keys/values and the TQ+TK-1 table rows that the
//     chunk's offsets o need sit in shared memory, so the BD term indexes its
//     table row directly (no TPU lane-rolls, no (T, T) scores in memory);
//   * 8 threads per query row, each scoring 8 keys of the chunk; an online
//     softmax in fp32 carries (max, sum, 64-wide accumulator) across chunks;
//   * the banded kernel walks only the key window [i0-left, i0+TQ-1+right]
//     (one chunk at the flagship band), the flash kernel all of [0, T).
// Shared rows are padded to Dh+4 floats: 16-byte aligned for float4 loads
// and conflict-free across the 8 threads of a row.
//
// Plain C interface (loaded with ctypes).  Kernels run on the caller's
// stream, allocate nothing and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int DH = 64;              // head width the kernels take
constexpr int TQ = 32;              // query rows per block
constexpr int TK = 64;              // keys per chunk
constexpr int NTHREADS = 256;       // 8 threads per query row
constexpr int LD = DH + 4;          // padded shared row, in floats
constexpr int NE = TQ + TK - 1;     // distinct offsets o in one chunk
constexpr int LDP = TK + 1;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const float* q;       // q[b, t, h, d] at q + (b*T + t)*sq + h*DH + d
    const float* k;
    const float* v;
    long long sq, sk, sv; // row strides (elements between consecutive t)
    const float* re;      // (T, H, DH) contiguous, sliced to T rows
    const float* u;       // r_w_bias (H, DH)
    const float* rb;      // r_bias (T, H)
    float* out;           // (B, T, H, DH) contiguous
    int B, T, H;
    int left, right;      // band (banded kernel only)
};

struct __align__(16) Smem {
    float qu[TQ][LD];       // q_i + r_w_bias
    float q[TQ + 1][LD];    // q_i; row TQ holds q_{i0+TQ} for the wrap term
    float k[TK][LD];
    float v[TK][LD];
    float e[NE][LD];        // table row of offset o = omin + x (zero if o == 1)
    float eb[NE];           // r_bias of offset o = omin + x
    float p[TQ][LDP];       // probabilities of the current chunk
};

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Table row (or nullptr) and r_bias value that the BD term uses at offset o.
__device__ __forceinline__ const float* bd_row(const Args& a, int h, int o,
                                               float* bias) {
    int row = -1;
    if (o <= 0) {
        row = a.T - 1 + o;
    } else if (o >= 2) {
        row = o - 2;
    }
    if (row < 0 || row >= a.T) {
        *bias = 0.f;
        return nullptr;
    }
    *bias = a.rb[row * a.H + h];
    return a.re + ((long long)row * a.H + h) * DH;
}

template <bool BANDED>
__global__ void __launch_bounds__(NTHREADS)
rel_attention_fwd(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& s = *reinterpret_cast<Smem*>(smem_raw);

    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T;
    const float scale = 1.0f / sqrtf((float)DH);
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    // q tile (TQ+1 rows, zero past T) and q + r_w_bias
    for (int idx = tid; idx < (TQ + 1) * (DH / 4); idx += NTHREADS) {
        const int r = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int i = i0 + r;
        float4 x = zero4;
        if (i < T) x = ld4(a.q + ((long long)b * T + i) * a.sq + h * DH + d);
        st4(&s.q[r][d], x);
        if (r < TQ) {
            const float4 w = ld4(a.u + h * DH + d);
            st4(&s.qu[r][d], make_float4(x.x + w.x, x.y + w.y, x.z + w.z, x.w + w.w));
        }
    }

    int jlo = 0, jhi = T;
    if (BANDED) {
        jlo = max(0, i0 - a.left);
        jhi = min(T, i0 + TQ + a.right);
    }

    const int r = tid >> 3;      // query row within the tile
    const int c = tid & 7;       // this thread's keys: c, c+8, ..., c+56
    const int i = i0 + r;
    float m_run = NEG, l_run = 0.f;
    float acc[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[x] = 0.f;

    for (int j0 = jlo; j0 < jhi; j0 += TK) {
        __syncthreads();   // the previous chunk's k, v, e are no longer read
        for (int idx = tid; idx < TK * (DH / 4); idx += NTHREADS) {
            const int kk = idx / (DH / 4);
            const int d = 4 * (idx % (DH / 4));
            const int j = j0 + kk;
            float4 kx = zero4, vx = zero4;
            if (j < jhi) {
                kx = ld4(a.k + ((long long)b * T + j) * a.sk + h * DH + d);
                vx = ld4(a.v + ((long long)b * T + j) * a.sv + h * DH + d);
            }
            st4(&s.k[kk][d], kx);
            st4(&s.v[kk][d], vx);
        }
        const int omin = j0 - (i0 + TQ - 1);
        for (int idx = tid; idx < NE * (DH / 4); idx += NTHREADS) {
            const int x = idx / (DH / 4);
            const int d = 4 * (idx % (DH / 4));
            float bias;
            const float* row = bd_row(a, h, omin + x, &bias);
            st4(&s.e[x][d], row ? ld4(row + d) : zero4);
            if (d == 0) s.eb[x] = bias;
        }
        __syncthreads();

        // scores of row r against keys c + 8m
        float sc[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) sc[m] = 0.f;
        const int obase = j0 + c - i;            // o of key c
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
            const float4 qu4 = ld4(&s.qu[r][d]);
            const float4 q4 = ld4(&s.q[r][d]);
            const float4 qn4 = ld4(&s.q[r + 1][d]);
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const int kk = c + 8 * m;
                const float4 k4 = ld4(&s.k[kk][d]);
                const float4 e4 = ld4(&s.e[kk - r + TQ - 1][d]);
                const float4 qs = (obase + 8 * m <= 0) ? q4 : qn4;
                sc[m] += dot4(qu4, k4) + dot4(qs, e4);
            }
        }

        float cmax = NEG;
        unsigned live = 0;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int kk = c + 8 * m;
            const int o = obase + 8 * m;
            bool ok = (j0 + kk) < jhi;
            if (BANDED) ok = ok && o >= -a.left && o <= a.right;
            sc[m] = (sc[m] + s.eb[kk - r + TQ - 1]) * scale;
            if (ok) {
                live |= 1u << m;
                cmax = fmaxf(cmax, sc[m]);
            }
        }
        cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 2));
        cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 4));
        const float m_new = fmaxf(m_run, cmax);
        const float alpha = expf(m_run - m_new);
        float psum = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const float p = (live >> m & 1u) ? expf(sc[m] - m_new) : 0.f;
            s.p[r][c + 8 * m] = p;
            psum += p;
        }
        psum += __shfl_xor_sync(FULL, psum, 1);
        psum += __shfl_xor_sync(FULL, psum, 2);
        psum += __shfl_xor_sync(FULL, psum, 4);
        l_run = l_run * alpha + psum;
        m_run = m_new;
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[x] *= alpha;
        __syncwarp();   // row r's probabilities come from this warp's lanes

        const int nk = min(TK, jhi - j0);
        for (int kk = 0; kk < nk; ++kk) {
            const float p = s.p[r][kk];
            const float4 v0 = ld4(&s.v[kk][4 * c]);
            const float4 v1 = ld4(&s.v[kk][32 + 4 * c]);
            acc[0] += p * v0.x; acc[1] += p * v0.y;
            acc[2] += p * v0.z; acc[3] += p * v0.w;
            acc[4] += p * v1.x; acc[5] += p * v1.y;
            acc[6] += p * v1.z; acc[7] += p * v1.w;
        }
    }

    // every live row has its diagonal in range, so l_run > 0
    if (i < T) {
        const float inv = 1.f / l_run;
        float* dst = a.out + (((long long)b * T + i) * a.H + h) * DH;
        st4(dst + 4 * c, make_float4(acc[0] * inv, acc[1] * inv,
                                     acc[2] * inv, acc[3] * inv));
        st4(dst + 32 + 4 * c, make_float4(acc[4] * inv, acc[5] * inv,
                                          acc[6] * inv, acc[7] * inv));
    }
}

template <bool BANDED>
int launch(const Args& a, cudaStream_t stream) {
    const int smem = (int)sizeof(Smem);
    cudaError_t err = cudaFuncSetAttribute(
        rel_attention_fwd<BANDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.T + TQ - 1) / TQ, a.H, a.B);
    rel_attention_fwd<BANDED><<<grid, NTHREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, long long sq,
               long long sk, long long sv, const void* re, const void* u,
               const void* rb, void* out, int B, int T, int H, int left,
               int right) {
    Args a;
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.sq = sq; a.sk = sk; a.sv = sv;
    a.re = static_cast<const float*>(re);
    a.u = static_cast<const float*>(u);
    a.rb = static_cast<const float*>(rb);
    a.out = static_cast<float*>(out);
    a.B = B; a.T = T; a.H = H;
    a.left = left; a.right = right;
    return a;
}

}  // namespace

extern "C" {

int ttx_head_dim() { return DH; }

int ttx_banded_attention_fwd(const void* q, const void* k, const void* v,
                             long long sq, long long sk, long long sv,
                             const void* re, const void* u, const void* rb,
                             void* out, int B, int T, int H, int left,
                             int right, void* stream) {
    return launch<true>(make_args(q, k, v, sq, sk, sv, re, u, rb, out, B, T,
                                  H, left, right),
                        static_cast<cudaStream_t>(stream));
}

int ttx_flash_rel_attention_fwd(const void* q, const void* k, const void* v,
                                long long sq, long long sk, long long sv,
                                const void* re, const void* u, const void* rb,
                                void* out, int B, int T, int H, void* stream) {
    return launch<false>(make_args(q, k, v, sq, sk, sv, re, u, rb, out, B, T,
                                   H, 0, 0),
                         static_cast<cudaStream_t>(stream));
}

const char* ttx_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
