// Banded rel-position self-attention, forward and backward, for Hopper
// (sm_90a), fp32.
//
// Replaces two TPU kernels of the JAX package:
//   * ops/pallas/banded_attention.py :: banded_attention forward
//     (_fwd_impl, _band_kernel) -- ttx_banded_attention_fwd below;
//   * ops/pallas/banded_attention.py :: banded_attention backward
//     (_bwd_impl, _band_bwd_kernel) -- ttx_banded_attention_bwd below.
// The full-context (flash) kernels, on the tensor cores, are
// csrc/flash_rel_attention_fwd.cu and csrc/flash_rel_attention_bwd.cu.
//
// All four compute one score rule (models/attention.py dense branch), with
// the tables already sliced to T rows, o = j - i and scale = 1/sqrt(Dh):
//
//   score(i,j) = scale * [ (q_i + r_w_bias).k_j + BD(i,j) ]
//   BD(i,j) = q_i.re[T-1+o]     + rb[T-1+o]   if o <= 0
//           = 0                                if o == 1  (rel-shift zero column)
//           = q_{i+1}.re[o-2]   + rb[o-2]      if o >= 2  (cross-row wrap)
//
// then a softmax over j and a product with v.  The banded kernels keep only
// -left <= o <= right; the flash kernels keep every 0 <= j < T.  Tables are
// anchored at the true last row T-1: nothing is padded to a tile multiple.
// At i = T-1 there is no q_{i+1}; that row of the shared q tile is zero,
// and only cells with j >= T+1 (never live) would read it.
//
// The backward recomputes the probabilities from the row log-sum-exp that
// the forward saves (when it is given somewhere to put it), and with
// D_i = sum_d dO_i.O_i and ds = p (dO_i.v_j - D_i) scale accumulates
//   dv_j += p dO_i,  dk_j += ds (q_i + r_w_bias),  dq_i += ds k_j,
//   d r_w_bias = sum_i of the last,
//   o <= 0:  d re[T-1+o] += ds q_i,      dq_i     += ds re[T-1+o],
//   o >= 2:  d re[o-2]   += ds q_{i+1},  dq_{i+1} += ds re[o-2],
//   d rb: the same sums with a ones column in place of q.
//
// Bounds on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 without tensor
// cores):
//   * forward at the flagship serving shape B=8, T=410, H=8, Dh=64, band
//     (left 10, right 2): about 28 MB moved and 0.13 GFLOP, memory-bound,
//     about 8 us.
//   * banded backward at the flagship training batch B=4, band (10, 2):
//     0.17 GFLOP but q, k, v, dO in and dq, dk, dv out, about 23.5 MB,
//     about 7 us (bytes).
//
// Design (simple and exact first; wgmma/TMA tiling is later work), templated
// on the head width Dh (32 or 64):
//   * one block of 256 threads per (query tile of TQ=32 rows, head, batch);
//   * q + r_w_bias, q (and the row after the tile, for the wrap term), a
//     chunk of TK=64 keys/values and the TQ+TK-1 table rows that the
//     chunk's offsets o need sit in shared memory, so the BD term indexes its
//     table row directly (no TPU lane-rolls, no (T, T) scores in memory);
//   * 8 threads per query row, each scoring 8 keys of the chunk and owning
//     Dh/8 output columns (4c..4c+3, then 32 on); the forward carries an
//     online softmax in fp32 (max, sum, Dh/8-wide accumulator) across
//     chunks;
//   * the kernels walk only the key window [i0-left, i0+TQ-1+right] (one
//     chunk at the flagship band);
//   * the backward keeps each query row's dq in registers (the wrap term's
//     share for row i+1 too) and adds it to memory once at the end; dk, dv
//     and the table gradients, which many blocks share, go out per chunk with
//     fp32 atomicAdd into zeroed buffers, so their summation order varies
//     from run to run.
// Shared rows are padded to Dh+4 floats: 16-byte aligned for float4 loads
// and conflict-free across the 8 threads of a row.
//
// Plain C interface (loaded with ctypes).  Kernels run on the caller's
// stream, allocate nothing and return cudaGetLastError() after the launch.

#include "tensor_core.cuh"

namespace {

using namespace ttx;

constexpr int TQ = 32;              // query rows per block
constexpr int TK = 64;              // keys per chunk
constexpr int NTHREADS = 256;       // 8 threads per query row
constexpr int NE = TQ + TK - 1;     // distinct offsets o in one chunk
constexpr int LDP = TK + 1;
constexpr float NEG = -1e30f;

struct Args {
    const float* q;       // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const float* k;
    const float* v;
    long long sq, sk, sv; // row strides (elements between consecutive t)
    const float* re;      // (T, H, Dh) contiguous, sliced to T rows
    const float* u;       // r_w_bias (H, Dh)
    const float* rb;      // r_bias (T, H)
    float* out;           // (B, T, H, Dh) contiguous: written by the forward,
                          // read by the backward
    float* lse;           // (B, H, T) row log-sum-exp, or null (forward only)
    const float* dout;    // backward: dO (B, T, H, Dh) contiguous
    float* dq;            // backward outputs, zeroed by the caller:
    float* dk;            //   dq, dk, dv (B, T, H, Dh)
    float* dv;
    float* dre;           //   (T, H, Dh)
    float* du;            //   (H, Dh)
    float* drb;           //   (T, H)
    int B, T, H;
    int left, right;      // band
};

// Shared rows are padded to Dh+4 floats (LD); a thread's output columns
// come in NC groups of 4: 4c..4c+3, 32+4c.., one group per 32 columns.
template <int DH>
struct Dims {
    static constexpr int LD = DH + 4;
    static constexpr int NC = DH / 32;
};

template <int DH>
struct __align__(16) Smem {
    static constexpr int LD = Dims<DH>::LD;
    float qu[TQ][LD];       // q_i + r_w_bias
    float q[TQ + 1][LD];    // q_i; row TQ holds q_{i0+TQ} for the wrap term
    float k[TK][LD];
    float v[TK][LD];
    float e[NE][LD];        // table row of offset o = omin + x (zero if o == 1)
    float eb[NE];           // r_bias of offset o = omin + x
    float p[TQ][LDP];       // probabilities of the current chunk
};

// float4-read arrays first: each is a multiple of 16 bytes long, so every
// one of them starts 16-byte aligned
template <int DH>
struct __align__(16) SmemBwd {
    static constexpr int LD = Dims<DH>::LD;
    float qu[TQ][LD];
    float q[TQ + 1][LD];
    float k[TK][LD];
    float v[TK][LD];
    float e[NE][LD];
    float go[TQ][LD];       // dO rows of the tile
    float eb[NE];
    float p[TQ][LDP];
    float ds[TQ][LDP];      // score gradients of the current chunk
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void add4(float* p, float4 x) {
    atomicAdd(p, x.x);
    atomicAdd(p + 1, x.y);
    atomicAdd(p + 2, x.z);
    atomicAdd(p + 3, x.w);
}

// The q tile (TQ+1 rows, zero past T) and q + r_w_bias.
template <int DH, class S>
__device__ __forceinline__ void stage_q(const Args& a, S& s, int b, int h, int i0) {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = threadIdx.x; idx < (TQ + 1) * (DH / 4); idx += NTHREADS) {
        const int r = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int i = i0 + r;
        float4 x = zero4;
        if (i < a.T) x = ld4(a.q + ((long long)b * a.T + i) * a.sq + h * DH + d);
        st4(&s.q[r][d], x);
        if (r < TQ) {
            const float4 w = ld4(a.u + h * DH + d);
            st4(&s.qu[r][d], make_float4(x.x + w.x, x.y + w.y, x.z + w.z, x.w + w.w));
        }
    }
}

// Keys and values [j0, j0+TK) (zero from jhi on) and the table rows and
// r_bias of the chunk's offsets o = omin + x, omin = j0 - (i0 + TQ - 1).
template <int DH, class S>
__device__ __forceinline__ void stage_chunk(const Args& a, S& s, int b, int h,
                                            int i0, int j0, int jhi) {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = threadIdx.x; idx < TK * (DH / 4); idx += NTHREADS) {
        const int kk = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int j = j0 + kk;
        float4 kx = zero4, vx = zero4;
        if (j < jhi) {
            kx = ld4(a.k + ((long long)b * a.T + j) * a.sk + h * DH + d);
            vx = ld4(a.v + ((long long)b * a.T + j) * a.sv + h * DH + d);
        }
        st4(&s.k[kk][d], kx);
        st4(&s.v[kk][d], vx);
    }
    const int omin = j0 - (i0 + TQ - 1);
    for (int idx = threadIdx.x; idx < NE * (DH / 4); idx += NTHREADS) {
        const int x = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int row = bd_row(a.T, omin + x);
        float4 ex = zero4;
        if (row >= 0) ex = ld4(a.re + ((long long)row * a.H + h) * DH + d);
        st4(&s.e[x][d], ex);
        if (d == 0) s.eb[x] = row >= 0 ? a.rb[row * a.H + h] : 0.f;
    }
}

// Scaled scores of query row r (sequence row i) against keys c + 8m of the
// staged chunk, and the bit mask of the live cells among them.
template <int DH, class S>
__device__ __forceinline__ unsigned chunk_scores(const Args& a, const S& s,
                                                 int r, int c, int i, int j0,
                                                 int jhi, float sc[8]) {
    const float scale = 1.0f / sqrtf((float)DH);
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
    unsigned live = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        const int kk = c + 8 * m;
        const int o = obase + 8 * m;
        const bool ok = i < a.T && (j0 + kk) < jhi && o >= -a.left && o <= a.right;
        sc[m] = (sc[m] + s.eb[kk - r + TQ - 1]) * scale;
        if (ok) live |= 1u << m;
    }
    return live;
}

__device__ __forceinline__ void key_window(const Args& a, int i0, int* jlo, int* jhi) {
    *jlo = max(0, i0 - a.left);
    *jhi = min(a.T, i0 + TQ + a.right);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
rel_attention_fwd(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    constexpr int NC = Dims<DH>::NC;

    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T;

    stage_q<DH>(a, s, b, h, i0);
    int jlo, jhi;
    key_window(a, i0, &jlo, &jhi);

    const int r = tid >> 3;      // query row within the tile
    const int c = tid & 7;       // this thread's keys: c, c+8, ..., c+56
    const int i = i0 + r;
    float m_run = NEG, l_run = 0.f;
    float acc[4 * NC];
#pragma unroll
    for (int x = 0; x < 4 * NC; ++x) acc[x] = 0.f;

    for (int j0 = jlo; j0 < jhi; j0 += TK) {
        __syncthreads();   // the previous chunk's k, v, e are no longer read
        stage_chunk<DH>(a, s, b, h, i0, j0, jhi);
        __syncthreads();

        float sc[8];
        const unsigned live = chunk_scores<DH>(a, s, r, c, i, j0, jhi, sc);
        float cmax = NEG;
#pragma unroll
        for (int m = 0; m < 8; ++m)
            if (live >> m & 1u) cmax = fmaxf(cmax, sc[m]);
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
        for (int x = 0; x < 4 * NC; ++x) acc[x] *= alpha;
        __syncwarp();   // row r's probabilities come from this warp's lanes

        const int nk = min(TK, jhi - j0);
        for (int kk = 0; kk < nk; ++kk) {
            const float p = s.p[r][kk];
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float4 v4 = ld4(&s.v[kk][32 * n + 4 * c]);
                acc[4 * n] += p * v4.x; acc[4 * n + 1] += p * v4.y;
                acc[4 * n + 2] += p * v4.z; acc[4 * n + 3] += p * v4.w;
            }
        }
    }

    // every live row has its diagonal in range, so l_run > 0
    if (i < T) {
        const float inv = 1.f / l_run;
        float* dst = a.out + (((long long)b * T + i) * a.H + h) * DH;
#pragma unroll
        for (int n = 0; n < NC; ++n)
            st4(dst + 32 * n + 4 * c, make_float4(acc[4 * n] * inv, acc[4 * n + 1] * inv,
                                                  acc[4 * n + 2] * inv, acc[4 * n + 3] * inv));
        if (a.lse != nullptr && c == 0)
            a.lse[((long long)b * a.H + h) * T + i] = m_run + logf(l_run);
    }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
rel_attention_bwd(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    SmemBwd<DH>& s = *reinterpret_cast<SmemBwd<DH>*>(smem_raw);
    constexpr int NC = Dims<DH>::NC;

    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T;
    const int H = a.H;
    const float scale = 1.0f / sqrtf((float)DH);
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    stage_q<DH>(a, s, b, h, i0);
    for (int idx = tid; idx < TQ * (DH / 4); idx += NTHREADS) {
        const int rr = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int ii = i0 + rr;
        st4(&s.go[rr][d], ii < T ? ld4(a.dout + (((long long)b * T + ii) * H + h) * DH + d)
                                 : zero4);
    }
    int jlo, jhi;
    key_window(a, i0, &jlo, &jhi);

    const int r = tid >> 3;      // query row within the tile
    const int c = tid & 7;       // keys c + 8m; dims 4c..4c+3, 32+4c.., ...
    const int i = i0 + r;

    // D_i = dO_i . O_i, reduced over the row's 8 lanes; the row's lse
    float di = 0.f, lse = 0.f;
    if (i < T) {
        const long long row = (((long long)b * T + i) * H + h) * DH;
        di = dot4(ld4(a.out + row + 4 * c), ld4(a.dout + row + 4 * c));
#pragma unroll
        for (int n = 1; n < NC; ++n)
            di += dot4(ld4(a.out + row + 32 * n + 4 * c), ld4(a.dout + row + 32 * n + 4 * c));
        lse = a.lse[((long long)b * H + h) * T + i];
    }
    di += __shfl_xor_sync(FULL, di, 1);
    di += __shfl_xor_sync(FULL, di, 2);
    di += __shfl_xor_sync(FULL, di, 4);

    float dq_ac[4 * NC], dq_own[4 * NC], dq_nx[4 * NC];
#pragma unroll
    for (int x = 0; x < 4 * NC; ++x) dq_ac[x] = dq_own[x] = dq_nx[x] = 0.f;

    for (int j0 = jlo; j0 < jhi; j0 += TK) {
        __syncthreads();   // the previous chunk's tiles are no longer read
        stage_chunk<DH>(a, s, b, h, i0, j0, jhi);
        __syncthreads();

        // probabilities and score gradients of row r against keys c + 8m
        float sc[8], dp[8];
        const unsigned live = chunk_scores<DH>(a, s, r, c, i, j0, jhi, sc);
#pragma unroll
        for (int m = 0; m < 8; ++m) dp[m] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
            const float4 g4 = ld4(&s.go[r][d]);
#pragma unroll
            for (int m = 0; m < 8; ++m) dp[m] += dot4(g4, ld4(&s.v[c + 8 * m][d]));
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const float p = (live >> m & 1u) ? expf(sc[m] - lse) : 0.f;
            s.p[r][c + 8 * m] = p;
            s.ds[r][c + 8 * m] = p * (dp[m] - di) * scale;
        }
        __syncthreads();

        // dq of row r: the AC part and both BD parts (own row, next row)
        const int nk = min(TK, jhi - j0);
        for (int kk = 0; kk < nk; ++kk) {
            const float g = s.ds[r][kk];
            const int x = kk - r + TQ - 1;
            // o <= 0 feeds row i, o >= 2 row i+1; o == 1 has a zero table
            // row, so it adds nothing either way
            const float go_ = (j0 + kk - i <= 0) ? g : 0.f;
            const float gn = g - go_;
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float4 k4 = ld4(&s.k[kk][32 * n + 4 * c]);
                const float4 e4 = ld4(&s.e[x][32 * n + 4 * c]);
                float* ac = dq_ac + 4 * n;
                float* ow = dq_own + 4 * n;
                float* nx = dq_nx + 4 * n;
                ac[0] += g * k4.x; ac[1] += g * k4.y;
                ac[2] += g * k4.z; ac[3] += g * k4.w;
                ow[0] += go_ * e4.x; ow[1] += go_ * e4.y;
                ow[2] += go_ * e4.z; ow[3] += go_ * e4.w;
                nx[0] += gn * e4.x; nx[1] += gn * e4.y;
                nx[2] += gn * e4.z; nx[3] += gn * e4.w;
            }
        }

        // dk and dv of the chunk: thread -> key tid/4, Dh/4 dims
        {
            constexpr int NF = DH / 16;      // float4s a thread
            const int kk = tid >> 2;
            const int d0 = (tid & 3) * (DH / 4);
            float4 gk[NF], gv[NF];
#pragma unroll
            for (int x = 0; x < NF; ++x) gk[x] = gv[x] = zero4;
            for (int rr = 0; rr < TQ; ++rr) {
                const float p = s.p[rr][kk];
                const float g = s.ds[rr][kk];
#pragma unroll
                for (int x = 0; x < NF; ++x) {
                    const float4 o4 = ld4(&s.go[rr][d0 + 4 * x]);
                    const float4 u4 = ld4(&s.qu[rr][d0 + 4 * x]);
                    gv[x].x += p * o4.x; gv[x].y += p * o4.y;
                    gv[x].z += p * o4.z; gv[x].w += p * o4.w;
                    gk[x].x += g * u4.x; gk[x].y += g * u4.y;
                    gk[x].z += g * u4.z; gk[x].w += g * u4.w;
                }
            }
            const int j = j0 + kk;
            if (j < jhi) {
                const long long row = (((long long)b * T + j) * H + h) * DH + d0;
#pragma unroll
                for (int x = 0; x < NF; ++x) {
                    add4(a.dv + row + 4 * x, gv[x]);
                    add4(a.dk + row + 4 * x, gk[x]);
                }
            }
        }

        // table gradients, one diagonal (offset o = omin + x) at a time
        const int omin = j0 - (i0 + TQ - 1);
        for (int idx = tid; idx < NE * (DH / 4); idx += NTHREADS) {
            const int x = idx / (DH / 4);
            const int d = 4 * (idx % (DH / 4));
            const int o = omin + x;
            const int row = bd_row(T, o);
            if (row < 0) continue;
            const int sel = o <= 0 ? 0 : 1;          // q_i or q_{i+1}
            const int rlo = max(0, TQ - 1 - x);
            const int rhi = min(TQ, TK + TQ - 1 - x);
            float4 acc = zero4;
            float accb = 0.f;
            for (int rr = rlo; rr < rhi; ++rr) {
                const float g = s.ds[rr][x - TQ + 1 + rr];
                const float4 q4 = ld4(&s.q[rr + sel][d]);
                acc.x += g * q4.x; acc.y += g * q4.y;
                acc.z += g * q4.z; acc.w += g * q4.w;
                accb += g;
            }
            add4(a.dre + ((long long)row * H + h) * DH + d, acc);
            if (d == 0) atomicAdd(a.drb + row * H + h, accb);
        }
    }

    // dq rows: own row, and the wrap term's share of row i+1
    if (i < T) {
        float* dst = a.dq + (((long long)b * T + i) * H + h) * DH;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const float* ac = dq_ac + 4 * n;
            const float* ow = dq_own + 4 * n;
            add4(dst + 32 * n + 4 * c, make_float4(ac[0] + ow[0], ac[1] + ow[1],
                                                   ac[2] + ow[2], ac[3] + ow[3]));
        }
        if (i + 1 < T) {
            float* nxt = dst + (long long)H * DH;
#pragma unroll
            for (int n = 0; n < NC; ++n)
                add4(nxt + 32 * n + 4 * c, make_float4(dq_nx[4 * n], dq_nx[4 * n + 1],
                                                       dq_nx[4 * n + 2], dq_nx[4 * n + 3]));
        }
    }

    // d r_w_bias: the tile's AC part of dq, summed over its rows
    // (dims 0..31 in s.p, 32..63 in s.ds; rows past T hold zeros)
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        s.p[r][4 * c + x] = dq_ac[x];
        if (NC > 1) s.ds[r][4 * c + x] = dq_ac[4 * (NC - 1) + x];
    }
    __syncthreads();
    if (tid < DH) {
        float sum = 0.f;
        for (int rr = 0; rr < TQ; ++rr)
            sum += tid < 32 ? s.p[rr][tid] : s.ds[rr][tid - 32];
        atomicAdd(a.du + h * DH + tid, sum);
    }
}

template <int DH>
int launch_fwd(const Args& a, cudaStream_t stream) {
    const int smem = (int)sizeof(Smem<DH>);
    cudaError_t err = cudaFuncSetAttribute(
        rel_attention_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.T + TQ - 1) / TQ, a.H, a.B);
    rel_attention_fwd<DH><<<grid, NTHREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd(const Args& a, cudaStream_t stream) {
    const int smem = (int)sizeof(SmemBwd<DH>);
    cudaError_t err = cudaFuncSetAttribute(
        rel_attention_bwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.T + TQ - 1) / TQ, a.H, a.B);
    rel_attention_bwd<DH><<<grid, NTHREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, long long sq,
               long long sk, long long sv, const void* re, const void* u,
               const void* rb, void* out, void* lse, int B, int T, int H,
               int left, int right) {
    Args a = {};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.sq = sq; a.sk = sk; a.sv = sv;
    a.re = static_cast<const float*>(re);
    a.u = static_cast<const float*>(u);
    a.rb = static_cast<const float*>(rb);
    a.out = static_cast<float*>(out);
    a.lse = static_cast<float*>(lse);
    a.B = B; a.T = T; a.H = H;
    a.left = left; a.right = right;
    return a;
}

Args make_bwd_args(const void* q, const void* k, const void* v, long long sq,
                   long long sk, long long sv, const void* re, const void* u,
                   const void* rb, const void* out, const void* lse,
                   const void* dout, void* dq, void* dk, void* dv, void* dre,
                   void* du, void* drb, int B, int T, int H, int left,
                   int right) {
    Args a = make_args(q, k, v, sq, sk, sv, re, u, rb, const_cast<void*>(out),
                       const_cast<void*>(lse), B, T, H, left, right);
    a.dout = static_cast<const float*>(dout);
    a.dq = static_cast<float*>(dq);
    a.dk = static_cast<float*>(dk);
    a.dv = static_cast<float*>(dv);
    a.dre = static_cast<float*>(dre);
    a.du = static_cast<float*>(du);
    a.drb = static_cast<float*>(drb);
    return a;
}

}  // namespace

extern "C" {

// The head widths the attention kernels are built for: writes up to cap of
// them to dims and returns how many there are.
int ttx_attention_head_dims(int* dims, int cap) {
    for (int n = 0; n < N_HEAD_DIMS && n < cap; ++n) dims[n] = HEAD_DIMS[n];
    return N_HEAD_DIMS;
}

int ttx_banded_attention_fwd(const void* q, const void* k, const void* v,
                             long long sq, long long sk, long long sv,
                             const void* re, const void* u, const void* rb,
                             void* out, void* lse, int B, int T, int H, int Dh,
                             int left, int right, void* stream) {
    const Args a = make_args(q, k, v, sq, sk, sv, re, u, rb, out, lse, B, T, H,
                             left, right);
    return with_head_dim(Dh, [&](auto dh) {
        return launch_fwd<decltype(dh)::value>(a, static_cast<cudaStream_t>(stream));
    });
}

int ttx_banded_attention_bwd(const void* q, const void* k, const void* v,
                             long long sq, long long sk, long long sv,
                             const void* re, const void* u, const void* rb,
                             const void* out, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* dre, void* du, void* drb, int B, int T,
                             int H, int Dh, int left, int right, void* stream) {
    const Args a = make_bwd_args(q, k, v, sq, sk, sv, re, u, rb, out, lse, dout,
                                 dq, dk, dv, dre, du, drb, B, T, H, left, right);
    return with_head_dim(Dh, [&](auto dh) {
        return launch_bwd<decltype(dh)::value>(a, static_cast<cudaStream_t>(stream));
    });
}

const char* ttx_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
