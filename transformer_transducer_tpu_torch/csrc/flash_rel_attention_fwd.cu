// Full-context rel-position attention forward for Hopper (sm_90a), fp32
// accuracy on the TF32 tensor cores.
//
// Replaces ops/pallas/flash_rel_attention.py :: flash_rel_attention
// forward (_fwd_impl, _fwd_kernel) -- ttx_flash_rel_attention_fwd below.
// The score rule is csrc/rel_attention.cu's: with o = j - i, scale =
// 1/sqrt(Dh) and the tables sliced to T rows,
//   score(i,j) = scale [ (q_i + u).k_j + BD(i,j) ],
//   BD = q_i.re[T-1+o] + rb[T-1+o] (o <= 0), 0 (o == 1),
//        q_{i+1}.re[o-2] + rb[o-2] (o >= 2);
// then an online softmax over every key 0 <= j < T and the product with v.
// It writes the output (B, T, H, Dh) and, when given somewhere to put it,
// the row log-sum-exp (B, H, T) that the backward
// (csrc/flash_rel_attention_bwd.cu) reads.
//
// Bounds on the card (H100 SXM, 700 W) at the flagship serving shape B = 8,
// T = 410, H = 8, Dh = 64: 6 Dh FLOP per (i, j) cell, 4.13 GFLOP,
//   * 62 us at 67 TFLOP/s of fp32 FMA (the same fp32-accurate work without
//     tensor cores);
//   * 25 us as 3xTF32 (three TF32 products per product) at 495 TFLOP/s;
// the bytes (q, k, v and the tables in, the output out, about 28 MB) take
// 8 us.
//
// Design: templated on the head width Dh (32 or 64).  One block of NW = 8
// warps per (query tile of TQ = 16 NW = 128 rows, head, batch) walks the key
// chunks of TK = 32 over [0, T); each warp owns 16 query rows and the
// whole chunk, so a row's running max and sum stay inside its warp (its 4
// lanes of a fragment row) and the online softmax works on the accumulator
// fragments.  Every product is a warp-level mma.sync.m16n8k8 TF32 product in
// 3xTF32 (csrc/tensor_core.cuh), per warp and chunk (M x N x K):
//   S_ac = Q . K^T            16 x 32 x Dh
//   QE   = Q_sel . E^T        16 x 48 x Dh  (the warp's 47 skewed columns)
//   O   += P . V              16 x Dh x 32
// The u term of (q + u).k is the per-key u.k_j, summed in fp32 as the chunk
// is staged, so S_ac and QE's own part share one A fragment of q.  Q_sel is
// q_i for the skewed columns x whose offset is <= 0 and q_{i+1} for the
// others (o == 1 has a zero table row): the own/next choice is made per
// column, never per cell.  The warp's QE + rb goes through its own shared
// tile and is read along diagonals, BD[r][kk] = QE[r][kk - r + 15].
//
// Each operand is split into its 3xTF32 halves once: the query tile when the
// block stages it, k, v and the chunk's table rows as they are staged, all
// kept in shared memory as (hi, lo) pairs and read with one 64-bit load an
// element; P, born in the accumulators, is split in registers.  P needs no
// shuffle to become P.V's A fragment: lane 4g + t holds P at keys 2t, 2t+1
// of each 8-key tile, so P.V takes the k order 2t (slot t), 2t+1 (slot t+4)
// and reads V's rows in the same order.
//
// Why TQ = 128 and TK = 32: a block of 8 warps fills an SM's four
// schedulers twice while the split tiles (q 129 rows, k and v 32 rows, the
// table's 160 rows, each Dh pairs) and the warps' QE tiles take 205 KB at
// Dh = 64, under the 227 KB a block may have; a TK of 64 would double the
// table tile and no longer fit.  At T = 410 the grid is 4 x H x B blocks;
// warps whose 16 rows lie past T stage their share and skip the products.
//
// The chunk's global loads are all issued before the barrier that frees
// the previous chunk's tiles, so their latencies overlap.  Shared tiles are
// swizzled (at2(); V by the row's bits 1-2, as P.V reads its rows 2t + h) so
// that every fragment load is free of bank conflicts.
//
// The bf16 form (flash_fwd_bf16, ttx_flash_rel_attention_fwd_bf16) computes
// at the Pallas forward's rounding points (--bf16 --flash): q, k, v and the
// tables are bf16, widened to fp32 as they are staged into fp32 tiles (not
// split: a bf16 value is exact in TF32, so each product is one exact TF32
// pass, csrc/tensor_core.cuh); q + u is rounded to bf16, as JAX adds in
// bf16, so AC takes its own tile qu beside q's (no u . k_j term); the
// scores divide by sqrt(Dh) in fp32.  JAX rounds the normalised P to bf16
// before P.V, which an online softmax cannot do (its P is scaled by a
// running max and sum until the last chunk), so the bf16 form sweeps the
// key chunks twice: the first sweep takes each row's max and sum, the
// second recomputes the same scores, forms P = exp(s - m) / l, rounds it to
// bf16 for O += bf16(P) . V and, when the lse is kept (training), adds the
// rest P - bf16(P) (rounded to TF32) into a second accumulator on the same
// V fragments: O + that is the fp32 P's product with v, which the bf16
// backward needs for D_i = sum_j P_ij dP_ij (the rounded P's output would
// put D off by 2-4e-3 of the gradients' largest magnitudes).  Its bounds
// at the flagship serving shape: 4.13 GFLOP take 8.3 us at the TF32 rate
// as built and 4.2 us at the bf16 rate; the two sweeps do about 1.7x the
// scores' products, one pass each where the fp32 form does three, and the
// bf16 inputs halve their bytes.  The tiles: q (129 rows), qu (128), k, v
// (32), the table's 160 rows, fp32, and the warps' QE tiles: 149 KB at
// Dh = 64.  V's tile is swizzled by the row's bits 1-2 times 8 (atv1), as
// P.V reads its rows 2t + h, so its 32-bit fragment loads are free of bank
// conflicts.
//
// Plain C interface (loaded with ctypes); the launch runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include "tensor_core.cuh"

namespace {

using namespace ttx;

constexpr int NW = 8;                 // warps, 16 query rows each
constexpr int TQ = 16 * NW;           // query rows per block
constexpr int TK = 32;                // keys per chunk
constexpr int NE = TQ + TK - 1;       // offsets o in one chunk
constexpr int NX = NE + 1;            // NE padded to 20 tiles of 8
constexpr int QX = TK + 16;           // a warp's skewed columns (47), padded
constexpr int QW = QX + 8;            // row of a warp's QE tile, in floats
constexpr int NTHREADS = 32 * NW;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
    const float* q;       // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const float* k;
    const float* v;
    long long sq, sk, sv;
    const float* re;      // (T, H, Dh), sliced to T rows
    const float* u;       // r_w_bias (H, Dh)
    const float* rb;      // r_bias (T, H)
    float* out;           // (B, T, H, Dh)
    float* lse;           // (B, H, T) row log-sum-exp, or null
    int B, T, H;
};

template <int DH>
struct __align__(16) Smem {
    float2 q[(TQ + 1) * DH];    // (hi, lo) of q_i; row TQ is q_{i0+TQ}
    float2 k[TK * DH];
    float2 v[TK * DH];
    float2 e[NX * DH];          // table row of offset omin + x (zero if none)
    float qe[NW][16 * QW];      // each warp's QE + rb over its skewed columns
    float eb[NX];               // r_bias of offset omin + x
    float ub[TK];               // u . k_j
};

// V's swizzle: P.V reads rows 2t + h of an 8-row step, whose bits 1-2 (t)
// pick the 8-bank group.
__device__ __forceinline__ int atv(int row, int col, int w) {
    return row * w + (col ^ (((row >> 1) & 3) << 2));
}

// P.V's B operand: rows k + 2t + h (keys), columns n0 + g + 8i (dims).  The
// lane's swizzle is t << 2 for every k, and (8i + g) ^ f = (8i ^ (f & 8)) +
// (g ^ (f & 4)).
template <int W>
struct VView {
    const float2* p[2];
    int s;
    __device__ __forceinline__ VView(const float2* tile) {
        const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
        const int f = t << 2;
        p[0] = tile + (2 * t) * W + (g ^ (f & 4));
        p[1] = tile + (2 * t + 1) * W + (g ^ (f & 4));
        s = f & 8;
    }
    __device__ __forceinline__ float2 operator()(int k, int h, int i) const {
        return p[h][k * W + ((8 * i) ^ s)];
    }
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tc(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    constexpr int NKT = TK / 8, NQT = QX / 8, NOT = DH / 8;   // tiles a warp

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T, H = a.H;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    // the query tile, split: q (one row more), zero past T
    for (int idx = tid; idx < (TQ + 1) * (DH / 4); idx += NTHREADS) {
        const int r = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int i = i0 + r;
        st_split(&s.q[at2(r, d, DH)],
                 i < T ? ldg4(a.q + ((long long)b * T + i) * a.sq + h * DH + d) : zero4);
    }

    // the warp's rows m0..m0+15 of the tile; its skewed columns x0 + xl
    const int m0 = 16 * warp;
    const bool rows_live = i0 + m0 < T;
    const int x0 = TQ - 16 - m0;
    const RowView2<DH> q_own(s.q, m0), q_next(s.q, m0 + 1), k_rows(s.k, 0), e_rows(s.e, x0);
    const VView<DH> v_rows(s.v);
    float* qe = s.qe[warp];
    const float sl2 = LOG2E / sqrtf((float)DH);   // scores in log2 units
    const float4 u4 = ldg4(a.u + h * DH + 4 * (tid % (DH / 4)));

    float o[NOT][4];
    zero(o);
    float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};   // rows g, g + 8

    for (int j0 = 0; j0 < T; j0 += TK) {
        // the chunk's keys, values and table rows (offsets omin + x): every
        // load is issued before the first store and the barrier
        constexpr int NKV = TK * (DH / 4) / NTHREADS;
        constexpr int NEX = NX * (DH / 4) / NTHREADS;
        const int omin = j0 - (i0 + TQ - 1);
        float4 kx[NKV], vx[NKV], ex[NEX];
#pragma unroll
        for (int n = 0; n < NKV; ++n) {
            const int idx = tid + n * NTHREADS;
            const int j = j0 + idx / (DH / 4);
            const int d = 4 * (idx % (DH / 4));
            kx[n] = j < T ? ldg4(a.k + ((long long)b * T + j) * a.sk + h * DH + d) : zero4;
            vx[n] = j < T ? ldg4(a.v + ((long long)b * T + j) * a.sv + h * DH + d) : zero4;
        }
#pragma unroll
        for (int n = 0; n < NEX; ++n) {
            const int idx = tid + n * NTHREADS;
            const int x = idx / (DH / 4);
            const int row = x < NE ? bd_row(T, omin + x) : -1;
            ex[n] = row >= 0 ? ldg4(a.re + ((long long)row * H + h) * DH + 4 * (idx % (DH / 4)))
                             : zero4;
        }
        const int eb_row = tid < NE ? bd_row(T, omin + tid) : -1;
        const float ebx = eb_row >= 0 ? __ldg(a.rb + eb_row * H + h) : 0.f;
        // u . k_j over the DH/4 neighbouring threads that hold key j
        float ukx[NKV];
#pragma unroll
        for (int n = 0; n < NKV; ++n) {
            ukx[n] = u4.x * kx[n].x + u4.y * kx[n].y + u4.z * kx[n].z + u4.w * kx[n].w;
#pragma unroll
            for (int off = 1; off < DH / 4; off *= 2)
                ukx[n] += __shfl_xor_sync(FULL, ukx[n], off);
        }
        __syncthreads();   // the previous chunk's tiles are no longer read
#pragma unroll
        for (int n = 0; n < NKV; ++n) {
            const int idx = tid + n * NTHREADS;
            const int kk = idx / (DH / 4), d = 4 * (idx % (DH / 4));
            st_split(&s.k[at2(kk, d, DH)], kx[n]);
            st_split(&s.v[atv(kk, d, DH)], vx[n]);
            if (d == 0) s.ub[kk] = ukx[n];
        }
#pragma unroll
        for (int n = 0; n < NEX; ++n) {
            const int idx = tid + n * NTHREADS;
            st_split(&s.e[at2(idx / (DH / 4), 4 * (idx % (DH / 4)), DH)], ex[n]);
        }
        if (tid < NX) s.eb[tid] = ebx;
        __syncthreads();
        if (!rows_live) continue;

        // S_ac over the chunk's keys and QE over the warp's skewed columns;
        // columns xl < xs take q_i (o <= 0), the others q_{i+1}
        const int xs = i0 + TQ - j0 - x0;
        const bool any_own = xs > 0, any_next = xs < QX;
        float sac[NKT][4], own[NQT][4], nxt[NQT][4];
        zero(sac);
        zero(own);
        zero(nxt);
#pragma unroll
        for (int k = 0; k < DH; k += 8) {
            unsigned ah[4], al[4], kh[NKT][2], kl[NKT][2], eh[NQT][2], el[NQT][2];
            load_a(q_own, k, ah, al);
            load_b(k_rows, k, kh, kl);
            load_b(e_rows, k, eh, el);
            mma3(sac, ah, al, kh, kl);
            if (any_own) mma3(own, ah, al, eh, el);
            if (any_next) {
                load_a(q_next, k, ah, al);
                mma3(nxt, ah, al, eh, el);
            }
        }
        // QE + rb into the warp's tile (row r, column xl)
#pragma unroll
        for (int j = 0; j < NQT; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int xl = 8 * j + 2 * t;
                const float2 val = make_float2(
                    (xl < xs ? own[j][2 * hr] : nxt[j][2 * hr]) + s.eb[x0 + xl],
                    (xl + 1 < xs ? own[j][2 * hr + 1] : nxt[j][2 * hr + 1]) + s.eb[x0 + xl + 1]);
                *reinterpret_cast<float2*>(&qe[(g + 8 * hr) * QW + xl]) = val;
            }
        __syncwarp();

        // scores (log2 units) and the online softmax, rows g and g + 8
        float cmax[2] = {NEG, NEG};
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = g + 8 * (e >> 1), kk = 8 * j + 2 * t + (e & 1);
                const float x = (sac[j][e] + s.ub[kk] + qe[r * QW + kk - r + 15]) * sl2;
                sac[j][e] = j0 + kk < T ? x : NEG;
                cmax[e >> 1] = fmaxf(cmax[e >> 1], sac[j][e]);
            }
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            cmax[hr] = fmaxf(cmax[hr], __shfl_xor_sync(FULL, cmax[hr], 1));
            cmax[hr] = fmaxf(cmax[hr], __shfl_xor_sync(FULL, cmax[hr], 2));
            // key j0 is live, so the chunk's max is a score
            const float m_new = fmaxf(m_run[hr], cmax[hr]);
            alpha[hr] = exp2f(m_run[hr] - m_new);
            m_run[hr] = m_new;
            l_run[hr] *= alpha[hr];
        }
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sac[j][e] = exp2f(sac[j][e] - m_run[e >> 1]);    // P
                l_run[e >> 1] += sac[j][e];
            }
#pragma unroll
        for (int j = 0; j < NOT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

        // O += P . V, the keys of tile j in the order 2t, 2t+1: A's (g, t),
        // (g+8, t), (g, t+4), (g+8, t+4) are P's elements 0, 2, 1, 3
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
            unsigned ah[4], al[4], vh[NOT][2], vl[NOT][2];
            split(sac[j][0], ah[0], al[0]);
            split(sac[j][2], ah[1], al[1]);
            split(sac[j][1], ah[2], al[2]);
            split(sac[j][3], ah[3], al[3]);
            load_b(v_rows, 8 * j, vh, vl);
            mma3(o, ah, al, vh, vl);
        }
    }

    if (!rows_live) return;
    // the rows' sums over their 4 lanes; every live row has keys, so l > 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float l = l_run[hr];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        const int i = i0 + m0 + g + 8 * hr;
        if (i >= T) continue;
        const float inv = 1.f / l;
        float* dst = a.out + (((long long)b * T + i) * H + h) * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < NOT; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
        if (a.lse != nullptr && t == 0)
            a.lse[((long long)b * H + h) * T + i] = (m_run[hr] + log2f(l)) * LN2;
    }
}

// ---- the bf16 form

struct ArgsBf16 {
    const __nv_bfloat16* q;     // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    long long sq, sk, sv;
    const __nv_bfloat16* re;    // (T, H, Dh), sliced to T rows
    const __nv_bfloat16* u;     // r_w_bias (H, Dh)
    const __nv_bfloat16* rb;    // r_bias (T, H)
    float* out;                 // (B, T, H, Dh): bf16(P) . v
    float* lse;                 // (B, H, T) row log-sum-exp, or null
    float* sums;                // (B, T, H, Dh): the fp32 P . v, or null
    int B, T, H;
};

template <int DH>
struct __align__(16) SmemBf16 {
    float q[(TQ + 1) * DH];     // q_i (bf16 values); row TQ is q_{i0+TQ}
    float qu[TQ * DH];          // bf16(q_i + u)
    float k[TK * DH];
    float v[TK * DH];
    float e[NX * DH];           // table row of offset omin + x (zero if none)
    float qe[NW][16 * QW];      // each warp's QE + rb over its skewed columns
    float eb[NX];               // r_bias of offset omin + x
};

// V's swizzle in an fp32 tile: P.V reads rows 2t + h of an 8-row step, whose
// bits 1-2 (t) pick the 8-bank group.
__device__ __forceinline__ int atv1(int row, int col, int w) {
    return row * w + (col ^ (((row >> 1) & 3) << 3));
}

// P.V's B operand from an fp32 tile: rows k + 2t + h (keys), columns 8i + g
// (dims), at column (8i + g) ^ 8t = 8(i ^ t) + g.
template <int W>
struct VView1 {
    const float* p[2];
    int t;
    __device__ __forceinline__ VView1(const float* tile) {
        const int g = (threadIdx.x & 31) >> 2;
        t = threadIdx.x & 3;
        p[0] = tile + (2 * t) * W + g;
        p[1] = tile + (2 * t + 1) * W + g;
    }
    __device__ __forceinline__ float operator()(int k, int h, int i) const {
        return p[h][k * W + 8 * (i ^ t)];
    }
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_bf16(ArgsBf16 a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    SmemBf16<DH>& s = *reinterpret_cast<SmemBf16<DH>*>(smem_raw);
    constexpr int NKT = TK / 8, NQT = QX / 8, NOT = DH / 8;   // tiles a warp

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T, H = a.H;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    // the query tile: q (one row more) and bf16(q + u), zero past T
    for (int idx = tid; idx < (TQ + 1) * (DH / 4); idx += NTHREADS) {
        const int r = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int i = i0 + r;
        const float4 x = i < T ? ldg4(a.q + ((long long)b * T + i) * a.sq + h * DH + d) : zero4;
        st4(&s.q[at(r, d, DH)], x);
        if (r < TQ) {
            const float4 w = ldg4(a.u + h * DH + d);
            st4(&s.qu[at(r, d, DH)], make_float4(bf16r(x.x + w.x), bf16r(x.y + w.y),
                                                 bf16r(x.z + w.z), bf16r(x.w + w.w)));
        }
    }

    // the warp's rows m0..m0+15 of the tile; its skewed columns x0 + xl
    const int m0 = 16 * warp;
    const bool rows_live = i0 + m0 < T;
    const int x0 = TQ - 16 - m0;
    const RowView<DH> qu_rows(s.qu, m0), q_own(s.q, m0), q_next(s.q, m0 + 1),
        k_rows(s.k, 0), e_rows(s.e, x0);
    const VView1<DH> v_rows(s.v);
    float* qe = s.qe[warp];
    const float root = sqrtf((float)DH);

    // stage chunk j0's keys (and values), table rows and r_bias; every load
    // is issued before the first store and the barrier
    auto stage = [&](int j0, bool with_v) {
        constexpr int NKV = TK * (DH / 4) / NTHREADS;
        constexpr int NEX = NX * (DH / 4) / NTHREADS;
        const int omin = j0 - (i0 + TQ - 1);
        float4 kx[NKV], vx[NKV], ex[NEX];
#pragma unroll
        for (int n = 0; n < NKV; ++n) {
            const int idx = tid + n * NTHREADS;
            const int j = j0 + idx / (DH / 4);
            const int d = 4 * (idx % (DH / 4));
            kx[n] = j < T ? ldg4(a.k + ((long long)b * T + j) * a.sk + h * DH + d) : zero4;
            vx[n] = with_v && j < T ? ldg4(a.v + ((long long)b * T + j) * a.sv + h * DH + d)
                                    : zero4;
        }
#pragma unroll
        for (int n = 0; n < NEX; ++n) {
            const int idx = tid + n * NTHREADS;
            const int x = idx / (DH / 4);
            const int row = x < NE ? bd_row(T, omin + x) : -1;
            ex[n] = row >= 0 ? ldg4(a.re + ((long long)row * H + h) * DH + 4 * (idx % (DH / 4)))
                             : zero4;
        }
        const int eb_row = tid < NE ? bd_row(T, omin + tid) : -1;
        const float ebx = eb_row >= 0 ? ldg1(a.rb + eb_row * H + h) : 0.f;
        __syncthreads();   // the previous chunk's tiles are no longer read
#pragma unroll
        for (int n = 0; n < NKV; ++n) {
            const int idx = tid + n * NTHREADS;
            const int kk = idx / (DH / 4), d = 4 * (idx % (DH / 4));
            st4(&s.k[at(kk, d, DH)], kx[n]);
            if (with_v) st4(&s.v[atv1(kk, d, DH)], vx[n]);
        }
#pragma unroll
        for (int n = 0; n < NEX; ++n) {
            const int idx = tid + n * NTHREADS;
            st4(&s.e[at(idx / (DH / 4), 4 * (idx % (DH / 4)), DH)], ex[n]);
        }
        if (tid < NX) s.eb[tid] = ebx;
        __syncthreads();
    };

    // the warp's scores over chunk j0 (rows g, g + 8 of its 16): S_ac from
    // qu, QE from q (columns xl < xs) or the next row's q, plus r_bias, read
    // along the diagonals; divided by sqrt(Dh); NEG past T
    auto scores = [&](int j0, float (&sc)[NKT][4]) {
        const int xs = i0 + TQ - j0 - x0;
        float own[NQT][4], nxt[NQT][4];
        zero(sc);
        zero(own);
        zero(nxt);
#pragma unroll
        for (int k = 0; k < DH; k += 8) {
            mma_step<true>(sc, qu_rows, k_rows, k);
            if (xs > 0) mma_step<true>(own, q_own, e_rows, k);
            if (xs < QX) mma_step<true>(nxt, q_next, e_rows, k);
        }
#pragma unroll
        for (int j = 0; j < NQT; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int xl = 8 * j + 2 * t;
                const float2 val = make_float2(
                    (xl < xs ? own[j][2 * hr] : nxt[j][2 * hr]) + s.eb[x0 + xl],
                    (xl + 1 < xs ? own[j][2 * hr + 1] : nxt[j][2 * hr + 1]) + s.eb[x0 + xl + 1]);
                *reinterpret_cast<float2*>(&qe[(g + 8 * hr) * QW + xl]) = val;
            }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = g + 8 * (e >> 1), kk = 8 * j + 2 * t + (e & 1);
                const float x = (sc[j][e] + qe[r * QW + kk - r + 15]) / root;
                sc[j][e] = j0 + kk < T ? x : NEG;
            }
        __syncwarp();      // the tile is rewritten by the next chunk's scores
    };

    // sweep 1: each row's max and sum (rows g, g + 8; the sum per lane)
    float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < T; j0 += TK) {
        stage(j0, false);
        if (!rows_live) continue;
        float sc[NKT][4];
        scores(j0, sc);
        float cmax[2] = {NEG, NEG};
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) cmax[e >> 1] = fmaxf(cmax[e >> 1], sc[j][e]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            cmax[hr] = fmaxf(cmax[hr], __shfl_xor_sync(FULL, cmax[hr], 1));
            cmax[hr] = fmaxf(cmax[hr], __shfl_xor_sync(FULL, cmax[hr], 2));
            const float m_new = fmaxf(m_run[hr], cmax[hr]);
            l_run[hr] *= expf(m_run[hr] - m_new);
            m_run[hr] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) l_run[e >> 1] += expf(sc[j][e] - m_run[e >> 1]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l_run[hr] = row_sum(l_run[hr], 4);

    // sweep 2: P = exp(s - m) / l; O += bf16(P) . V and, with the sums,
    // R += tf32(P - bf16(P)) . V.  The keys of tile j in the order 2t, 2t+1:
    // A's (g, t), (g+8, t), (g, t+4), (g+8, t+4) are P's elements 0, 2, 1, 3
    const bool keep = a.sums != nullptr;
    float o[NOT][4], rest[NOT][4];
    zero(o);
    zero(rest);
    for (int j0 = 0; j0 < T; j0 += TK) {
        stage(j0, true);
        if (!rows_live) continue;
        float sc[NKT][4];
        scores(j0, sc);
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
            unsigned pa[4], ra[4], vb[NOT][2];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int e = (x >> 1) | ((x & 1) << 1);     // 0, 2, 1, 3
                const float p = expf(sc[j][e] - m_run[e >> 1]) / l_run[e >> 1];
                const float pb = bf16r(p);
                pa[x] = __float_as_uint(pb);
                ra[x] = tf32(p - pb);
            }
#pragma unroll
            for (int n = 0; n < NOT; ++n) {
                vb[n][0] = __float_as_uint(v_rows(8 * j, 0, n));
                vb[n][1] = __float_as_uint(v_rows(8 * j, 1, n));
            }
#pragma unroll
            for (int n = 0; n < NOT; ++n) mma(o[n], pa, vb[n]);
            if (keep) {
#pragma unroll
                for (int n = 0; n < NOT; ++n) mma(rest[n], ra, vb[n]);
            }
        }
    }

    if (!rows_live) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int i = i0 + m0 + g + 8 * hr;
        if (i >= T) continue;
        const long long row = (((long long)b * T + i) * H + h) * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < NOT; ++j) {
            *reinterpret_cast<float2*>(a.out + row + 8 * j) =
                make_float2(o[j][2 * hr], o[j][2 * hr + 1]);
            if (keep)
                *reinterpret_cast<float2*>(a.sums + row + 8 * j) =
                    make_float2(o[j][2 * hr] + rest[j][2 * hr],
                                o[j][2 * hr + 1] + rest[j][2 * hr + 1]);
        }
        if (a.lse != nullptr && t == 0)
            a.lse[((long long)b * H + h) * T + i] = m_run[hr] + logf(l_run[hr]);
    }
}

}  // namespace

extern "C" int ttx_flash_rel_attention_fwd(
        const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb, void* out,
        void* lse, int B, int T, int H, int Dh, void* stream) {
    Args a;
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
    return with_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        const int smem = (int)sizeof(Smem<DH>);
        cudaError_t err = cudaFuncSetAttribute(
            flash_fwd_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((T + TQ - 1) / TQ, H, B);
        flash_fwd_tc<DH><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
        return (int)cudaGetLastError();
    });
}

// The bf16 form: q, k, v and the tables bf16; out float32; with lse (then
// sums, the float32 P's product with v, too) or without both.
extern "C" int ttx_flash_rel_attention_fwd_bf16(
        const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb, void* out,
        void* lse, void* sums, int B, int T, int H, int Dh, void* stream) {
    ArgsBf16 a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.sq = sq; a.sk = sk; a.sv = sv;
    a.re = static_cast<const __nv_bfloat16*>(re);
    a.u = static_cast<const __nv_bfloat16*>(u);
    a.rb = static_cast<const __nv_bfloat16*>(rb);
    a.out = static_cast<float*>(out);
    a.lse = static_cast<float*>(lse);
    a.sums = static_cast<float*>(sums);
    a.B = B; a.T = T; a.H = H;
    if ((lse == nullptr) != (sums == nullptr)) return (int)cudaErrorInvalidValue;
    return with_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        const int smem = (int)sizeof(SmemBf16<DH>);
        cudaError_t err = cudaFuncSetAttribute(
            flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((T + TQ - 1) / TQ, H, B);
        flash_fwd_bf16<DH><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
        return (int)cudaGetLastError();
    });
}
