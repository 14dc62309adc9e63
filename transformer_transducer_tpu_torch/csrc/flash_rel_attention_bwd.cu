// Full-context rel-position attention backward for Hopper (sm_90a), fp32
// accuracy on the TF32 tensor cores.
//
// Replaces ops/pallas/flash_rel_attention.py :: flash_rel_attention
// backward (_vjp_bwd, _bwd_kernel) -- ttx_flash_rel_attention_bwd below.
// The score rule and the gradients are those of csrc/rel_attention.cu's
// note: with o = j - i, scale = 1/sqrt(Dh) and the tables sliced to T rows,
//   score(i,j) = scale [ (q_i + u).k_j + BD(i,j) ],
//   BD = q_i.re[T-1+o] + rb[T-1+o] (o <= 0), 0 (o == 1),
//        q_{i+1}.re[o-2] + rb[o-2] (o >= 2);
//   P = exp(score - lse), D_i = dO_i.O_i, dS = P (dO.V^T - D) scale.
//
// Bounds on the card (H100 SXM, 700 W), flagship training batch B = 4,
// T = 410, H = 8, Dh = 64: about 16 Dh FLOP per (i, j) cell, 5.5 GFLOP,
//   * 82 us at 67 TFLOP/s of fp32 FMA (the same fp32-accurate work without
//     tensor cores);
//   * 33 us as 3xTF32 (three TF32 products per product) at 495 TFLOP/s;
// the bytes (q, k, v, dO, O in, dq, dk, dv and the tables out, about 24 MB)
// take 7 us.
//
// Design: templated on the head width Dh (32 or 64; the products below
// are at Dh = 64).  One block of 8 warps per (query tile of TQ = 32 rows,
// head, batch) walks the key chunks of TK = 64 over [0, T).  q + u, q (and the row
// after the tile), dO, the chunk's k and v, and the NE = TQ + TK - 1 table
// rows of the chunk's offsets o = omin + x (omin = j0 - i0 - TQ + 1) sit in
// shared memory.  Every product is a warp-level mma.sync.m16n8k8 TF32 tile
// product with fp32 accumulators; per chunk (M x N x K):
//   d  QE = Q_sel . E^T            32 x 96 x 64  (NE offsets padded to 96)
//   c  S_ac = (Q + u) . K^T        32 x 64 x 64
//      dP = dO . V^T               32 x 64 x 64
//   a  dV += P^T . dO              64 x 64 x 32
//      dK += dS^T . (Q + u)        64 x 64 x 32
//   b  dq_ac += dS . K             32 x 64 x 64
//   e  dq_own += DSk_own . E       32 x 64 x 96
//      dq_next += DSk_next . E     (to row i+1)
//      d re = DSk^T . Q_sel        96 x 64 x 32
// Q_sel is q for the columns x whose offset is <= 0 and the next row's q for
// the others (o == 1 has a zero table row), so the own/next choice is made
// per column of the skewed tile, never per cell.  The BD scores are read
// along diagonals, BD[r][kk] = QE[r][kk - r + TQ - 1]; DSk is dS written
// into that skew, DSk[r][kk - r + TQ - 1] = dS[r][kk]; d rb is DSk's column
// sums and d u the column sums of the tile's dq_ac.
//
// Each fp32 operand is split into its 3xTF32 halves (csrc/tensor_core.cuh,
// which holds the helpers named below) as its fragment is loaded.
//
// Shared tiles are stored with an XOR swizzle of the column by the row's
// low 3 bits (at()), so that a fragment load is free of bank conflicts
// whether its 8 lane groups walk rows and its 4 lanes columns, or the other
// way round (the transposed reads of P, dS, DSk, dO, q, k, E).  A lane's
// fragment rows share their low 3 bits, so each product works out its
// lane's addresses once (RowView, KView): a load adds a constant, and along
// a row one XOR of the 8-deep step's offset.
//
// The chunk's global loads are all issued before the barrier that frees
// the previous chunk's tiles, so their latencies overlap.  TQ stays 32: at
// 64 the query-side tiles double and the block no longer fits twice on an
// SM.
//
// dq stays in registers until the end; dq (whose row i0+TQ the next tile
// shares), dk, dv, d re and d u go out as float4 atomicAdd into buffers the
// caller zeroed (one shuffle pairs two lanes' halves of a row); d rb, whose
// table rows lie H floats apart, goes out as one scalar atomicAdd per
// offset and chunk.
//
// The bf16 form (ttx_flash_rel_attention_bwd_bf16, BF = true) is the same
// kernel at the Pallas backward's rounding points (--bf16 --flash): q, k,
// v, the tables and dO are bf16, widened to fp32 as they are staged; q + u
// is rounded to bf16; the scores and dS divide by sqrt(Dh) in fp32, as JAX
// divides; P and dS are rounded to bf16 as they are written to shared
// memory, so every product (dV, dK, dq, d re, d rb's sums) takes bf16
// operands and runs as one exact TF32 pass (csrc/tensor_core.cuh, ONE)
// where the fp32 form runs three.  D_i must be sum_j P_ij dP_ij with the
// fp32 P (the Pallas kernel's): the caller passes, in place of the output,
// the float32 P's product with v that the bf16 forward keeps beside the
// output of the rounded P (option a of the design: a second accumulator in
// the forward), so D_i = dO_i . sums_i.  The gradients are fp32 sums, cast
// to bf16 by the caller, as JAX casts after its pallas_call.  Its bounds at
// the same shape: the 5.5 GFLOP take 11 us at the TF32 rate as built (one
// pass) and 5.6 us at the bf16 rate; the bf16 inputs halve their bytes.
//
// Plain C interface (loaded with ctypes); the launch runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include "tensor_core.cuh"

namespace {

using namespace ttx;

constexpr int TQ = 32;              // query rows per block
constexpr int TK = 64;              // keys per chunk
constexpr int NE = TQ + TK - 1;     // offsets o in one chunk
constexpr int NX = 96;              // NE padded to 12 tiles of 8
constexpr int NTHREADS = 256;       // 8 warps

// X is the inputs' type: float, or __nv_bfloat16 for the bf16 form
template <class X>
struct Args {
    const X* q;           // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const X* k;
    const X* v;
    long long sq, sk, sv;
    const X* re;          // (T, H, Dh), sliced to T rows
    const X* u;           // r_w_bias (H, Dh)
    const X* rb;          // r_bias (T, H)
    const float* out;     // forward output (B, T, H, Dh); the bf16 form's
                          // float32 P . v sums
    const float* lse;     // forward row log-sum-exp (B, H, T)
    const X* dout;        // dO (B, T, H, Dh)
    float* dq;            // outputs, zeroed by the caller
    float* dk;
    float* dv;
    float* dre;
    float* du;
    float* drb;
    int B, T, H;
};

template <int DH>
struct __align__(16) Smem {
    float qu[TQ * DH];          // q_i + u
    float q[(TQ + 1) * DH];     // q_i; row TQ is q_{i0+TQ}
    float go[TQ * DH];          // dO
    float k[TK * DH];
    float v[TK * DH];
    float e[NX * DH];           // table row of offset omin + x (zero if none)
    float p[TQ * TK];           // probabilities of the chunk
    float ds[TQ * TK];          // score gradients of the chunk
    float qe[TQ * NX];          // QE + rb, then DSk, then the dq rows
    float eb[NX];               // r_bias of offset omin + x
    float di[TQ];               // D_i
    float lse[TQ];
};

template <bool BF>
using ArgsOf = Args<std::conditional_t<BF, __nv_bfloat16, float>>;

template <int DH, bool BF>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_tc(ArgsOf<BF> a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    // dq tiles of 8 dims a warp in products b and e (four column groups),
    // d v / d k tiles in product a (two), d re tiles in product e (four)
    constexpr int NQD = DH / 32, NKD = DH / 16, NRD = DH / 32;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T, H = a.H;
    const float scale = 1.0f / sqrtf((float)DH);
    const float root = sqrtf((float)DH);     // the bf16 form divides, as JAX does
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    // the query tile: q (one row more), q + u, dO; zero past T
    for (int idx = tid; idx < (TQ + 1) * (DH / 4); idx += NTHREADS) {
        const int r = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int i = i0 + r;
        const float4 x = i < T ? ld4(a.q + ((long long)b * T + i) * a.sq + h * DH + d) : zero4;
        st4(&s.q[at(r, d, DH)], x);
        if (r < TQ) {
            const float4 w = ld4(a.u + h * DH + d);
            const float4 qu = make_float4(x.x + w.x, x.y + w.y, x.z + w.z, x.w + w.w);
            st4(&s.qu[at(r, d, DH)], BF ? make_float4(bf16r(qu.x), bf16r(qu.y), bf16r(qu.z),
                                                      bf16r(qu.w))
                                        : qu);
            st4(&s.go[at(r, d, DH)],
                i < T ? ld4(a.dout + (((long long)b * T + i) * H + h) * DH + d) : zero4);
        }
    }
    // D_i = dO_i . O_i over 8 lanes a row, and the row's lse
    {
        const int r = tid >> 3, c = tid & 7, i = i0 + r;
        float di = 0.f;
        if (i < T) {
            const long long row = (((long long)b * T + i) * H + h) * DH + (DH / 8) * c;
#pragma unroll
            for (int x = 0; x < DH / 8; x += 4) {
                const float4 o4 = ld4(a.out + row + x), g4 = ld4(a.dout + row + x);
                di += o4.x * g4.x + o4.y * g4.y + o4.z * g4.z + o4.w * g4.w;
            }
        }
        di += __shfl_xor_sync(FULL, di, 1);
        di += __shfl_xor_sync(FULL, di, 2);
        di += __shfl_xor_sync(FULL, di, 4);
        if (c == 0) {
            s.di[r] = di;
            s.lse[r] = i < T ? a.lse[((long long)b * H + h) * T + i] : 0.f;
        }
    }

    // the warp's tiles: rows m0..m0+15 of the query tile, 16 keys of the
    // scores, DH/4 dims of dq
    const int mq = 16 * (warp & 1);
    const int nq = 16 * (warp >> 1);
    const int nqd = (DH / 4) * (warp >> 1);
    float dq_ac[NQD][4], dq_own[NQD][4], dq_nx[NQD][4];
    zero(dq_ac);
    zero(dq_own);
    zero(dq_nx);
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;

    for (int j0 = 0; j0 < T; j0 += TK) {
        // the chunk's keys, values and table rows (offsets omin + x): every
        // load is issued before the first store and the barrier, so their
        // latencies overlap each other and the previous chunk's last work
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
        const float ebx = eb_row >= 0 ? ldg1(a.rb + eb_row * H + h) : 0.f;
        __syncthreads();   // the previous chunk's tiles are no longer read
#pragma unroll
        for (int n = 0; n < NKV; ++n) {
            const int idx = tid + n * NTHREADS;
            st4(&s.k[at(idx / (DH / 4), 4 * (idx % (DH / 4)), DH)], kx[n]);
            st4(&s.v[at(idx / (DH / 4), 4 * (idx % (DH / 4)), DH)], vx[n]);
        }
#pragma unroll
        for (int n = 0; n < NEX; ++n) {
            const int idx = tid + n * NTHREADS;
            st4(&s.e[at(idx / (DH / 4), 4 * (idx % (DH / 4)), DH)], ex[n]);
        }
        if (tid < NX) s.eb[tid] = ebx;
        __syncthreads();

        // columns x < xs have o <= 0 (own row, q_i); the others o >= 1
        // (next row, q_{i+1}; o == 1 has a zero table row)
        const int xs = 1 - omin;

        // d: QE over the chunk's offsets, plus r_bias; warp: 16 rows x 24 columns
        {
            const int n0 = 24 * (warp >> 1);
            float own[3][4], nx[3][4];
            zero(own);
            zero(nx);
            const RowView<DH> e_rows(s.e, n0);
            if (n0 < xs) warp_mma<DH, BF>(own, RowView<DH>(s.q, mq), e_rows);
            if (n0 + 24 > xs) warp_mma<DH, BF>(nx, RowView<DH>(s.q, mq + 1), e_rows);
#pragma unroll
            for (int j = 0; j < 3; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = c_row(mq, e), x = c_col(n0, j, e);
                    s.qe[at(r, x, NX)] = (x < xs ? own[j][e] : nx[j][e]) + s.eb[x];
                }
        }
        __syncthreads();

        // c: AC scores and dP; warp: 16 rows x 16 keys.  Then P and dS.
        {
            float sac[2][4], dp[2][4];
            zero(sac);
            zero(dp);
            warp_mma<DH, BF>(sac, RowView<DH>(s.qu, mq), RowView<DH>(s.k, nq));
            warp_mma<DH, BF>(dp, RowView<DH>(s.go, mq), RowView<DH>(s.v, nq));
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = c_row(mq, e), kk = c_col(nq, j, e);
                    const bool live = i0 + r < T && j0 + kk < T;
                    const float ac_bd = sac[j][e] + s.qe[at(r, kk - r + TQ - 1, NX)];
                    const float sc = BF ? ac_bd / root : ac_bd * scale;
                    const float p = live ? expf(sc - s.lse[r]) : 0.f;
                    const float pd = p * (dp[j][e] - s.di[r]);
                    // the bf16 form rounds P and dS for every product
                    s.p[at(r, kk, TK)] = BF ? bf16r(p) : p;
                    s.ds[at(r, kk, TK)] = BF ? bf16r(pd / root) : pd * scale;
                }
        }
        __syncthreads();
        // DSk: dS in the skew of the offsets, zero where no key falls; a
        // warp a row
        for (int r = warp; r < TQ; r += NTHREADS / 32)
#pragma unroll
            for (int x = lane; x < NX; x += 32) {
                const int kk = x + r - (TQ - 1);
                s.qe[at(r, x, NX)] = (kk >= 0 && kk < TK) ? s.ds[at(r, kk, TK)] : 0.f;
            }
        __syncthreads();

        // a: dV and dK of the chunk; warp: 16 keys x DH/2 dims
        {
            const int mk = 16 * (warp & 3), nk = (DH / 2) * (warp >> 2);
            auto key_row = [&](float* base) {
                return [=](int kk) -> float* {
                    return j0 + kk < T ? base + (((long long)b * T + j0 + kk) * H + h) * DH
                                       : nullptr;
                };
            };
            float acc[NKD][4];
            zero(acc);
            warp_mma<TQ, BF>(acc, KView<TK, 2>(s.p, mk), KView<DH, NKD>(s.go, nk));
            emit_rows(acc, mk, nk, key_row(a.dv));
            zero(acc);
            warp_mma<TQ, BF>(acc, KView<TK, 2>(s.ds, mk), KView<DH, NKD>(s.qu, nk));
            emit_rows(acc, mk, nk, key_row(a.dk));
        }

        // b: dq's AC part
        warp_mma<TK, BF>(dq_ac, RowView<TK>(s.ds, mq), KView<DH, NQD>(s.k, nqd));

        // e: dq's BD parts from DSk (own columns x = k + t + 4h to row i, the
        // others to row i+1)
        {
            const RowView<NX> dsk(s.qe, mq);
            const KView<DH, NQD> e_cols(s.e, nqd);
            auto own = [&](int k, int hh, int i) {
                return k + t + 4 * hh < xs ? dsk(k, hh, i) : 0.f;
            };
            auto nxt = [&](int k, int hh, int i) {
                return k + t + 4 * hh >= xs ? dsk(k, hh, i) : 0.f;
            };
            warp_mma_range<BF>(dq_own, own, e_cols, 0, min(NX, (max(xs, 0) + 7) & ~7));
            warp_mma_range<BF>(dq_nx, nxt, e_cols, max(0, min(xs, NX) & ~7), NX);
        }

        // e: the table gradients
        {
            // d re = DSk^T . Q_sel; warp: 3 x 16 offsets x DH/4 dims
            auto table_row = [&](int x) -> float* {
                const int row = x < NE ? bd_row(T, omin + x) : -1;
                return row >= 0 ? a.dre + ((long long)row * H + h) * DH : nullptr;
            };
            const int nr = (DH / 4) * (warp & 3);
            const KView<DH, NRD> q_own(s.q, nr), q_next(s.q, nr, 1);
#pragma unroll 1
            for (int m = 0; m < 3; ++m) {
                const int mr = 48 * (warp >> 2) + 16 * m;
                // the offset x of an element is mr + g + 8i
                const KView<NX, 2> dskt(s.qe, mr);
                auto own = [&](int k, int hh, int i) {
                    return mr + g + 8 * i < xs ? dskt(k, hh, i) : 0.f;
                };
                auto nxt = [&](int k, int hh, int i) {
                    return mr + g + 8 * i >= xs ? dskt(k, hh, i) : 0.f;
                };
                float acc[NRD][4];
                zero(acc);
                if (mr < xs) warp_mma<TQ, BF>(acc, own, q_own);
                if (mr + 16 > xs) warp_mma<TQ, BF>(acc, nxt, q_next);
                emit_rows(acc, mr, nr, table_row);
            }
            // d rb: DSk's column sums
            if (tid < NE) {
                const int row = bd_row(T, omin + tid);
                if (row >= 0) {
                    float sum = 0.f;
                    for (int r = 0; r < TQ; ++r) sum += s.qe[at(r, tid, NX)];
                    atomicAdd(a.drb + row * H + h, sum);
                }
            }
        }
    }

    // dq rows: row r gets dq_ac + dq_own, row r+1 dq_nx; d u the column sums
    // of dq_ac.  Staged row-major (unswizzled) in qe and p.
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NQD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = c_row(mq, e), d = c_col(nqd, j, e);
            s.qe[r * DH + d] = dq_ac[j][e] + dq_own[j][e];
            s.p[r * DH + d] = dq_ac[j][e];
        }
    if (tid < DH) s.qe[TQ * DH + tid] = 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NQD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s.qe[(c_row(mq, e) + 1) * DH + c_col(nqd, j, e)] += dq_nx[j][e];
    __syncthreads();
    if (tid < DH / 4) {
        float4 sum = zero4;
        for (int r = 0; r < TQ; ++r) {
            const float4 x = ld4(&s.p[r * DH + 4 * tid]);
            sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
        }
        atomicAdd(reinterpret_cast<float4*>(a.du + h * DH + 4 * tid), sum);
    }
    for (int idx = tid; idx < (TQ + 1) * (DH / 4); idx += NTHREADS) {
        const int r = idx / (DH / 4);
        const int d = 4 * (idx % (DH / 4));
        const int i = i0 + r;
        if (i < T)
            atomicAdd(reinterpret_cast<float4*>(a.dq + (((long long)b * T + i) * H + h) * DH + d),
                      ld4(&s.qe[r * DH + d]));
    }
}

template <bool BF, class X>
int launch(const void* q, const void* k, const void* v, long long sq, long long sk,
           long long sv, const void* re, const void* u, const void* rb, const void* out,
           const void* lse, const void* dout, void* dq, void* dk, void* dv, void* dre,
           void* du, void* drb, int B, int T, int H, int Dh, void* stream) {
    Args<X> a;
    a.q = static_cast<const X*>(q);
    a.k = static_cast<const X*>(k);
    a.v = static_cast<const X*>(v);
    a.sq = sq; a.sk = sk; a.sv = sv;
    a.re = static_cast<const X*>(re);
    a.u = static_cast<const X*>(u);
    a.rb = static_cast<const X*>(rb);
    a.out = static_cast<const float*>(out);
    a.lse = static_cast<const float*>(lse);
    a.dout = static_cast<const X*>(dout);
    a.dq = static_cast<float*>(dq);
    a.dk = static_cast<float*>(dk);
    a.dv = static_cast<float*>(dv);
    a.dre = static_cast<float*>(dre);
    a.du = static_cast<float*>(du);
    a.drb = static_cast<float*>(drb);
    a.B = B; a.T = T; a.H = H;
    return with_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        const int smem = (int)sizeof(Smem<DH>);
        cudaError_t err = cudaFuncSetAttribute(
            flash_bwd_tc<DH, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((T + TQ - 1) / TQ, H, B);
        flash_bwd_tc<DH, BF><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
        return (int)cudaGetLastError();
    });
}

}  // namespace

extern "C" int ttx_flash_rel_attention_bwd(
        const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb,
        const void* out, const void* lse, const void* dout, void* dq, void* dk,
        void* dv, void* dre, void* du, void* drb, int B, int T, int H, int Dh,
        void* stream) {
    return launch<false, float>(q, k, v, sq, sk, sv, re, u, rb, out, lse, dout, dq, dk, dv,
                                dre, du, drb, B, T, H, Dh, stream);
}

// The bf16 form: q, k, v, the tables and dO bf16; out is the forward's
// float32 P . v sums (D_i = dO_i . sums_i = sum_j P_ij dP_ij with the
// float32 P); the gradients float32 sums, cast by the caller.
extern "C" int ttx_flash_rel_attention_bwd_bf16(
        const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb,
        const void* out, const void* lse, const void* dout, void* dq, void* dk,
        void* dv, void* dre, void* du, void* drb, int B, int T, int H, int Dh,
        void* stream) {
    return launch<true, __nv_bfloat16>(q, k, v, sq, sk, sv, re, u, rb, out, lse, dout, dq,
                                       dk, dv, dre, du, drb, B, T, H, Dh, stream);
}
