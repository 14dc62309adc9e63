// Full-context rel-position attention backward for Hopper (sm_90a): fp32
// accuracy on the TF32 tensor cores, and a bf16 form on the bf16 ones.
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
// The bf16 form (bbw::flash_bwd_bf16 and its two small kernels,
// ttx_flash_rel_attention_bwd_bf16) replaces the same Pallas backward on its
// bf16 path (--bf16 --flash) and computes at its rounding points: q, k, v
// and the tables bf16; q + u rounded to bf16; dO rounded to bf16
// (g.astype(q.dtype)); the scores and dS divided by sqrt(Dh) in fp32; D_i
// = dO_i . sums_i, sums the float32 P's product with v that the bf16
// forward keeps (D_i = sum_j P_ij dP_ij with the fp32 P, the Pallas
// kernel's); P and dS rounded to bf16 before every product (dV, dK, dq,
// d re, d rb's sums); every gradient a complete fp32 sum, cast to bf16 once.
//
// Bounds on the card (H100 SXM, 700 W) at B = 4, T = 410, H = 8, Dh = 64:
// the 5.5 GFLOP take 5.6 us at the bf16 tensor-core rate (989 TFLOP/s),
// 11 us at the TF32 rate; the bf16 inputs and outputs (q, k, v, dO and the
// tables in, the six gradients out) about 12.6 MB, 3.8 us at 3.35 TB/s.
//
// What held the first bf16 form (the fp32 kernel above run on bf16 values,
// 0.2268 ms there, 2.5 % of the bound) back, and what this design does:
//   * Atomics: its query-major blocks added every 64-key chunk's dk and dv
//     (and 95 table rows a chunk) into global memory, about 13x the
//     function's bytes of read-modify-write in L2.  Here a block owns TK =
//     64 keys of one (b, h) and walks the query steps (FlashAttention-2's
//     order): dK and dV sum in registers over every query and leave once,
//     cast to bf16 in the kernel, with plain stores.  dq is the only sum
//     across blocks made every step (float4 reductions, one pass over dq a
//     key tile); the tables' offsets j - i form a window that slides by TQ
//     a step, so d re and d rb sum in a shared ring of three 32-row pieces
//     and each piece leaves once a block, when no later step touches it.
//   * fp32 tiles of widened bf16 and TF32 m16n8k8: operands stay bf16 in
//     shared tiles of 16-byte chunks swizzled by the row (at16), read with
//     ldmatrix (.trans where k runs down the tile), and every product is
//     mma.m16n8k16 .bf16 with fp32 accumulators.  The scores are taken
//     transposed, keys as the M rows (S^T = K . qu^T + BD^T, dP^T = V .
//     dO^T, v's A fragments kept in registers), so P^T and dS^T are born in
//     the accumulators as the A operands of dV += P^T . dO and dK += dS^T
//     . qu and are packed to bf16 in registers.
//   * Loads through registers and five barriers a chunk: the next step's
//     q, qu, dO and table piece are 16-byte cp.async copies (double-
//     buffered, the table in a ring of four 32-row pieces), issued as a
//     step starts, each thread's addresses worked out once; the sums of a
//     step leave after the next step's first barrier, so a step takes
//     three barriers (tiles in, QE ready, dS ready).
//   * The wrapper's 13 extra launches (the cast of dO, six zeroed fp32
//     buffers, six casts): a pre-pass (a block a (t, b)) rounds dO and q + u
//     to bf16, takes D and zeroes the fp32 sums of dq, d re, d u, d rb in
//     the work buffer; a last pass casts those four to bf16.  Three
//     launches in all.
// Tiles: four warps of 16 keys; a step is TQ = 32 query rows, whose 95
// offsets are three 32-row pieces of the rings.  At T 410, B 4, H 8 the
// grid is 7 x 8 x 4 = 224 blocks, two an SM (111,904 shared bytes, 245
// registers, no spill); TQ = 32 keeps the skew's overhead (QE over (TQ +
// TK) / TK of the scores' columns) at 1.5 where 64 would make it 2.  A
// step's products (M x N x K):
//   A  QE = Q_sel . E^T            32 x 96 x Dh  (own/next by column: a
//      tile wholly on one side takes its side, the tile that holds the
//      split both, selected by column)
//   B  S^T = K . qu^T, dP^T        64 x 32 x Dh each; BD^T read along the
//      diagonals of QE; P, dS; dV, dK += 64 x Dh x 32 each; dS^T into its
//      tile (for dq) and into DSk, its skew (the cells outside a step's
//      keys stay zero from the start)
//   C  dq = dS . K + DSk_own . E   32 x Dh x (64 + 96), DSk_next . E to the
//      next row (staged); d re += DSk^T . Q_sel  96 x Dh x 32 into the
//      ring (the 16-row tile that holds the split takes q_{i+1}, and q_i
//      for its own rows in a second product), d rb the same with a ones
//      column
// d u is sum_j (sum_i dS_ij) k_j, once a block.
//
// Measured on the card (NVIDIA H100 80GB HBM3, 700 W; B 4, T 410, H 8, Dh
// 64; tools/time_bwd_bf16_builds.py, the three kernels alone under a CUDA
// graph, two turns): the first build 0.1357, 0.1340 ms (its main kernel
// 0.1031, 0.1019; its casts kernel, whose parameter arrays were indexed at
// run time through local memory, 0.0230; 255 registers, 52 bytes of
// spills); with the pre-pass on 32-bit indices, the sums leaving after the
// next step's first barrier and k's fragments read each step 0.0990,
// 0.0978; with the rings' rows worked out once a tile and dq's BD k-steps
// unrolled with masks, as built here, 0.0964, 0.0939 (main 0.0864, 0.0847,
// pre-pass 0.0044, casts 0.0055).  The main kernel with parts removed:
// the copies 0.0813, 0.0799; the atomics (dq's and the tables') 0.0691,
// 0.0692; d re's products and ring 0.0685, 0.0689; every BD product
// 0.0569, 0.0567, twenty times the tensor-core time of what is left;
// __expf for expf 0.0848, 0.0849, no faster.  Dh 32 takes as long as Dh
// 64: the warps' dependent chains at 8 warps an SM hold the kernel, not
// the tensor cores.
// Plain PyTorch version: ops/cuda/flash_rel_attention.py ::
// flash_bf16_backward_plain.
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

struct Args {
    const float* q;       // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const float* k;
    const float* v;
    long long sq, sk, sv;
    const float* re;      // (T, H, Dh), sliced to T rows
    const float* u;       // r_w_bias (H, Dh)
    const float* rb;      // r_bias (T, H)
    const float* out;     // forward output (B, T, H, Dh)
    const float* lse;     // forward row log-sum-exp (B, H, T)
    const float* dout;    // dO (B, T, H, Dh)
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

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_tc(Args a) {
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
            st4(&s.qu[at(r, d, DH)], qu);
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
            if (n0 < xs) warp_mma<DH>(own, RowView<DH>(s.q, mq), e_rows);
            if (n0 + 24 > xs) warp_mma<DH>(nx, RowView<DH>(s.q, mq + 1), e_rows);
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
            warp_mma<DH>(sac, RowView<DH>(s.qu, mq), RowView<DH>(s.k, nq));
            warp_mma<DH>(dp, RowView<DH>(s.go, mq), RowView<DH>(s.v, nq));
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = c_row(mq, e), kk = c_col(nq, j, e);
                    const bool live = i0 + r < T && j0 + kk < T;
                    const float ac_bd = sac[j][e] + s.qe[at(r, kk - r + TQ - 1, NX)];
                    const float p = live ? expf(ac_bd * scale - s.lse[r]) : 0.f;
                    s.p[at(r, kk, TK)] = p;
                    s.ds[at(r, kk, TK)] = p * (dp[j][e] - s.di[r]) * scale;
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
            warp_mma<TQ>(acc, KView<TK, 2>(s.p, mk), KView<DH, NKD>(s.go, nk));
            emit_rows(acc, mk, nk, key_row(a.dv));
            zero(acc);
            warp_mma<TQ>(acc, KView<TK, 2>(s.ds, mk), KView<DH, NKD>(s.qu, nk));
            emit_rows(acc, mk, nk, key_row(a.dk));
        }

        // b: dq's AC part
        warp_mma<TK>(dq_ac, RowView<TK>(s.ds, mq), KView<DH, NQD>(s.k, nqd));

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
            warp_mma_range(dq_own, own, e_cols, 0, min(NX, (max(xs, 0) + 7) & ~7));
            warp_mma_range(dq_nx, nxt, e_cols, max(0, min(xs, NX) & ~7), NX);
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
                if (mr < xs) warp_mma<TQ>(acc, own, q_own);
                if (mr + 16 > xs) warp_mma<TQ>(acc, nxt, q_next);
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

// ---- the bf16 form (its note: the head of this file)

namespace bbw {

constexpr int NW = 4;                   // warps, 16 keys each
constexpr int TK = 16 * NW;             // keys a block
constexpr int TQ = 32;                  // query rows a step
constexpr int PIECE = TQ;               // offsets a piece of the rings
constexpr int NX = TQ + TK;             // a step's skewed columns (95 offsets, one more)
constexpr int NPW = NX / PIECE;         // pieces a step reads
constexpr int E_SLOTS = NPW + 1;        // the table ring: one piece more, copied meanwhile
constexpr int G_SLOTS = NPW;            // the gradient ring
constexpr int QW = NX + 5;              // row of the QE tile, floats: 2 (QW - 1) = 8 mod 32
constexpr int XW = NX + 8;              // row of DSk, bf16: 13 chunks of 16 bytes
constexpr int NTHREADS = 32 * NW;
static_assert(NX % PIECE == 0 && (E_SLOTS & (E_SLOTS - 1)) == 0 && PIECE == 32,
              "a step's columns are whole pieces; the ring's slots a power of two");

struct Args {
    const __nv_bfloat16* q;     // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    long long sq, sk, sv;
    const __nv_bfloat16* re;    // (T, H, Dh), sliced to T rows
    const __nv_bfloat16* u;     // r_w_bias (H, Dh)
    const __nv_bfloat16* rb;    // r_bias (T, H)
    const float* sums;          // (B, T, H, Dh): the forward's float32 P . v
    const float* lse;           // (B, H, T) row log-sum-exp
    const float* grad;          // (B, T, H, Dh) float32 dO
    __nv_bfloat16* dk;          // (B, T, H, Dh), written once by the key tile's block
    __nv_bfloat16* dv;
    // the work buffer (work_layout)
    float* dq;                  // (B, T, H, Dh) float32 sums, zeroed by the pre-pass
    float* dre;                 // (T, H, Dh)
    float* du;                  // (H, Dh)
    float* drb;                 // (T, H)
    float* d;                   // (B, H, T): D_i = bf16(dO_i) . sums_i
    __nv_bfloat16* qu;          // (B, T, H, Dh): bf16(q + u)
    __nv_bfloat16* go;          // (B, T, H, Dh): bf16(dO)
    int B, T, H;
};

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// The work buffer's floats, each part 16-byte aligned; with w, its parts.
inline long long work_layout(int B, int T, int H, int Dh, float* w, Args* a) {
    const long long rows = (long long)B * T * H * Dh, tab = (long long)T * H * Dh;
    const long long n[7] = {rows, tab, round4((long long)H * Dh), round4((long long)T * H),
                            round4((long long)B * H * T), rows / 2, rows / 2};
    if (a != nullptr) {
        float* p[7];
        for (int i = 0; i < 7; ++i) {
            p[i] = w;
            w += n[i];
        }
        a->dq = p[0]; a->dre = p[1]; a->du = p[2]; a->drb = p[3]; a->d = p[4];
        a->qu = reinterpret_cast<__nv_bfloat16*>(p[5]);
        a->go = reinterpret_cast<__nv_bfloat16*>(p[6]);
    }
    return n[0] + n[1] + n[2] + n[3] + n[4] + n[5] + n[6];
}

// The pre-pass: bf16(q + u), bf16(dO) and D_i = bf16(dO_i) . sums_i of
// every row, and zeros in the float32 sums the main kernel adds to; a
// block takes the H rows of (t, b) = blockIdx, a thread 8 elements (16
// bytes of bf16) of one (blockDim: H Dh / 8 rounded up to whole warps).
template <int DH>
__global__ void __launch_bounds__(1024) prep(Args a) {
    constexpr int L = DH / 8;                     // threads a row
    const int t = blockIdx.x, b = blockIdx.y;
    const int h = threadIdx.x / L, c = threadIdx.x % L;
    const int T = a.T, H = a.H;
    const bool ok = h < H;
    const long long bt = (long long)b * T + t;
    const long long row = bt * H + h;
    float d = 0.f;
    if (ok) {
        const long long e = row * DH + 8 * c;
        const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(a.q + bt * a.sq + h * DH + 8 * c));
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(a.u + h * DH + 8 * c));
        *reinterpret_cast<uint4*>(a.qu + e) = add_bf16x8(x, w);
        const float4 g0 = ldg4(a.grad + e), g1 = ldg4(a.grad + e + 4);
        const float4 s0 = ldg4(a.sums + e), s1 = ldg4(a.sums + e + 4);
        const uint4 gb = make_uint4(pack_bf16(g0.x, g0.y), pack_bf16(g0.z, g0.w),
                                    pack_bf16(g1.x, g1.y), pack_bf16(g1.z, g1.w));
        *reinterpret_cast<uint4*>(a.go + e) = gb;
        d = lo_bf16(gb.x) * s0.x + hi_bf16(gb.x) * s0.y + lo_bf16(gb.y) * s0.z
            + hi_bf16(gb.y) * s0.w + lo_bf16(gb.z) * s1.x + hi_bf16(gb.z) * s1.y
            + lo_bf16(gb.w) * s1.z + hi_bf16(gb.w) * s1.w;
        st4(a.dq + e, zero4);
        st4(a.dq + e + 4, zero4);
        if (b == 0) {
            const long long r = ((long long)t * H + h) * DH + 8 * c;
            st4(a.dre + r, zero4);
            st4(a.dre + r + 4, zero4);
            if (c == 0) a.drb[t * H + h] = 0.f;
            if (t == 0) {
                st4(a.du + h * DH + 8 * c, zero4);
                st4(a.du + h * DH + 8 * c + 4, zero4);
            }
        }
    }
    d = row_sum(d, L);
    if (ok && c == 0) a.d[((long long)b * H + h) * T + t] = d;
}

// The gradients summed across blocks, cast to bf16 once: part blockIdx.y
// of (dq, d re, d u, d rb).
struct Casts {
    const float* src[4];
    __nv_bfloat16* dst[4];
    long long n[4];
};

__global__ void __launch_bounds__(256) finish(Casts c) {
    // constant indices: a parameter array indexed at run time goes
    // through local memory
    const int part = blockIdx.y;
    const float* src = part == 0 ? c.src[0] : part == 1 ? c.src[1] : part == 2 ? c.src[2]
                                                                          : c.src[3];
    __nv_bfloat16* dst = part == 0 ? c.dst[0] : part == 1 ? c.dst[1] : part == 2 ? c.dst[2]
                                                                           : c.dst[3];
    const long long n = part == 0 ? c.n[0] : part == 1 ? c.n[1] : part == 2 ? c.n[2] : c.n[3];
    for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
         i += 4LL * gridDim.x * blockDim.x) {
        if (i + 4 <= n) {
            const float4 x = ld4(src + i);
            *reinterpret_cast<uint2*>(dst + i) =
                make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
        } else {
            for (long long j = i; j < n; ++j) dst[j] = __float2bfloat16_rn(src[j]);
        }
    }
}

// bf16 tiles: rows of DH / 8 16-byte chunks, placed by at16.
template <int DH>
struct __align__(16) Smem {
    static constexpr int NCH = DH / 8;
    static constexpr int GW = DH + 8;           // row of the gradient ring and of dq's
                                                // staged rows, floats
    uint4 k[TK * NCH];                          // the block's keys
    uint4 q[2][(TQ + 1) * NCH];                 // a step's q_i; row TQ is q_{i0+TQ}
    uint4 qu[2][TQ * NCH];                      // bf16(q_i + u)
    uint4 go[2][TQ * NCH];                      // bf16(dO_i)
    uint4 e[E_SLOTS * PIECE * NCH];             // table ring: piece m at slot m mod E_SLOTS
    float eb[E_SLOTS * PIECE];                  // its r_bias
    float lse[2][TQ];                           // a step's row log-sum-exp
    float dd[2][TQ];                            // and D_i
    union {
        uint4 v[TK * NCH];                      // the block's values (read once)
        float qe[TQ * QW];                      // QE + rb over the step's columns
    };
    float stg[(TQ + 1) * GW];                   // dq's next parts, rows 1..TQ
    uint4 dst[TK * TQ / 8];                     // dS^T of the step: key rows of TQ bf16
    __nv_bfloat16 dsk[TQ * XW];                 // DSk[r][kk - r + TQ - 1] = dS[r][kk]
    float gre[G_SLOTS * PIECE * GW];            // d re of the window's pieces
    float grb[G_SLOTS * PIECE];                 // d rb of the same
    float cs[TK];                               // each key's dS summed over the queries
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_bf16(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    constexpr int NCH = Smem<DH>::NCH, GW = Smem<DH>::GW;
    constexpr int NKS = DH / 16;                // k-steps over the head dims
    constexpr int NDT = DH / 8;                 // 8-column tiles over the head dims
    constexpr int NQD = DH / 16;                // dq's tiles a warp (half the dims)
    constexpr int NP = DH / 16;                 // pairs of dim tiles: d re's a warp
    constexpr int MSTRIDE = NW / NP;            // the warps of a pair split d re's m-tiles
    constexpr int NQT = TQ / 8;                 // query tiles of the scores
    constexpr int NXT = NX / 16;                // 16-row tiles of the columns
    constexpr int RPP = NTHREADS / NCH;         // tile rows a pass of the block's copies
    constexpr float ROOT = DH == 64 ? 8.0f : 5.65685424949238019520f;   // sqrt(Dh) in fp32
    static_assert(DH == 32 || DH == 64, "sqrt(Dh) above");
    static_assert(TQ % RPP == 0 && PIECE % RPP == 0 && TK % RPP == 0, "whole passes");

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
    const int j0 = blockIdx.x * TK;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T, H = a.H;
    const int nsteps = (T + TQ - 1) / TQ;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    auto off = [](int row, int c) { return at16<NCH>(row, c) << 4; };   // bytes in a tile

    // copies: this thread's chunk c of tile rows r0 + RPP n, whose swizzle
    // is r0's
    const int r0 = tid / NCH, c0 = tid % NCH;
    const int at0 = at16<NCH>(r0, c0);
    const long long row_bh = (long long)b * T;              // row b T + i of q, k, v
    const __nv_bfloat16* q_src = a.q + row_bh * a.sq + h * DH + 8 * c0;
    const long long qu_at = row_bh * H * DH + h * DH + 8 * c0;  // + i H Dh in qu, go
    // step st's query tile into buffer st & 1: q (one row more), qu, dO;
    // zeros past T
    auto stage_step = [&](int st) {
        const int i0 = st * TQ, buf = st & 1;
#pragma unroll
        for (int n = 0; n < TQ / RPP; ++n) {
            const int i = i0 + r0 + RPP * n, ic = min(i, T - 1);
            cp16(&s.q[buf][at0 + RPP * n * NCH], q_src + ic * a.sq, i < T);
            cp16(&s.qu[buf][at0 + RPP * n * NCH], a.qu + qu_at + (long long)ic * H * DH, i < T);
            cp16(&s.go[buf][at0 + RPP * n * NCH], a.go + qu_at + (long long)ic * H * DH, i < T);
        }
        if (tid < NCH) {        // row TQ
            const int i = i0 + TQ;
            cp16(&s.q[buf][at16<NCH>(TQ, tid)], q_src + min(i, T - 1) * a.sq, i < T);
        }
    };
    // piece m of the rings: offsets origin(m) + p, p < PIECE; the table's
    // rows (zero where none) into slot m mod E_SLOTS
    auto origin = [&](int m) { return j0 - (TQ - 1) - PIECE * m; };
    const __nv_bfloat16* re_src = a.re + h * DH + 8 * c0;
    auto stage_piece = [&](int m) {
        const int slot = m & (E_SLOTS - 1);
#pragma unroll
        for (int n = 0; n < PIECE / RPP; ++n) {
            const int row = bd_row(T, origin(m) + r0 + RPP * n);
            cp16(&s.e[slot * PIECE * NCH + at0 + RPP * n * NCH],
                 re_src + (long long)max(row, 0) * H * DH, row >= 0);
        }
    };
    auto piece_bias = [&](int m, int p) {
        const int row = bd_row(T, origin(m) + p);
        return row >= 0 ? ldg1(a.rb + row * H + h) : 0.f;
    };
    // step st's lse (threads < TQ) and D (threads TQ .. 2 TQ - 1)
    auto row_stat = [&](int st) {
        const int i = st * TQ + (tid & (TQ - 1));
        if (tid >= 2 * TQ || i >= T) return 0.f;
        const long long at = ((long long)b * H + h) * T + i;
        return tid < TQ ? __ldg(a.lse + at) : __ldg(a.d + at);
    };
    auto put_stat = [&](int st, float x) {
        if (tid < TQ) s.lse[st & 1][tid] = x;
        else if (tid < 2 * TQ) s.dd[st & 1][tid - TQ] = x;
    };

    // set-up: keys, values, step 0, pieces 1 - NPW .. 0; zeros in DSk (its
    // cells outside a step's keys are never written) and the gradient rings
#pragma unroll
    for (int n = 0; n < TK / RPP; ++n) {
        const int j = j0 + r0 + RPP * n;
        const long long row = row_bh + min(j, T - 1);
        cp16(&s.k[at0 + RPP * n * NCH], a.k + row * a.sk + h * DH + 8 * c0, j < T);
        cp16(&s.v[at0 + RPP * n * NCH], a.v + row * a.sv + h * DH + 8 * c0, j < T);
    }
    stage_step(0);
#pragma unroll
    for (int m = 1 - NPW; m <= 0; ++m) stage_piece(m);
    cp_commit();
    for (int idx = tid; idx < TQ * XW / 2; idx += NTHREADS)
        reinterpret_cast<unsigned*>(s.dsk)[idx] = 0u;
    for (int idx = tid; idx < G_SLOTS * PIECE * GW; idx += NTHREADS) s.gre[idx] = 0.f;
    if (tid < G_SLOTS * PIECE) s.grb[tid] = 0.f;
    if (tid < NPW * PIECE) {
        const int m = tid / PIECE + 1 - NPW;
        s.eb[(m & (E_SLOTS - 1)) * PIECE + tid % PIECE] = piece_bias(m, tid % PIECE);
    }
    put_stat(0, row_stat(0));
    cp_wait<0>();
    __syncthreads();

    // ldmatrix lanes: an A operand's rows a_row at chunk + a_ch (and a B
    // operand through .trans, k for rows); two B tiles' rows b_row at chunk
    // + b_ch (and an A operand through .trans, k for rows)
    const int a_row = lane & 15, a_ch = lane >> 4;
    const int b_row = (lane & 7) + 8 * (lane >> 4), b_ch = (lane >> 3) & 1;
    // the warp's 16 keys: A fragments of v, once (k's come from its tile)
    const int kw = 16 * warp;
    unsigned vf[NKS][4];
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
        ldsm4(vf[ks], smem_addr(s.v) + off(kw + a_row, 2 * ks + a_ch));
    float dv_acc[NDT][4], dk_acc[NDT][4], cs_acc[2] = {0.f, 0.f};
    zero(dv_acc);
    zero(dk_acc);
    // the warp's rows in QE and dq, its dims in dq, its pair of dim tiles
    // and first m-tile in d re
    const int mq = 16 * (warp & 1), nd = (DH / 2) * (warp >> 1);
    const int pw = warp % NP, mc = warp / NP;
    float acc[NQD][4];          // dq rows i0 + mq.. of a step, until they leave

    // the sums of step st leave (after the next step's first barrier, or
    // after the last step): dq rows i0 + r (r < TQ) get acc and the next
    // parts staged at row r, row i0 + TQ its staged row; then the piece
    // that leaves the window (all three after the last step)
    auto emit_step = [&](int st) {
        const int i0 = st * TQ;
#pragma unroll
        for (int jn = 0; jn < NQD; ++jn)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = mq + g + 8 * hh;
                if (r > 0) {
                    const float2 n2 = *reinterpret_cast<const float2*>(
                        s.stg + r * GW + nd + 8 * jn + 2 * tq);
                    acc[jn][2 * hh] += n2.x;
                    acc[jn][2 * hh + 1] += n2.y;
                }
            }
        emit_rows(acc, mq, nd, [&](int r) -> float* {
            return i0 + r < T ? a.dq + ((row_bh + i0 + r) * H + h) * DH : nullptr;
        });
        if ((warp & 1) && lane < DH / 8 && i0 + TQ < T)
            atomicAdd(reinterpret_cast<float4*>(a.dq + ((row_bh + i0 + TQ) * H + h) * DH + nd
                                                + 4 * lane),
                      ld4(s.stg + TQ * GW + nd + 4 * lane));
        auto emit_piece = [&](int m) {
            const int slot = (m + G_SLOTS) % G_SLOTS;
            for (int idx = tid; idx < PIECE * (DH / 4); idx += NTHREADS) {
                const int p = idx / (DH / 4), c = idx % (DH / 4);
                const int row = bd_row(T, origin(m) + p);
                float* src = s.gre + (slot * PIECE + p) * GW + 4 * c;
                if (row >= 0)
                    atomicAdd(reinterpret_cast<float4*>(
                                  a.dre + ((long long)row * H + h) * DH + 4 * c), ld4(src));
                st4(src, zero4);
            }
            if (tid < PIECE) {
                const int row = bd_row(T, origin(m) + tid);
                float* src = s.grb + slot * PIECE + tid;
                if (row >= 0) atomicAdd(a.drb + row * H + h, *src);
                *src = 0.f;
            }
        };
        emit_piece(st + 1 - NPW);
        if (st + 1 == nsteps)
            for (int m = st + 2 - NPW; m <= st; ++m) emit_piece(m);
    };

    for (int st = 0; st < nsteps; ++st) {
        const int i0 = st * TQ, buf = st & 1;
        // columns x < xs have offsets <= 0 (q_i), the others >= 1 (q_{i+1})
        const int xs = i0 + TQ - j0;
        // the rings' rows of the columns x0 .. x0 + 7 (x0 a multiple of 8):
        // piece st - x0 / PIECE
        auto ring_row = [&](int x0) {
            return ((st - x0 / PIECE) & (E_SLOTS - 1)) * PIECE + x0 % PIECE;
        };
        auto grad_row = [&](int x0) {
            return ((st - x0 / PIECE + G_SLOTS) % G_SLOTS) * PIECE + x0 % PIECE;
        };
        cp_wait<0>();
        __syncthreads();        // step st's tiles are in; step st - 1 is done with every buffer
        float stat = 0.f, bias = 0.f;
        if (st + 1 < nsteps) {  // step st + 1's tiles and piece st + 1 meanwhile
            stage_step(st + 1);
            stage_piece(st + 1);
            cp_commit();
            stat = row_stat(st + 1);
            if (tid >= 2 * TQ && tid < 3 * TQ) bias = piece_bias(st + 1, tid - 2 * TQ);
        }
        if (st > 0) emit_step(st - 1);

        // A: QE + rb over the step's columns; warp: rows mq.., 48 columns
        // from xq, q_i where the offset is <= 0 and q_{i+1} from xs on (a
        // tile wholly on one side takes its side; the tile that holds xs
        // takes q_{i+1} and, in mix, q_i)
        {
            const int xq = 48 * (warp >> 1), rel = xs - xq;
            const int jm = min(max(rel, 0) >> 3, 5);
            const unsigned q_rows = smem_addr(s.q[buf]);
            int erow[3];
#pragma unroll
            for (int cp = 0; cp < 3; ++cp) erow[cp] = ring_row(xq + 16 * cp) + b_row;
            float acc[6][4], mix[4] = {0.f, 0.f, 0.f, 0.f};
            zero(acc);
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks) {
                unsigned qo[4], qn[4], bb[6][2];
                ldsm4(qo, q_rows + off(mq + a_row, 2 * ks + a_ch));
                ldsm4(qn, q_rows + off(mq + a_row + 1, 2 * ks + a_ch));
#pragma unroll
                for (int cp = 0; cp < 3; ++cp) {
                    unsigned e4[4];
                    ldsm4(e4, smem_addr(s.e) + off(erow[cp], 2 * ks + b_ch));
                    bb[2 * cp][0] = e4[0]; bb[2 * cp][1] = e4[1];
                    bb[2 * cp + 1][0] = e4[2]; bb[2 * cp + 1][1] = e4[3];
                }
                unsigned m0 = bb[0][0], m1 = bb[0][1];
#pragma unroll
                for (int jt = 0; jt < 6; ++jt) {
                    const bool own = 8 * jt + 8 <= rel;
                    unsigned q1[4];
#pragma unroll
                    for (int x = 0; x < 4; ++x) q1[x] = own ? qo[x] : qn[x];
                    mma_bf16(acc[jt], q1, bb[jt][0], bb[jt][1]);
                    if (jt == jm) { m0 = bb[jt][0]; m1 = bb[jt][1]; }
                }
                mma_bf16(mix, qo, m0, m1);
            }
#pragma unroll
            for (int jt = 0; jt < 6; ++jt) {
                const float* eb = s.eb + ring_row(xq + 8 * jt) + 2 * tq;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = mq + g + 8 * (e >> 1), xl = 8 * jt + 2 * tq + (e & 1);
                    const float val = jt == jm && xl < rel ? mix[e] : acc[jt][e];
                    s.qe[r * QW + xq + xl] = val + eb[e & 1];
                }
            }
        }
        __syncthreads();

        // B: the warp's keys kk = kw + g + 8 (e >> 1) against the step's
        // queries r = 8 j + 2 tq + (e & 1): S^T = K . qu^T + BD^T (BD read
        // along the diagonals of QE), dP^T = V . dO^T, P and dS; dV += P^T .
        // dO and dK += dS^T . qu with P^T and dS^T packed in registers; dS^T
        // into its tile and into DSk
        {
            const unsigned qu_rows = smem_addr(s.qu[buf]), go_rows = smem_addr(s.go[buf]);
            float sac[NQT][4], dp[NQT][4];
            zero(sac);
            zero(dp);
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks) {
                unsigned kf[4];
                ldsm4(kf, smem_addr(s.k) + off(kw + a_row, 2 * ks + a_ch));
#pragma unroll
                for (int np = 0; np < NQT / 2; ++np) {
                    unsigned x4[4];
                    ldsm4(x4, qu_rows + off(16 * np + b_row, 2 * ks + b_ch));
                    mma_bf16(sac[2 * np], kf, x4[0], x4[1]);
                    mma_bf16(sac[2 * np + 1], kf, x4[2], x4[3]);
                    ldsm4(x4, go_rows + off(16 * np + b_row, 2 * ks + b_ch));
                    mma_bf16(dp[2 * np], vf[ks], x4[0], x4[1]);
                    mma_bf16(dp[2 * np + 1], vf[ks], x4[2], x4[3]);
                }
            }
            // BD^T[kk][r] = QE[r][kk - r + TQ - 1]
            const float* diag = s.qe + 2 * tq * (QW - 1) + kw + g + TQ - 1;
            unsigned pa[TQ / 16][4], da[TQ / 16][4];
#pragma unroll
            for (int j = 0; j < NQT; ++j) {
                const int r = 8 * j + 2 * tq;
                const float2 l2 = *reinterpret_cast<const float2*>(&s.lse[buf][r]);
                const float2 d2 = *reinterpret_cast<const float2*>(&s.dd[buf][r]);
                float p[4], ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int rr = r + (e & 1), kk = kw + g + 8 * (e >> 1);
                    const float bd = diag[(8 * j + (e & 1)) * (QW - 1) + 8 * (e >> 1)];
                    const float sc = (sac[j][e] + bd) / ROOT;
                    const bool live = i0 + rr < T && j0 + kk < T;
                    p[e] = live ? expf(sc - ((e & 1) ? l2.y : l2.x)) : 0.f;
                    ds[e] = p[e] * (dp[j][e] - ((e & 1) ? d2.y : d2.x)) / ROOT;
                }
                // the A fragments of k-step j / 2: rows g (j & 1 = 0 halves) and g + 8
                const int kq = j >> 1, hf = j & 1;
                pa[kq][2 * hf] = pack_bf16(p[0], p[1]);
                pa[kq][2 * hf + 1] = pack_bf16(p[2], p[3]);
                da[kq][2 * hf] = pack_bf16(ds[0], ds[1]);
                da[kq][2 * hf + 1] = pack_bf16(ds[2], ds[3]);
                cs_acc[0] += lo_bf16(da[kq][2 * hf]) + hi_bf16(da[kq][2 * hf]);
                cs_acc[1] += lo_bf16(da[kq][2 * hf + 1]) + hi_bf16(da[kq][2 * hf + 1]);
            }
#pragma unroll
            for (int kq = 0; kq < TQ / 16; ++kq)
#pragma unroll
                for (int np = 0; np < NDT / 2; ++np) {
                    unsigned x4[4];
                    ldsm4t(x4, go_rows + off(16 * kq + a_row, 2 * np + a_ch));
                    mma_bf16(dv_acc[2 * np], pa[kq], x4[0], x4[1]);
                    mma_bf16(dv_acc[2 * np + 1], pa[kq], x4[2], x4[3]);
                    ldsm4t(x4, qu_rows + off(16 * kq + a_row, 2 * np + a_ch));
                    mma_bf16(dk_acc[2 * np], da[kq], x4[0], x4[1]);
                    mma_bf16(dk_acc[2 * np + 1], da[kq], x4[2], x4[3]);
                }
            unsigned short* dsk = reinterpret_cast<unsigned short*>(s.dsk);
#pragma unroll
            for (int j = 0; j < NQT; ++j)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int kk = kw + g + 8 * hh, r = 8 * j + 2 * tq;
                    const unsigned w = da[j >> 1][2 * (j & 1) + hh];
                    *reinterpret_cast<unsigned*>(reinterpret_cast<char*>(s.dst)
                                                 + (at16<TQ / 8>(kk, j) << 4) + 4 * tq) = w;
                    dsk[r * XW + kk - r + TQ - 1] = (unsigned short)(w & 0xffffu);
                    dsk[(r + 1) * XW + kk - r + TQ - 2] = (unsigned short)(w >> 16);
                }
        }
        __syncthreads();

        // C: dq = dS . K + DSk_own . E (rows r), DSk_next . E (rows r + 1,
        // staged); warp: rows mq.., dims nd..  Then d re += DSk^T . Q_sel
        // into the gradient ring (q_i for the columns x < xs, q_{i+1} for
        // the others; the 16-row tile that holds xs takes q_{i+1}, and q_i
        // in fix), d rb += DSk's column sums (a product with a ones column)
        zero(acc);
        {
            const unsigned dst_rows = smem_addr(s.dst), k_rows = smem_addr(s.k);
            const unsigned dsk_rows = smem_addr(s.dsk), e_rows = smem_addr(s.e);
#pragma unroll
            for (int kt = 0; kt < TK / 16; ++kt) {
                unsigned a4[4];
                ldsm4t(a4, dst_rows + (at16<TQ / 8>(16 * kt + b_row, mq / 8 + b_ch) << 4));
#pragma unroll
                for (int np = 0; np < NQD / 2; ++np) {
                    unsigned x4[4];
                    ldsm4t(x4, k_rows + off(16 * kt + a_row, nd / 8 + 2 * np + a_ch));
                    mma_bf16(acc[2 * np], a4, x4[0], x4[1]);
                    mma_bf16(acc[2 * np + 1], a4, x4[2], x4[3]);
                }
            }
            // DSk's columns 2 tq, 2 tq + 1 (a0, a1) and 8 + 2 tq, 9 + 2 tq (a2, a3)
            // of the k-step at x0 that lie on the own side
            auto own_mask = [&](int x0, unsigned (&m)[2]) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int c = x0 + 8 * hf + 2 * tq;
                    m[hf] = (c < xs ? 0xffffu : 0u) | (c + 1 < xs ? 0xffff0000u : 0u);
                }
            };
            float nx[NQD][4];
            zero(nx);
#pragma unroll
            for (int xk = 0; xk < NXT; ++xk) {
                unsigned a4[4], m[2];
                ldsm4(a4, dsk_rows + (((mq + a_row) * XW + 16 * xk + 8 * a_ch) << 1));
                own_mask(16 * xk, m);
                a4[0] &= m[0]; a4[1] &= m[0]; a4[2] &= m[1]; a4[3] &= m[1];
                const int er = ring_row(16 * xk) + a_row;
#pragma unroll
                for (int np = 0; np < NQD / 2; ++np) {
                    unsigned x4[4];
                    ldsm4t(x4, e_rows + off(er, nd / 8 + 2 * np + a_ch));
                    mma_bf16(acc[2 * np], a4, x4[0], x4[1]);
                    mma_bf16(acc[2 * np + 1], a4, x4[2], x4[3]);
                }
            }
#pragma unroll
            for (int xk = 0; xk < NXT; ++xk) {
                unsigned a4[4], m[2];
                ldsm4(a4, dsk_rows + (((mq + a_row) * XW + 16 * xk + 8 * a_ch) << 1));
                own_mask(16 * xk, m);
                a4[0] &= ~m[0]; a4[1] &= ~m[0]; a4[2] &= ~m[1]; a4[3] &= ~m[1];
                const int er = ring_row(16 * xk) + a_row;
#pragma unroll
                for (int np = 0; np < NQD / 2; ++np) {
                    unsigned x4[4];
                    ldsm4t(x4, e_rows + off(er, nd / 8 + 2 * np + a_ch));
                    mma_bf16(nx[2 * np], a4, x4[0], x4[1]);
                    mma_bf16(nx[2 * np + 1], a4, x4[2], x4[3]);
                }
            }
#pragma unroll
            for (int jn = 0; jn < NQD; ++jn)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                    *reinterpret_cast<float2*>(s.stg + (mq + g + 8 * hh + 1) * GW + nd + 8 * jn
                                               + 2 * tq) =
                        make_float2(nx[jn][2 * hh], nx[jn][2 * hh + 1]);

            // d re and d rb.  B fragments of q_i and q_{i+1} (k: the queries)
            const unsigned q_rows = smem_addr(s.q[buf]);
            unsigned bo[TQ / 16][4], bn[TQ / 16][4];
#pragma unroll
            for (int kq = 0; kq < TQ / 16; ++kq) {
                ldsm4t(bo[kq], q_rows + off(16 * kq + a_row, 2 * pw + a_ch));
                ldsm4t(bn[kq], q_rows + off(16 * kq + a_row + 1, 2 * pw + a_ch));
            }
            const int ms = min(max(xs >> 4, 0), NXT - 1);     // the tile that may hold xs
            float fix[2][4];
            zero(fix);
#pragma unroll
            for (int kq = 0; kq < TQ / 16; ++kq) {
                unsigned a4[4];
                ldsm4t(a4, dsk_rows + (((16 * kq + b_row) * XW + 16 * ms + 8 * b_ch) << 1));
                mma_bf16(fix[0], a4, bo[kq][0], bo[kq][1]);
                mma_bf16(fix[1], a4, bo[kq][2], bo[kq][3]);
            }
            const unsigned ones = g == 0 ? 0x3f803f80u : 0u;     // B: column 0 all 1.0
#pragma unroll
            for (int im = 0; im < NXT / MSTRIDE; ++im) {
                const int mt = mc + MSTRIDE * im, x0 = 16 * mt;
                const bool own_tile = x0 + 16 <= xs;
                float c[2][4], rs[4] = {0.f, 0.f, 0.f, 0.f};
                zero(c);
#pragma unroll
                for (int kq = 0; kq < TQ / 16; ++kq) {
                    unsigned a4[4], q4[4];
                    ldsm4t(a4, dsk_rows + (((16 * kq + b_row) * XW + x0 + 8 * b_ch) << 1));
#pragma unroll
                    for (int x = 0; x < 4; ++x) q4[x] = own_tile ? bo[kq][x] : bn[kq][x];
                    mma_bf16(c[0], a4, q4[0], q4[1]);
                    mma_bf16(c[1], a4, q4[2], q4[3]);
                    if (pw == mt % NP) mma_bf16(rs, a4, ones, ones);
                }
                const int gb = grad_row(x0) + g;
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int x = x0 + g + 8 * hh;
                    const bool take_fix = mt == ms && x < xs;
                    float* gr = s.gre + (gb + 8 * hh) * GW + 16 * pw + 2 * tq;
#pragma unroll
                    for (int jj = 0; jj < 2; ++jj) {
                        float2 o = *reinterpret_cast<float2*>(gr + 8 * jj);
                        o.x += take_fix ? fix[jj][2 * hh] : c[jj][2 * hh];
                        o.y += take_fix ? fix[jj][2 * hh + 1] : c[jj][2 * hh + 1];
                        *reinterpret_cast<float2*>(gr + 8 * jj) = o;
                    }
                    if (pw == mt % NP && tq == 0) s.grb[gb + 8 * hh] += rs[2 * hh];
                }
            }
        }
        if (st + 1 < nsteps) {
            put_stat(st + 1, stat);
            if (tid >= 2 * TQ && tid < 3 * TQ)
                s.eb[((st + 1) & (E_SLOTS - 1)) * PIECE + tid - 2 * TQ] = bias;
        }
    }
    __syncthreads();
    emit_step(nsteps - 1);

    // d u = sum over the keys of (sum over the queries of dS) k
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const float x = row_sum(cs_acc[hh], 4);
        if (tq == 0) s.cs[kw + g + 8 * hh] = x;
    }
    // dK, dV: each key's complete float32 sum, cast to bf16 once
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int j = j0 + kw + g + 8 * hh;
        if (j >= T) continue;
        const long long row = (((long long)b * T + j) * H + h) * DH + 2 * tq;
#pragma unroll
        for (int jn = 0; jn < NDT; ++jn) {
            *reinterpret_cast<unsigned*>(a.dk + row + 8 * jn) =
                pack_bf16(dk_acc[jn][2 * hh], dk_acc[jn][2 * hh + 1]);
            *reinterpret_cast<unsigned*>(a.dv + row + 8 * jn) =
                pack_bf16(dv_acc[jn][2 * hh], dv_acc[jn][2 * hh + 1]);
        }
    }
    __syncthreads();
    if (tid < DH) {
        const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(s.k);
        float sum = 0.f;
        for (int kk = 0; kk < TK; ++kk)
            sum += s.cs[kk] * __bfloat162float(kt[at16<NCH>(kk, tid / 8) * 8 + tid % 8]);
        atomicAdd(a.du + h * DH + tid, sum);
    }
}

// Shared memory a block, the carve-out that lets two blocks share an SM.
template <int DH>
int configure() {
    const int smem = (int)sizeof(Smem<DH>);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_bwd_bf16<DH>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
    return err == cudaSuccess ? smem : -(int)err;
}

// Launch the parts in stages (1 the pre-pass, 2 the main kernel, 4 the
// casts) on a's buffers; the outputs dq, d re, d u, d rb are bf16.
template <int DH>
int launch(int stages, Args& a, void* dq, void* dre, void* du, void* drb,
           cudaStream_t stream) {
    const long long rows = (long long)a.B * a.T * a.H;
    if (a.H * (DH / 8) > 1024) return (int)cudaErrorInvalidValue;    // the pre-pass's blocks
    if (stages & 1) {
        const int threads = (a.H * (DH / 8) + 31) & ~31;
        prep<DH><<<dim3(a.T, a.B), threads, 0, stream>>>(a);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (stages & 2) {
        const int smem = configure<DH>();
        if (smem < 0) return -smem;
        const dim3 grid((a.T + TK - 1) / TK, a.H, a.B);
        flash_bwd_bf16<DH><<<grid, NTHREADS, smem, stream>>>(a);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (stages & 4) {
        Casts c;
        const float* src[4] = {a.dq, a.dre, a.du, a.drb};
        void* dst[4] = {dq, dre, du, drb};
        const long long n[4] = {rows * DH, (long long)a.T * a.H * DH, (long long)a.H * DH,
                                (long long)a.T * a.H};
        for (int i = 0; i < 4; ++i) {
            c.src[i] = src[i];
            c.dst[i] = static_cast<__nv_bfloat16*>(dst[i]);
            c.n[i] = n[i];
        }
        const long long want = (n[0] / 4 + 255) / 256;
        const long long blocks = want < 1024 ? want : 1024;
        finish<<<dim3((unsigned)blocks, 4), 256, 0, stream>>>(c);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace bbw


}  // namespace

extern "C" int ttx_flash_rel_attention_bwd(
        const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb,
        const void* out, const void* lse, const void* dout, void* dq, void* dk,
        void* dv, void* dre, void* du, void* drb, int B, int T, int H, int Dh,
        void* stream) {
    Args a;
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.sq = sq; a.sk = sk; a.sv = sv;
    a.re = static_cast<const float*>(re);
    a.u = static_cast<const float*>(u);
    a.rb = static_cast<const float*>(rb);
    a.out = static_cast<const float*>(out);
    a.lse = static_cast<const float*>(lse);
    a.dout = static_cast<const float*>(dout);
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
            flash_bwd_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((T + TQ - 1) / TQ, H, B);
        flash_bwd_tc<DH><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
        return (int)cudaGetLastError();
    });
}

// The bf16 form's parts (stages: 1 the pre-pass, 2 the main kernel, 4 the
// casts) on the work buffer of ttx_flash_rel_attention_bwd_bf16_workspace floats.
static int bwd_bf16(int stages, const void* q, const void* k, const void* v, long long sq,
                    long long sk, long long sv, const void* re, const void* u, const void* rb,
                    const void* sums, const void* lse, const void* grad, void* dq, void* dk,
                    void* dv, void* dre, void* du, void* drb, void* work, int B, int T, int H,
                    int Dh, void* stream) {
    bbw::Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.sq = sq; a.sk = sk; a.sv = sv;
    a.re = static_cast<const __nv_bfloat16*>(re);
    a.u = static_cast<const __nv_bfloat16*>(u);
    a.rb = static_cast<const __nv_bfloat16*>(rb);
    a.sums = static_cast<const float*>(sums);
    a.lse = static_cast<const float*>(lse);
    a.grad = static_cast<const float*>(grad);
    a.dk = static_cast<__nv_bfloat16*>(dk);
    a.dv = static_cast<__nv_bfloat16*>(dv);
    a.B = B; a.T = T; a.H = H;
    bbw::work_layout(B, T, H, Dh, static_cast<float*>(work), &a);
    return with_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        return bbw::launch<DH>(stages, a, dq, dre, du, drb, static_cast<cudaStream_t>(stream));
    });
}

// The floats of the bf16 form's work buffer.
extern "C" long long ttx_flash_rel_attention_bwd_bf16_workspace(int B, int T, int H, int Dh) {
    return bbw::work_layout(B, T, H, Dh, nullptr, nullptr);
}

// The bf16 form: q, k, v and the tables bf16; sums the forward's float32 P .
// v (D_i = bf16(dO_i) . sums_i); grad the float32 output gradient, rounded
// to bf16 by the pre-pass; the six gradients bf16, each written once.
extern "C" int ttx_flash_rel_attention_bwd_bf16(
        const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb,
        const void* sums, const void* lse, const void* grad, void* dq, void* dk,
        void* dv, void* dre, void* du, void* drb, void* work, int B, int T, int H, int Dh,
        void* stream) {
    return bwd_bf16(7, q, k, v, sq, sk, sv, re, u, rb, sums, lse, grad, dq, dk, dv, dre, du,
                    drb, work, B, T, H, Dh, stream);
}

// Some of its stages alone, for timing them (the main kernel adds to the
// work buffer's sums: its outputs are those of a whole call only after one).
extern "C" int ttx_flash_rel_attention_bwd_bf16_stages(
        int stages, const void* q, const void* k, const void* v, long long sq, long long sk,
        long long sv, const void* re, const void* u, const void* rb,
        const void* sums, const void* lse, const void* grad, void* dq, void* dk,
        void* dv, void* dre, void* du, void* drb, void* work, int B, int T, int H, int Dh,
        void* stream) {
    return bwd_bf16(stages, q, k, v, sq, sk, sv, re, u, rb, sums, lse, grad, dq, dk, dv, dre,
                    du, drb, work, B, T, H, Dh, stream);
}

// The main kernel's launch facts at head width Dh: out[0] its shared memory
// bytes a block, out[1] its blocks a multiprocessor (the occupancy API),
// out[2] its registers a thread.
extern "C" int ttx_flash_rel_attention_bwd_bf16_info(int Dh, int* out) {
    return with_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        const int smem = bbw::configure<DH>();
        if (smem < 0) return -smem;
        cudaFuncAttributes attr;
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[1], bbw::flash_bwd_bf16<DH>, bbw::NTHREADS, smem);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, bbw::flash_bwd_bf16<DH>);
        if (err != cudaSuccess) return (int)err;
        out[0] = smem;
        out[2] = attr.numRegs;
        return 0;
    });
}
