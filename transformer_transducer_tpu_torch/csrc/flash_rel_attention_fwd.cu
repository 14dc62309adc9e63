// Full-context rel-position attention forward for Hopper (sm_90a): fp32
// accuracy on the TF32 tensor cores, and a bf16 form on the bf16 ones.
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
// The bf16 form (bfw::flash_fwd_bf16, ttx_flash_rel_attention_fwd_bf16)
// computes at the Pallas forward's rounding points (--bf16 --flash): q, k,
// v and the tables bf16; q + u rounded to bf16 (JAX adds in bf16), so AC
// takes its own tile qu beside q's; BD = q_sel . re + rb as above; the
// scores divided by sqrt(Dh) in fp32.  JAX rounds the normalised P to bf16
// before P.V, which an online softmax never holds (its P is scaled by a
// running max and sum until the last chunk), so the form sweeps the key
// chunks twice: the first takes each row's max m and sum l, the second
// recomputes the same scores, forms P = exp(s - m) times 1/l (one
// reciprocal a row), rounds it to bf16 for O += bf16(P) . V and, when the
// lse is kept (training), adds the rest P - bf16(P), rounded to bf16, on
// the same V fragments: O + that is the fp32 P's product with v (its error
// is 2^-9 of a rest of at most 2^-9 P), which the bf16 backward needs for
// D_i = sum_j P_ij dP_ij.
//
// Bounds at the flagship serving shape (B 8, T 410, H 8, Dh 64): 4.13
// GFLOP take 4.2 us at the bf16 tensor-core rate (989 TFLOP/s); the bytes
// (bf16 q, k, v and tables in, the fp32 output out, 16.9 MB) 5.0 us at
// 3.35 TB/s, so the bytes bound it.  The two sweeps do about 2.2x the
// scores' products (AC and BD twice, the skewed columns (64 + 16) / 64 of
// BD's) and take two exponentials a score; the elementwise work per score
// (the diagonal read, the division, exp, the bf16 packing) is of the same
// order as the products' issue slots.
//
// Design (what holds the TF32 schedule above back, and what this one does):
//   * Operands stay bf16 in shared memory, rows of 16-byte chunks swizzled
//     by the row (at16, csrc/tensor_core.cuh), so ldmatrix reads them free
//     of bank conflicts; every product is mma.m16n8k16 .bf16 with fp32
//     accumulators (exact products, as one TF32 pass on bf16 values is, at
//     twice its rate): A fragments of q, q_{i+1} and qu from ldmatrix.x4,
//     K's and the table's B fragments from ldmatrix.x4 (two 8-column tiles
//     a load), V's through ldmatrix.x4.trans.  P.V's A fragment is packed
//     from the score accumulators in registers (bf16x2 of the C fragment's
//     pairs, tiles 2ks and 2ks + 1 for keys 16ks .. 16ks + 15).
//   * 16-byte cp.async copies stage each chunk while the one before is
//     used: K and V double-buffered, one barrier a chunk.  The table rows
//     live in a ring of RING = 256 rows by offset: chunk c reads pieces c
//     and c + 1 (64 offsets each: a block's TQ + TK - 1 = 127 offsets and
//     one more), and piece c + 2 is copied meanwhile, so each table row is
//     fetched once a sweep.  r_bias, 2 bytes a row, goes through a register
//     (loaded at the chunk's start, stored after it).
//   * Tiles: TQ = 64 query rows (4 warps of 16), TK = 64 keys.  105.6 KB
//     of shared memory at Dh 64 lets two blocks share an SM (8 warps; 252
//     registers, no spill), where the fp32-tiled form took 149 KB and one
//     block of 8 warps; TK 64 cuts BD's skew overhead from (32 + 16) / 32
//     to (64 + 16) / 64, and at T 410 the grid's 7 x H x B blocks leave 38
//     of 448 query rows a head idle (the 128-row tiles left 102 of 512).
//     128-row tiles of 8 warps (one block an SM, three pieces a chunk)
//     halve the table and key traffic from L2 but measured no faster on
//     the card: the copies are mostly hidden, and what is left is the
//     warps' own work.
//   * Each warp keeps its A fragments (q_i, q_{i+1} and qu, every k-step)
//     in registers for the whole kernel: loaded once, they take no
//     ldmatrix a chunk.  Every tile row a lane addresses is its own row
//     plus a multiple of 16, so its swizzle is computed once.
//   * Each warp's QE over its 80 skewed columns (79 used) goes through its
//     own fp32 tile, read along the diagonals, BD[r][kk] = QE[r][kk - r +
//     16].  A column's own/next side is the column's: a chunk wholly on one
//     side (all but at most two of a warp's chunks) takes one A operand;
//     where the split column xs falls inside, each 8-column tile takes its
//     side and only the tile that holds xs a second product (ldmatrix.x2
//     of that tile), where both sides were computed over all columns.
//     The choice is a select of registers, never a branch around an mma.
//   * m and 1/l are taken once a row; exp keeps expf (a P's rounding to
//     bf16 at the plain form's value, within an ulp or two; __expf measured
//     no faster).
// Plain PyTorch version: ops/cuda/flash_rel_attention.py ::
// flash_bf16_forward_plain.

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

// ---- the bf16 form (its note: the head of this file)

namespace bfw {

constexpr int NW = 4;                 // warps, 16 query rows each
constexpr int TQ = 16 * NW;           // query rows a block
constexpr int TK = 64;                // keys a chunk
constexpr int PIECE = 64;             // table rows a piece of the ring
constexpr int NPC = (TQ + TK) / PIECE;    // pieces a chunk reads
constexpr int RING = 4 * PIECE;       // the ring's rows
constexpr int QX = TK + 16;           // a warp's skewed columns (79), padded
constexpr int QW = QX + 8;            // row of a warp's QE tile, in floats
constexpr int NTHREADS = 32 * NW;
static_assert((TQ + TK) % PIECE == 0 && NPC < RING / PIECE,
              "a chunk's offsets are whole pieces, and the ring holds one more");

struct Args {
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

// bf16 tiles: rows of DH / 8 16-byte chunks, placed by at16.
template <int DH>
struct __align__(16) Smem {
    static constexpr int NCH = DH / 8;
    uint4 q[(TQ + 1) * NCH];    // q_i; row TQ is q_{i0+TQ}
    uint4 qu[TQ * NCH];         // bf16(q_i + u)
    uint4 k[2][TK * NCH];       // chunk c's keys in k[c & 1]
    uint4 v[2][TK * NCH];
    uint4 e[RING * NCH];        // table row of offset ob + n at ring row n & (RING - 1)
    float eb[RING];             // r_bias of the same offsets
    float qe[NW][16 * QW];      // each warp's QE + rb over its skewed columns
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_bf16(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    constexpr int NCH = Smem<DH>::NCH;           // 16-byte chunks a row
    constexpr int NKS = DH / 16;                 // k-steps of the score products
    constexpr int NKT = TK / 8, NQT = QX / 8, NOT = DH / 8;   // tiles a warp
    static_assert(DH == 32 || DH == 64, "sqrt(Dh) below");

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int i0 = blockIdx.x * TQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int T = a.T, H = a.H;
    const int nchunks = (T + TK - 1) / TK;
    const int ob = -(i0 + TQ);        // offset of piece 0's first row

    // the query tile: q (one row more) and bf16(q + u), zero past T
    for (int idx = tid; idx < (TQ + 1) * NCH; idx += NTHREADS) {
        const int r = idx / NCH, c = idx % NCH, i = i0 + r;
        const uint4 x = i < T ? __ldg(reinterpret_cast<const uint4*>(
                                    a.q + ((long long)b * T + i) * a.sq + h * DH + 8 * c))
                              : make_uint4(0u, 0u, 0u, 0u);
        s.q[at16<NCH>(r, c)] = x;
        if (r < TQ)
            s.qu[at16<NCH>(r, c)] =
                add_bf16x8(x, __ldg(reinterpret_cast<const uint4*>(a.u + h * DH + 8 * c)));
    }

    // chunk c's keys (and values) into buffer c & 1, zero past T
    auto stage_kv = [&](int c, bool with_v) {
        uint4* kt = s.k[c & 1];
        uint4* vt = s.v[c & 1];
#pragma unroll
        for (int n = 0; n < TK * NCH / NTHREADS; ++n) {
            const int idx = tid + n * NTHREADS;
            const int kk = idx / NCH, ch = idx % NCH, j = c * TK + kk;
            const long long row = (long long)b * T + (j < T ? j : 0);
            cp16(&kt[at16<NCH>(kk, ch)], a.k + row * a.sk + h * DH + 8 * ch, j < T);
            if (with_v)
                cp16(&vt[at16<NCH>(kk, ch)], a.v + row * a.sv + h * DH + 8 * ch, j < T);
        }
    };
    // piece p: the table rows of offsets ob + PIECE p + x (zero if none)
    auto stage_piece = [&](int p) {
#pragma unroll
        for (int n = 0; n < PIECE * NCH / NTHREADS; ++n) {
            const int idx = tid + n * NTHREADS;
            const int x = idx / NCH, ch = idx % NCH;
            const int row = bd_row(T, ob + PIECE * p + x);
            cp16(&s.e[at16<NCH>((PIECE * p + x) & (RING - 1), ch)],
                 a.re + ((long long)max(row, 0) * H + h) * DH + 8 * ch, row >= 0);
        }
    };
    // r_bias of piece p's offsets: loaded (threads below PIECE) and stored
    auto piece_bias = [&](int p) {
        const int row = tid < PIECE ? bd_row(T, ob + PIECE * p + tid) : -1;
        return row >= 0 ? ldg1(a.rb + row * H + h) : 0.f;
    };
    auto put_bias = [&](int p, float x) {
        if (tid < PIECE) s.eb[(PIECE * p + tid) & (RING - 1)] = x;
    };
    // a sweep starts with chunk 0 and its pieces in flight, once every warp
    // is past the previous sweep
    auto start = [&](bool with_v) {
        __syncthreads();
        stage_kv(0, with_v);
#pragma unroll
        for (int p = 0; p < NPC; ++p) stage_piece(p);
        cp_commit();
#pragma unroll
        for (int p = 0; p < NPC; ++p) put_bias(p, piece_bias(p));
    };
    // chunk c: wait for its copies; the barrier also frees chunk c - 1's
    // buffers, into which chunk c + 1 and piece c + NPC go while c is used;
    // returns piece c + NPC's r_bias, stored after chunk c (put_bias)
    auto advance = [&](int c, bool with_v) {
        cp_wait<0>();
        __syncthreads();
        if (c + 1 >= nchunks) return 0.f;
        stage_kv(c + 1, with_v);
        stage_piece(c + NPC);
        cp_commit();
        return piece_bias(c + NPC);
    };

    // the warp's rows m0..m0+15; its skewed column xl is ring row x0 + xl
    // of chunk c's pieces, offset j0 - (i0 + m0) - 16 + xl
    const int m0 = 16 * warp;
    const bool rows_live = i0 + m0 < T;
    const int x0 = TQ - 16 - m0;
    // ldmatrix lanes: an A operand's rows (lane & 7) + 8 ((lane >> 3) & 1)
    // at chunk + (lane >> 4); two B tiles' rows (lane & 7) + 8 (lane >> 4)
    // at chunk + ((lane >> 3) & 1); V (.trans) as A with keys for rows.
    // Every tile row the lane addresses is one of these plus a multiple of
    // 16 (of 8 for the x2 load), so its swizzle is the lane's own.
    constexpr int ROW = 16 * NCH;                // bytes a tile row
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_ch = lane >> 4;
    const int b_row = (lane & 7) + 8 * (lane >> 4), b_ch = (lane >> 3) & 1;
    const int sw_a = swz16<NCH>(a_row), sw_b = swz16<NCH>(b_row);
    auto a_col = [&](int c) { return ((c + a_ch) ^ sw_a) << 4; };
    auto b_col = [&](int c) { return ((c + b_ch) ^ sw_b) << 4; };
    const unsigned e_base = smem_addr(s.e) + b_row * ROW;
    float* qe = s.qe[warp];
    // QE[r][kk - r + 16] at r = g + 8 (e >> 1), kk = 8 j + 2 t + (e & 1)
    const float* diag = qe + g * (QW - 1) + 2 * t + 16;
    constexpr float ROOT = DH == 64 ? 8.0f : 5.65685424949238019520f;   // sqrt(Dh) in fp32

    // the warp's scores over chunk c (rows g, g + 8; keys 8j + 2t + (e & 1)):
    // QE + rb over its skewed columns into its tile, from q_i where the
    // offset is <= 0 and q_{i+1} from column xs on (a chunk wholly on one
    // side takes one A operand; where xs falls inside, each 8-column tile
    // takes its side and the tile that holds xs also the other), S_ac =
    // qu . k, (S_ac + QE along the diagonals) / sqrt(Dh), NEG past T
    unsigned qo[NKS][4], qn[NKS][4], qa[NKS][4];       // A: q_i, q_{i+1}, qu
    auto scores = [&](int c, float (&sc)[NKT][4]) {
        const int j0 = c * TK;
        const int xs = i0 + m0 + 17 - j0;
        const int nb = PIECE * c + x0;
        unsigned e_row[NQT / 2];
#pragma unroll
        for (int jp = 0; jp < NQT / 2; ++jp)
            e_row[jp] = e_base + ((nb + 16 * jp) & (RING - 1)) * ROW;
        float acc[NQT][4], mix[4] = {0.f, 0.f, 0.f, 0.f};
        int jm = -1;
        zero(acc);
        if (xs >= QX || xs <= 0) {
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks) {
                unsigned q1[4];
#pragma unroll
                for (int x = 0; x < 4; ++x) q1[x] = xs > 0 ? qo[ks][x] : qn[ks][x];
#pragma unroll
                for (int jp = 0; jp < NQT / 2; ++jp) {
                    unsigned e4[4];
                    ldsm4(e4, e_row[jp] + b_col(2 * ks));
                    mma_bf16(acc[2 * jp], q1, e4[0], e4[1]);
                    mma_bf16(acc[2 * jp + 1], q1, e4[2], e4[3]);
                }
            }
        } else {
            jm = xs >> 3;
            const unsigned e_mix = e_base - b_row * ROW + (lane & 7) * ROW
                                   + ((nb + 8 * jm) & (RING - 1)) * ROW;
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
                for (int jp = 0; jp < NQT / 2; ++jp) {
                    unsigned e4[4];
                    ldsm4(e4, e_row[jp] + b_col(2 * ks));
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const bool own = 8 * (2 * jp + hf) < xs;
                        unsigned q1[4];
#pragma unroll
                        for (int x = 0; x < 4; ++x) q1[x] = own ? qo[ks][x] : qn[ks][x];
                        mma_bf16(acc[2 * jp + hf], q1, e4[2 * hf], e4[2 * hf + 1]);
                    }
                }
                unsigned e2[2];
                ldsm2(e2, e_mix + b_col(2 * ks));
                mma_bf16(mix, qn[ks], e2[0], e2[1]);
            }
        }
#pragma unroll
        for (int j = 0; j < NQT; ++j) {
            const int xl = 8 * j + 2 * t;
            const float2 eb = *reinterpret_cast<const float2*>(&s.eb[(nb + xl) & (RING - 1)]);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                float v0 = acc[j][2 * hr], v1 = acc[j][2 * hr + 1];
                if (j == jm) {
                    if (xl >= xs) v0 = mix[2 * hr];
                    if (xl + 1 >= xs) v1 = mix[2 * hr + 1];
                }
                *reinterpret_cast<float2*>(&qe[(g + 8 * hr) * QW + xl]) =
                    make_float2(v0 + eb.x, v1 + eb.y);
            }
        }
        __syncwarp();
        zero(sc);
        const unsigned k_base = smem_addr(s.k[c & 1]) + b_row * ROW;
#pragma unroll
        for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
            for (int jp = 0; jp < NKT / 2; ++jp) {
                unsigned k4[4];
                ldsm4(k4, k_base + 16 * jp * ROW + b_col(2 * ks));
                mma_bf16(sc[2 * jp], qa[ks], k4[0], k4[1]);
                mma_bf16(sc[2 * jp + 1], qa[ks], k4[2], k4[3]);
            }
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                sc[j][e] = (sc[j][e] + diag[8 * (e >> 1) * (QW - 1) + 8 * j + (e & 1)]) / ROOT;
        if (j0 + TK > T) {
#pragma unroll
            for (int j = 0; j < NKT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (j0 + 8 * j + 2 * t + (e & 1) >= T) sc[j][e] = NEG;
        }
    };

    // sweep 1: each row's max and sum (rows g, g + 8; the sum per lane)
    float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
    start(false);
    {   // the warp's A fragments, once (the tile is in after start's barrier)
        const unsigned q_rows = smem_addr(s.q) + (m0 + a_row) * ROW;
        const unsigned qu_rows = smem_addr(s.qu) + (m0 + a_row) * ROW;
        const int sw_n = swz16<NCH>(a_row + 1);
#pragma unroll
        for (int ks = 0; ks < NKS; ++ks) {
            ldsm4(qo[ks], q_rows + a_col(2 * ks));
            ldsm4(qn[ks], q_rows + ROW + (((2 * ks + a_ch) ^ sw_n) << 4));
            ldsm4(qa[ks], qu_rows + a_col(2 * ks));
        }
    }
    for (int c = 0; c < nchunks; ++c) {
        const float bias = advance(c, false);
        if (rows_live) {
            float sc[NKT][4];
            scores(c, sc);
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
        if (c + 1 < nchunks) put_bias(c + NPC, bias);
    }
    float inv_l[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        l_run[hr] = row_sum(l_run[hr], 4);
        inv_l[hr] = 1.f / l_run[hr];
    }

    // sweep 2: P = exp(s - m) / l (as exp(s - m) times 1/l); O += bf16(P) .
    // V and, with the sums, R += bf16(P - bf16(P)) . V.  P.V's A fragment
    // of keys 16 ks .. 16 ks + 15 is the score tiles 2 ks, 2 ks + 1 packed
    // in pairs: (g, 2t), (g + 8, 2t), (g, 8 + 2t), (g + 8, 8 + 2t)
    const bool keep = a.sums != nullptr;
    float o[NOT][4], rest[NOT][4];
    zero(o);
    zero(rest);
    start(true);
    for (int c = 0; c < nchunks; ++c) {
        const float bias = advance(c, true);
        if (rows_live) {
            float sc[NKT][4];
            scores(c, sc);
            const unsigned v_base = smem_addr(s.v[c & 1]) + a_row * ROW;
#pragma unroll
            for (int ks = 0; ks < TK / 16; ++ks) {
                unsigned pa[4], ra[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    const int j = 2 * ks + (x >> 1), hr = x & 1;
                    const float p0 = expf(sc[j][2 * hr] - m_run[hr]) * inv_l[hr];
                    const float p1 = expf(sc[j][2 * hr + 1] - m_run[hr]) * inv_l[hr];
                    pa[x] = pack_bf16(p0, p1);
                    if (keep) ra[x] = pack_bf16(p0 - lo_bf16(pa[x]), p1 - hi_bf16(pa[x]));
                }
#pragma unroll
                for (int jp = 0; jp < NOT / 2; ++jp) {
                    unsigned v4[4];
                    ldsm4t(v4, v_base + 16 * ks * ROW + a_col(2 * jp));
                    mma_bf16(o[2 * jp], pa, v4[0], v4[1]);
                    mma_bf16(o[2 * jp + 1], pa, v4[2], v4[3]);
                    if (keep) {
                        mma_bf16(rest[2 * jp], ra, v4[0], v4[1]);
                        mma_bf16(rest[2 * jp + 1], ra, v4[2], v4[3]);
                    }
                }
            }
        }
        if (c + 1 < nchunks) put_bias(c + NPC, bias);
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

// Shared memory a block, the carve-out that lets two blocks share an SM.
template <int DH>
int configure() {
    const int smem = (int)sizeof(Smem<DH>);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_fwd_bf16<DH>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
    return err == cudaSuccess ? smem : -(int)err;
}

}  // namespace bfw

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
    bfw::Args a;
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
        const int smem = bfw::configure<DH>();
        if (smem < 0) return -smem;
        const dim3 grid((T + bfw::TQ - 1) / bfw::TQ, H, B);
        bfw::flash_fwd_bf16<DH><<<grid, bfw::NTHREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
        return (int)cudaGetLastError();
    });
}

// The bf16 form's launch facts at head width Dh: out[0] its shared memory
// bytes a block, out[1] its blocks a multiprocessor (the occupancy API),
// out[2] its registers a thread.
extern "C" int ttx_flash_rel_attention_fwd_bf16_info(int Dh, int* out) {
    return with_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        const int smem = bfw::configure<DH>();
        if (smem < 0) return -smem;
        cudaFuncAttributes attr;
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[1], bfw::flash_fwd_bf16<DH>, bfw::NTHREADS, smem);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, bfw::flash_fwd_bf16<DH>);
        if (err != cudaSuccess) return (int)err;
        out[0] = smem;
        out[2] = attr.numRegs;
        return 0;
    });
}
