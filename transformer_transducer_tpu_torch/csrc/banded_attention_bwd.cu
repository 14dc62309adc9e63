// Banded rel-position self-attention backward for Hopper (sm_90a), fp32.
//
// Replaces ops/pallas/banded_attention.py :: banded_attention backward
// (_bwd_impl, _band_bwd_kernel) -- ttx_banded_attention_bwd below.  The
// score rule is csrc/rel_attention.cu's: with o = j - i, -left <= o <= right,
// scale = 1/sqrt(Dh) and the tables sliced to T rows,
//   score(i,j) = scale [ (q_i + u).k_j + BD(i,j) ],
//   BD = q_i.re[T-1+o] + rb[T-1+o] (o <= 0), 0 (o == 1),
//        q_{i+1}.re[o-2] + rb[o-2] (o >= 2);
//   p = exp(score - lse_i) from the forward's row log-sum-exp, D_i = dO_i.O_i,
//   ds = p (dO_i.v_j - D_i) scale;
//   dv_j = sum_i p dO_i,  dk_j = sum_i ds (q_i + u),  dq_i = sum_j ds k_j
//   + the own BD part sum_{o<=0} ds re[T-1+o] + the wrap share of row i-1,
//   sum_{o>=2} ds_{i-1,o} re[o-2];  d re, d rb: ds times q_i (o <= 0) or
//   q_{i+1} (o >= 2), and ds alone, summed along each offset; d u = sum dq_ac.
//
// Bound on the card (H100 SXM, 700 W), flagship training batch B = 4,
// T = 410, H = 8, Dh = 64, band (10, 2): about 5,264 live cells a (b, h) at
// 16 Dh FLOP each, 0.17 GFLOP, 2.6 us at 67 TFLOP/s of fp32; q, k, v, dO
// and the tables in, dq, dk, dv and the tables out, about 25 MB, 7.5 us at
// 3.35 TB/s (this kernel also reads O and lse for D_i: 28.6 MB, 8.5 us).
// About 7 FLOP a byte, under the fp32 ridge: the bytes bound it, and the
// tensor cores would not move the bound.
//
// What held the kernel this one replaces (rel_attention_bwd) at 5 % of
// its bound: dense 64-key chunks where 13 cells a row are live, table
// gradients for every offset of the chunk through fp32 atomics (about 87 %
// of them adding zero, all blocks of a head on the same addresses), dq, dk
// and dv through atomics into buffers the wrapper zeroed, and 104 KB of
// shared memory a block (two blocks an SM).  Timed alone on an H100 with
// each part switched off in turn, the atomics held about a third of its
// 0.135 ms (table 8 %, dk and dv 14 %, dq 3 %), the memsets 0.006 ms, and
// the dense chunks the rest.  This design:
//   * A block owns TQ = 32 rows and the 32 keys of the same indices of one
//     (b, h).  It walks the band's offsets in chunks of OC = 16 (one chunk
//     at the flagship band; up to 9 at W = left + right + 1 = 129) and, for
//     each chunk [oa, ob), the rows whose band reaches its keys plus row
//     i0 - 1 (its wrap term feeds dq_{i0}): [i0 - max(0, ob - 1),
//     i0 + TQ + max(0, -oa)), 44 rows at the flagship band, in tiles of
//     RC = 48 rows.
//   * A tile stages its q rows (one more for q_{i+1}), dO rows, D_i, lse,
//     the RC + OC - 1 keys and values its cells reach, u.k_j, and only the
//     OC table rows of its offsets.  It computes p and ds only for the cells
//     (i, o) that some gradient of the block reads: own rows, own keys, and
//     row i0 - 1 for o >= 2; 44 x 13 cells at the flagship band, against
//     32 x 64 before.
//   * From those cells each thread adds into registers: dq of an own row
//     (AC, own BD, the wrap share of the row before), dk and dv of an own
//     key, and the table partial of one offset and four columns over the
//     own rows.  dq, dk and dv leave with plain stores, once, so the wrapper
//     allocates them uninitialised: no atomics and no memsets.
//   * Table gradients: the partials of each block, for the live offsets
//     only, go with plain stores to scratch the wrapper allocates, (B * nT,
//     H, W + 1, Dh + 4) with row W holding the block's d u; a second kernel
//     (banded_bwd_tables, a block per live offset and head) sums them over
//     the blocks in a fixed order into the table row each offset reads
//     (a row two offsets read, from both); the first kernel zeroes the rows
//     no offset reaches.  Chosen over one atomic per offset and column: the
//     sum is then deterministic, and the second launch reads about 1.6 MB.
//     The whole backward gives bit-identical results from run to run.
//   * A tile's rows are copied with 16-byte cp.async, every copy issued
//     before the first is waited for, zero-filled off the sequence.  72 KB
//     of shared memory a block at Dh = 64 (rows padded to Dh + 4 floats);
//     at 128 registers a thread two blocks share an SM, and one block's
//     copies overlap the other's arithmetic (capped at 80 registers for a
//     third block, ptxas spilled and the kernel ran about 8 % slower on an
//     H100).  fp32 SIMT throughout, as exact as before.
//
// Plain C interface (loaded with ctypes).  The launches run on the caller's
// stream, allocate nothing and return cudaGetLastError().

#include "tensor_core.cuh"

namespace {

using namespace ttx;

constexpr int TQ = 32;              // rows and keys a block owns
constexpr int RC = 48;              // rows of a cell tile
constexpr int OC = 16;              // offsets of a cell tile
constexpr int NK = RC + OC - 1;     // keys of a cell tile
constexpr int NTHREADS = 256;
constexpr int RED_WARPS = NTHREADS / 32;

struct Args {
    const float* q;       // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const float* k;
    const float* v;
    long long sq, sk, sv; // row strides
    const float* re;      // (T, H, Dh), sliced to T rows
    const float* u;       // r_w_bias (H, Dh)
    const float* rb;      // r_bias (T, H)
    const float* out;     // the forward's output (B, T, H, Dh)
    const float* lse;     // its row log-sum-exp (B, H, T)
    const float* dout;    // dO (B, T, H, Dh)
    float* dq;            // (B, T, H, Dh), every entry written
    float* dk;
    float* dv;
    float* dre;           // (T, H, Dh), every entry written
    float* du;            // (H, Dh)
    float* drb;           // (T, H)
    float* part;          // per-block table partials (B * nT, H, W + 1, Dh + 4)
    int B, T, H;
    int left, right;
};

template <int DH>
struct __align__(16) Smem {
    static constexpr int LD = DH + 4;
    float q[RC + 1][LD];    // q rows r0 .. r0 + RC (the last one for q_{i+1})
    float go[RC][LD];       // dO rows r0 .. r0 + RC - 1
    float k[NK][LD];        // keys r0 + oa .. r0 + oa + NK - 1
    float v[NK][LD];
    float e[OC][LD];        // table rows of offsets oa .. oa + OC - 1
    float eb[OC];
    float uk[NK];           // u . k_j
    float lse[RC];
    float di[RC];           // D_i = dO_i . O_i
    float p[RC][OC];        // cell (row r0 + r, offset oa + x)
    float ds[RC][OC];
};

__device__ __forceinline__ void fma4(float* acc, float g, float4 x) {
    acc[0] += g * x.x; acc[1] += g * x.y; acc[2] += g * x.z; acc[3] += g * x.w;
}

// Whether an offset of the band reads table row `row`: o = row - (T - 1)
// (o <= 0) or o = row + 2 (o >= 2).
__device__ __forceinline__ bool row_reached(int row, int T, int L, int R) {
    return row - (T - 1) >= -L || row + 2 <= R;
}

// The cell tile of rows [r0, r0 + RC) and offsets [oa, oa + OC): the rows'
// q (one more), dO, D_i and lse, the keys' k, v and u.k, the offsets'
// table rows (zero past the band's right edge, at o == 1 and off the table).
// Every copy is issued before the first is waited for.
template <int DH>
__device__ __forceinline__ void stage(const Args& a, Smem<DH>& s, int b, int h,
                                      int r0, int oa) {
    constexpr int Q4 = DH / 4;
    constexpr int NO = (RC * Q4 + NTHREADS - 1) / NTHREADS;   // O float4s a thread
    const int T = a.T, H = a.H, tid = threadIdx.x;
    for (int idx = tid; idx < (RC + 1) * Q4; idx += NTHREADS) {
        const int r = idx / Q4, d = 4 * (idx % Q4), i = r0 + r;
        const long long row = (long long)b * T + min(i, T - 1);
        cp16(&s.q[r][d], a.q + row * a.sq + h * DH + d, i < T);
    }
    for (int idx = tid; idx < RC * Q4; idx += NTHREADS) {
        const int r = idx / Q4, d = 4 * (idx % Q4), i = min(r0 + r, T - 1);
        cp16(&s.go[r][d], a.dout + (((long long)b * T + i) * H + h) * DH + d, r0 + r < T);
    }
    for (int idx = tid; idx < NK * Q4; idx += NTHREADS) {
        const int kk = idx / Q4, d = 4 * (idx % Q4), j = r0 + oa + kk;
        const bool ok = j >= 0 && j < T;
        const long long row = (long long)b * T + min(max(j, 0), T - 1);
        cp16(&s.k[kk][d], a.k + row * a.sk + h * DH + d, ok);
        cp16(&s.v[kk][d], a.v + row * a.sv + h * DH + d, ok);
    }
    for (int idx = tid; idx < OC * Q4; idx += NTHREADS) {
        const int x = idx / Q4, d = 4 * (idx % Q4), o = oa + x;
        const int row = o <= a.right ? bd_row(T, o) : -1;
        cp16(&s.e[x][d], a.re + ((long long)max(row, 0) * H + h) * DH + d, row >= 0);
        if (d == 0) s.eb[x] = row >= 0 ? a.rb[row * H + h] : 0.f;
    }
    // the forward's output rows, for D_i, while the copies are in flight
    float4 o4[NO];
#pragma unroll
    for (int m = 0; m < NO; ++m) {
        const int idx = tid + m * NTHREADS, i = r0 + idx / Q4;
        o4[m] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < RC * Q4 && i < T)
            o4[m] = ldg4(a.out + (((long long)b * T + i) * H + h) * DH + 4 * (idx % Q4));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // D_i = dO_i . O_i and u . k_j, each a sum over the Q4 lanes of a row;
    // RC * Q4 and the passes over NK * Q4 run whole warps
#pragma unroll
    for (int m = 0; m < NO; ++m) {
        const int idx = tid + m * NTHREADS;
        if (idx < RC * Q4) {
            const int r = idx / Q4, d = 4 * (idx % Q4);
            const float di = row_sum(dot4(ld4(&s.go[r][d]), o4[m]), Q4);
            if (d == 0) {
                s.di[r] = di;
                s.lse[r] = r0 + r < T ? a.lse[((long long)b * H + h) * T + r0 + r] : 0.f;
            }
        }
    }
    for (int base = 0; base < NK * Q4; base += NTHREADS) {
        const int idx = base + tid, kk = min(idx / Q4, NK - 1), d = 4 * (idx % Q4);
        const float uk = row_sum(dot4(ld4(&s.k[kk][d]), ldg4(a.u + h * DH + d)), Q4);
        if (idx < NK * Q4 && d == 0) s.uk[kk] = uk;
    }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
banded_bwd(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    constexpr int NC = DH / 32;          // float4 groups of a row a thread holds
    constexpr int Q4 = DH / 4;
    constexpr int PW = DH + 4;           // a partial row: Dh columns, d rb, padding

    const int tid = threadIdx.x;
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, H = a.H, L = a.left, R = a.right, W = L + R + 1;
    const int i0 = tile * TQ;
    const int iend = min(i0 + TQ, T);    // own rows and keys [i0, iend)
    const float scale = 1.0f / sqrtf((float)DH);
    float* part = a.part + ((long long)(b * gridDim.x + tile) * H + h) * (W + 1) * PW;

    // dq of own row i0 + ro, dk and dv of own key i0 + ro: columns 32n + 4c..
    const int ro = tid >> 3, c = tid & 7;
    // the table partial of offset oa + tx, columns td..td+3
    const int tx = tid / Q4, td = 4 * (tid % Q4);
    float dq_ac[4 * NC], dq_bd[4 * NC], dk[4 * NC], dv[4 * NC];
#pragma unroll
    for (int x = 0; x < 4 * NC; ++x) dq_ac[x] = dq_bd[x] = dk[x] = dv[x] = 0.f;
    float gsum = 0.f;

    // the table rows [i0, iend) of head h that no offset of the band reads
    // get zeros here (once, from b == 0); banded_bwd_tables writes the rest
    if (b == 0) {
        for (int idx = tid; idx < TQ * Q4; idx += NTHREADS) {
            const int row = i0 + idx / Q4, d = 4 * (idx % Q4);
            if (row < iend && !row_reached(row, T, L, R)) {
                st4(a.dre + ((long long)row * H + h) * DH + d,
                    make_float4(0.f, 0.f, 0.f, 0.f));
                if (d == 0) a.drb[row * H + h] = 0.f;
            }
        }
    }

    for (int oa = -L; oa <= R; oa += OC) {
        const int nx = min(OC, R + 1 - oa);
        const int lo = max(0, i0 - max(0, oa + nx - 1));
        const int hi = min(T, i0 + TQ + max(0, -oa));
        float tab[4] = {0.f, 0.f, 0.f, 0.f};
        float tab_b = 0.f;
        for (int r0 = lo; r0 < hi; r0 += RC) {
            __syncthreads();   // the previous tile is no longer read
            stage<DH>(a, s, b, h, r0, oa);
            __syncthreads();

            // p and ds of the cells the block reads; zero elsewhere
            for (int cell = tid; cell < RC * OC; cell += NTHREADS) {
                const int r = cell / OC, x = cell % OC;
                const int i = r0 + r, o = oa + x, j = i + o;
                const bool need = i < T && j >= 0 && j < T && x < nx
                    && ((i >= i0 && i < iend) || (j >= i0 && j < iend)
                        || (i == i0 - 1 && o >= 2));
                float p = 0.f, ds = 0.f;
                if (need) {
                    const float* qs = o <= 0 ? s.q[r] : s.q[r + 1];
                    float sc = 0.f, dp = 0.f;
#pragma unroll 4
                    for (int d = 0; d < DH; d += 4) {
                        sc += dot4(ld4(&s.q[r][d]), ld4(&s.k[r + x][d]))
                            + dot4(ld4(qs + d), ld4(&s.e[x][d]));
                        dp += dot4(ld4(&s.go[r][d]), ld4(&s.v[r + x][d]));
                    }
                    sc = (sc + s.uk[r + x] + s.eb[x]) * scale;
                    p = expf(sc - s.lse[r]);
                    ds = p * (dp - s.di[r]) * scale;
                }
                s.p[r][x] = p;
                s.ds[r][x] = ds;
            }
            __syncthreads();

            const int i = i0 + ro;       // own row, and own key j = i
            if (i < iend) {
                // dq: the row's cells (AC, and the own BD part at o <= 0)
                const int r = i - r0;
                if (r >= 0 && r < RC) {
#pragma unroll 4
                    for (int x = 0; x < nx; ++x) {
                        const float g = s.ds[r][x];
#pragma unroll
                        for (int n = 0; n < NC; ++n)
                            fma4(dq_ac + 4 * n, g, ld4(&s.k[r + x][32 * n + 4 * c]));
                    }
#pragma unroll 4
                    for (int x = 0; x < min(nx, 1 - oa); ++x) {
                        const float g = s.ds[r][x];
#pragma unroll
                        for (int n = 0; n < NC; ++n)
                            fma4(dq_bd + 4 * n, g, ld4(&s.e[x][32 * n + 4 * c]));
                    }
                }
                // the wrap share of row i - 1 (o >= 2)
                if (r - 1 >= 0 && r - 1 < RC) {
#pragma unroll 4
                    for (int x = max(0, 2 - oa); x < nx; ++x) {
                        const float g = s.ds[r - 1][x];
#pragma unroll
                        for (int n = 0; n < NC; ++n)
                            fma4(dq_bd + 4 * n, g, ld4(&s.e[x][32 * n + 4 * c]));
                    }
                }
                // dk, dv: the cells of key i, rows i - o in the tile
                const int xlo = max(0, i - oa - r0 - RC + 1);
                const int xhi = min(nx, i - oa - r0 + 1);
#pragma unroll 4
                for (int x = xlo; x < xhi; ++x) {
                    const int rr = i - oa - x - r0;
                    const float p = s.p[rr][x], g = s.ds[rr][x];
                    gsum += g;
#pragma unroll
                    for (int n = 0; n < NC; ++n) {
                        fma4(dv + 4 * n, p, ld4(&s.go[rr][32 * n + 4 * c]));
                        fma4(dk + 4 * n, g, ld4(&s.q[rr][32 * n + 4 * c]));
                    }
                }
            }

            // table partial of offset oa + tx over the own rows in the tile
            if (tid < OC * Q4 && tx < nx) {
                const int sel = oa + tx <= 0 ? 0 : 1;      // q_i or q_{i+1}
                const int rhi = min(iend, r0 + RC) - r0;
#pragma unroll 4
                for (int r = max(i0, r0) - r0; r < rhi; ++r) {
                    const float g = s.ds[r][tx];
                    fma4(tab, g, ld4(&s.q[r + sel][td]));
                    tab_b += g;
                }
            }
        }
        if (tid < OC * Q4 && tx < nx) {
            float* dst = part + (oa + L + tx) * PW;
            st4(dst + td, make_float4(tab[0], tab[1], tab[2], tab[3]));
            if (td == 0) dst[DH] = tab_b;
        }
    }

    // dq, dk, dv of the own rows and keys, once
    const int i = i0 + ro;
    if (i < iend) {
        const long long at = (((long long)b * T + i) * H + h) * DH;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int col = 32 * n + 4 * c;
            const float* ac = dq_ac + 4 * n;
            const float* bd = dq_bd + 4 * n;
            const float* gk = dk + 4 * n;
            const float* gv = dv + 4 * n;
            const float4 u4 = ldg4(a.u + h * DH + col);
            st4(a.dq + at + col, make_float4(ac[0] + bd[0], ac[1] + bd[1],
                                             ac[2] + bd[2], ac[3] + bd[3]));
            st4(a.dk + at + col, make_float4(gk[0] + gsum * u4.x, gk[1] + gsum * u4.y,
                                             gk[2] + gsum * u4.z, gk[3] + gsum * u4.w));
            st4(a.dv + at + col, make_float4(gv[0], gv[1], gv[2], gv[3]));
        }
    }

    // the block's d u: its rows' AC part of dq, summed in row order
    __syncthreads();
    float (*red)[Smem<DH>::LD] = s.go;               // TQ <= RC rows
#pragma unroll
    for (int n = 0; n < NC; ++n)
        st4(&red[ro][32 * n + 4 * c], make_float4(dq_ac[4 * n], dq_ac[4 * n + 1],
                                                  dq_ac[4 * n + 2], dq_ac[4 * n + 3]));
    __syncthreads();
    if (tid <= DH) {
        float sum = 0.f;
        if (tid < DH)
            for (int r = 0; r < TQ; ++r) sum += red[r][tid];
        part[W * PW + tid] = sum;
    }
}

// Table gradients from the blocks' partials: block (x, h) sums, over the
// blocks in order, the partials of offset o = x - left into the table row
// it reads, d re[row, h] and d rb[row, h], together with those of the other
// offset that reads the same row, if it is in the band (the block of the
// offset <= 0 takes both); block x = W sums d u.
template <int DH>
__global__ void __launch_bounds__(NTHREADS)
banded_bwd_tables(Args a, int nblk) {
    constexpr int PW = DH + 4;
    constexpr int NCOL = (DH + 1 + 31) / 32;
    __shared__ float red[RED_WARPS][DH + 1];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int x = blockIdx.x, h = blockIdx.y;
    const int T = a.T, L = a.left, R = a.right, W = L + R + 1;
    const int o = x - L;
    const int row = x < W ? bd_row(T, o) : -1;
    int x1 = x, x2 = -1;                  // partial rows, offset + left
    if (x < W) {
        if (row < 0 || (o >= 2 && row - (T - 1) >= -L)) return;
        if (o <= 0 && row + 2 <= R) x2 = row + 2 + L;
    }
    float acc[NCOL];
#pragma unroll
    for (int m = 0; m < NCOL; ++m) acc[m] = 0.f;
    for (int blk = w; blk < nblk; blk += RED_WARPS) {
        const float* src = a.part + ((long long)blk * a.H + h) * (W + 1) * PW;
#pragma unroll
        for (int m = 0; m < NCOL; ++m) {
            const int col = lane + 32 * m;
            if (col > DH) continue;
            acc[m] += src[x1 * PW + col];
            if (x2 >= 0) acc[m] += src[x2 * PW + col];
        }
    }
#pragma unroll
    for (int m = 0; m < NCOL; ++m)
        if (lane + 32 * m <= DH) red[w][lane + 32 * m] = acc[m];
    __syncthreads();
    if (tid > DH) return;
    float sum = 0.f;
    for (int y = 0; y < RED_WARPS; ++y) sum += red[y][tid];
    if (x == W) {
        if (tid < DH) a.du[h * DH + tid] = sum;
    } else if (tid < DH) {
        a.dre[((long long)row * a.H + h) * DH + tid] = sum;
    } else {
        a.drb[row * a.H + h] = sum;
    }
}

int n_tiles(int T) { return (T + TQ - 1) / TQ; }

template <int DH>
int launch(const Args& a, cudaStream_t stream) {
    const int smem = (int)sizeof(Smem<DH>);
    cudaError_t err = cudaFuncSetAttribute(
        banded_bwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    banded_bwd<DH><<<dim3(n_tiles(a.T), a.H, a.B), NTHREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    banded_bwd_tables<DH><<<dim3(a.left + a.right + 2, a.H), NTHREADS, 0, stream>>>(
        a, a.B * n_tiles(a.T));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the scratch the backward takes for its table partials.
long long ttx_banded_attention_bwd_scratch(int B, int T, int H, int Dh, int left,
                                           int right) {
    return (long long)B * n_tiles(T) * H * (left + right + 2) * (Dh + 4);
}

int ttx_banded_attention_bwd(const void* q, const void* k, const void* v,
                             long long sq, long long sk, long long sv,
                             const void* re, const void* u, const void* rb,
                             const void* out, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* dre, void* du, void* drb, void* part, int B,
                             int T, int H, int Dh, int left, int right,
                             void* stream) {
    Args a = {};
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
    a.part = static_cast<float*>(part);
    a.B = B; a.T = T; a.H = H;
    a.left = left; a.right = right;
    return with_head_dim(Dh, [&](auto dh) {
        return launch<decltype(dh)::value>(a, static_cast<cudaStream_t>(stream));
    });
}

}  // extern "C"
