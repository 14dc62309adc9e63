// Banded rel-position self-attention forward for Hopper (sm_90a), fp32.
//
// Replaces ops/pallas/banded_attention.py :: banded_attention forward
// (_fwd_impl, _band_kernel) -- ttx_banded_attention_fwd below.  Its
// backward is csrc/banded_attention_bwd.cu; the full-context (flash)
// kernels, on the tensor cores, are csrc/flash_rel_attention_fwd.cu and
// csrc/flash_rel_attention_bwd.cu.
//
// All of them compute one score rule (models/attention.py dense branch),
// with the tables already sliced to T rows, o = j - i and scale = 1/sqrt(Dh):
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
// and only cells with j >= T+1 (never live) would read it.  The forward
// saves the row log-sum-exp (when it is given somewhere to put it), from
// which the backward recomputes the probabilities.
//
// Bound on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 without tensor
// cores), at the flagship serving shape B=8, T=410, H=8, Dh=64, band
// (left 10, right 2): q, k, v and the tables read once and the output
// written once, about 28 MB, 8.3 us; 6 Dh FLOP per live cell, 0.13 GFLOP.
// Under 5 FLOP a byte: the bytes bound it, and the tensor cores would not
// move the bound, so this stays fp32 SIMT, as exact as before.
//
// The kernel this one replaces staged dense chunks of 64 keys and the 95
// table rows of all their offsets for a block of 32 rows, scored all
// 32 x 64 cells where 32 x 13 are live at the flagship band, ran p.v over
// every key of the window, and took 87 KB of shared memory (two blocks an
// SM): 0.0635 ms on an H100.  Timed with each part cut back in turn, scoring
// only the live cells took 21 % off, staging only the live table rows 12 %,
// p.v over the live keys 3 %, the three together 45 %, and a table tile
// small enough for three blocks an SM 9 % more.  This design:
//   * A block owns TQ = 32 query rows of one (b, h), 8 threads a row.  It
//     walks the band's offsets o in chunks [oa, oa + OC), OC = 16: one
//     chunk at the flagship band, up to 9 at left = right = 64, with an
//     online softmax (running max, sum, Dh/8-wide accumulator) across them.
//   * A chunk stages the TQ + OC - 1 keys and values its cells reach, u.k_j
//     for each of them (so AC is q_i.k_j + u.k_j, with no q + u tile), and
//     only the OC table rows and r_bias of its offsets; the block's q rows,
//     one more for the wrap term q_{i+1} (zero past T), once.  16-byte
//     cp.async copies, every one issued before the first is waited for,
//     zero-filled off the sequence, past the band's right edge and at
//     o == 1.  Rows padded to Dh + 4 floats: 16-byte aligned and free of
//     bank conflicts.  About 41 KB of shared memory at Dh = 64.
//   * Each thread scores two cells of its row, offsets oa + c and
//     oa + c + 8, and only cells inside the band and the sequence count;
//     p.v then runs over the chunk's offsets with v_{i+o}, each thread
//     holding Dh/8 output columns in registers.
//   * One output store a row, and one log-sum-exp store when asked: no
//     atomics, no memsets, no scratch; two launches give the same bits.
// It reads 0.0197 ms there, 42 % of the bound: staging alone runs at the
// bound, the cell products add about 9 us and p.v 3 us.  Neither more
// blocks an SM, nor 16-row blocks, nor persistent blocks that copy the next
// chunk while working on this one, nor half the shared loads a cell (four
// rows and two offsets a lane) made it faster on an H100.
//
// Plain C interface (loaded with ctypes).  The kernel runs on the caller's
// stream, allocates nothing and returns cudaGetLastError() after the launch.

#include "tensor_core.cuh"

namespace {

using namespace ttx;

constexpr int TQ = 32;              // query rows a block owns
constexpr int OC = 16;              // offsets a chunk
constexpr int NK = TQ + OC - 1;     // keys a chunk's cells reach
constexpr int NTHREADS = 256;       // 8 threads a row
constexpr int LDP = OC + 8;         // a warp's 4 rows on distinct banks
constexpr float NEG = -1e30f;

struct Args {
    const float* q;       // q[b, t, h, d] at q + (b*T + t)*sq + h*Dh + d
    const float* k;
    const float* v;
    long long sq, sk, sv; // row strides (elements between consecutive t)
    const float* re;      // (T, H, Dh) contiguous, sliced to T rows
    const float* u;       // r_w_bias (H, Dh)
    const float* rb;      // r_bias (T, H)
    float* out;           // (B, T, H, Dh) contiguous
    float* lse;           // (B, H, T) row log-sum-exp, or null
    int B, T, H;
    int left, right;      // band
};

template <int DH>
struct __align__(16) Smem {
    static constexpr int LD = DH + 4;
    float q[TQ + 1][LD];    // q rows i0 .. i0 + TQ (the last for q_{i+1})
    float k[NK][LD];        // keys i0 + oa .. i0 + oa + NK - 1
    float v[NK][LD];
    float e[OC][LD];        // table rows of offsets oa .. oa + OC - 1
    float eb[OC];           // their r_bias
    float uk[NK];           // u . k_j
    float p[TQ][LDP];       // cell (row i0 + r, offset oa + x)
};

// The block's q rows, zero from T on (issued, not waited for).
template <int DH>
__device__ __forceinline__ void stage_q(const Args& a, Smem<DH>& s, int b, int h, int i0) {
    constexpr int Q4 = DH / 4;
    for (int idx = threadIdx.x; idx < (TQ + 1) * Q4; idx += NTHREADS) {
        const int r = idx / Q4, d = 4 * (idx % Q4), i = i0 + r;
        const long long row = (long long)b * a.T + min(i, a.T - 1);
        cp16(&s.q[r][d], a.q + row * a.sq + h * DH + d, i < a.T);
    }
}

// The chunk of offsets [oa, oa + OC): its keys and values (zero off the
// sequence) and its table rows and r_bias (zero past the band's right edge,
// at o == 1 and off the table); then, with the q rows, waited for, and
// u . k_j of its keys.
template <int DH>
__device__ __forceinline__ void stage_chunk(const Args& a, Smem<DH>& s, int b, int h,
                                            int i0, int oa, float4 u4) {
    constexpr int Q4 = DH / 4;
    const int T = a.T, tid = threadIdx.x;
    for (int idx = tid; idx < NK * Q4; idx += NTHREADS) {
        const int kk = idx / Q4, d = 4 * (idx % Q4), j = i0 + oa + kk;
        const bool ok = j >= 0 && j < T;
        const long long row = (long long)b * T + min(max(j, 0), T - 1);
        cp16(&s.k[kk][d], a.k + row * a.sk + h * DH + d, ok);
        cp16(&s.v[kk][d], a.v + row * a.sv + h * DH + d, ok);
    }
    for (int idx = tid; idx < OC * Q4; idx += NTHREADS) {
        const int x = idx / Q4, d = 4 * (idx % Q4), o = oa + x;
        const int row = o <= a.right ? bd_row(T, o) : -1;
        cp16(&s.e[x][d], a.re + ((long long)max(row, 0) * a.H + h) * DH + d, row >= 0);
        if (d == 0) s.eb[x] = row >= 0 ? a.rb[row * a.H + h] : 0.f;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // u . k_j, a sum over the Q4 lanes of a key; the passes run whole warps
    for (int base = 0; base < NK * Q4; base += NTHREADS) {
        const int idx = base + tid, kk = min(idx / Q4, NK - 1), d = 4 * (idx % Q4);
        const float uk = row_sum(dot4(ld4(&s.k[kk][d]), u4), Q4);
        if (idx < NK * Q4 && d == 0) s.uk[kk] = uk;
    }
    __syncthreads();
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
banded_fwd(Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);
    constexpr int NC = DH / 32;          // float4 groups of a row a thread holds
    constexpr int Q4 = DH / 4;

    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
    const int T = a.T, L = a.left, R = a.right;
    const int iend = min(i0 + TQ, T);
    const float scale = 1.0f / sqrtf((float)DH);
    // u's columns 4 (tid % Q4) .. + 3, the same in every pass of the u.k sums
    const float4 u4 = ldg4(a.u + h * DH + 4 * (tid % Q4));

    const int r = tid >> 3, c = tid & 7;  // row i0 + r; offsets oa + c, oa + c + 8
    const int i = i0 + r;
    float m_run = NEG, l_run = 0.f;
    float acc[4 * NC];
#pragma unroll
    for (int x = 0; x < 4 * NC; ++x) acc[x] = 0.f;

    stage_q<DH>(a, s, b, h, i0);
    for (int oa = -L; oa <= R; oa += OC) {
        const int nx = min(OC, R + 1 - oa);
        // a chunk whose keys all lie off the sequence for every row is skipped
        if (iend - 1 + oa + nx - 1 < 0 || i0 + oa >= T) continue;
        __syncthreads();   // the previous chunk is no longer read
        stage_chunk<DH>(a, s, b, h, i0, oa, u4);

        // the two cells of this thread: x = c and c + 8
        bool live[2];
        float sc[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            const int x = c + 8 * n, j = i + oa + x;
            live[n] = i < T && x < nx && j >= 0 && j < T;
            sc[n] = 0.f;
        }
        const bool own0 = oa + c <= 0, own1 = oa + c + 8 <= 0;   // q_i, else q_{i+1}
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
            const float4 qi = ld4(&s.q[r][d]);
            const float4 qn = ld4(&s.q[r + 1][d]);
            sc[0] += dot4(qi, ld4(&s.k[r + c][d])) + dot4(own0 ? qi : qn, ld4(&s.e[c][d]));
            sc[1] += dot4(qi, ld4(&s.k[r + c + 8][d]))
                   + dot4(own1 ? qi : qn, ld4(&s.e[c + 8][d]));
        }
        float cmax = NEG;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            const int x = c + 8 * n;
            sc[n] = (sc[n] + s.uk[r + x] + s.eb[x]) * scale;
            if (live[n]) cmax = fmaxf(cmax, sc[n]);
        }
        cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 2));
        cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 4));
        const float m_new = fmaxf(m_run, cmax);
        const float alpha = expf(m_run - m_new);
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            const float p = live[n] ? expf(sc[n] - m_new) : 0.f;
            s.p[r][c + 8 * n] = p;
            psum += p;
        }
        psum = row_sum(psum, 8);
        l_run = l_run * alpha + psum;
        m_run = m_new;
#pragma unroll
        for (int x = 0; x < 4 * NC; ++x) acc[x] *= alpha;
        __syncwarp();   // row r's probabilities come from this warp's lanes

        // p . v over the chunk's offsets: key i + oa + x is staged row r + x
#pragma unroll 4
        for (int x = 0; x < nx; ++x) {
            const float p = s.p[r][x];
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float4 v4 = ld4(&s.v[r + x][32 * n + 4 * c]);
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
int launch_fwd(const Args& a, cudaStream_t stream) {
    const int smem = (int)sizeof(Smem<DH>);
    cudaError_t err = cudaFuncSetAttribute(
        banded_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.T + TQ - 1) / TQ, a.H, a.B);
    banded_fwd<DH><<<grid, NTHREADS, smem, stream>>>(a);
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

const char* ttx_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
