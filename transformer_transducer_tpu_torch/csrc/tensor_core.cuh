// Helpers shared by the rel-position attention kernels (sm_90a): the head
// widths they are built for, float4 access, 16-byte cp.async copies, the BD
// table row of an offset, and the warp-level TF32 tensor-core products in
// 3xTF32 that the flash kernels (csrc/flash_rel_attention_fwd.cu,
// csrc/flash_rel_attention_bwd.cu) are made of.
//
// 3xTF32: an fp32 operand x is split into hi = x rounded to TF32 (to
// nearest, ties away: the bits of cvt.rna.tf32.f32, taken by integer
// arithmetic, split()) and lo = cvt.rna.tf32(x - hi), and each product adds
// lo.hi' + hi.lo' + hi.hi' in fp32.  hi carries 11 significant bits and lo
// the next 11, so the dropped lo.lo' term and the rounding of lo are below
// 2^-21 relative to each term, against 2^-11 for one TF32 product (which
// misses the card tolerance, atol 1e-4 max|ref|, by about 20x at K = 64;
// tests/test_torch_port_flash_bwd_tiles.py emulates both).  Both halves are
// rounded: fed raw fp32, the tensor core drops the low 13 bits.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32): lane 4g + t holds A rows g, g+8
// at columns t, t+4, B rows t, t+4 at column g, and C rows g, g+8 at
// columns 2t, 2t+1.  A view gives the element for (k, h, i) -- A (m0 + g +
// 8i, k + t + 4h), or B (k + t + 4h, n0 + g + 8i) -- from addresses worked
// out once per product.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ttx {

constexpr unsigned FULL = 0xffffffffu;

// The head widths every attention kernel is instantiated for.
constexpr int HEAD_DIMS[] = {32, 64};
constexpr int N_HEAD_DIMS = sizeof(HEAD_DIMS) / sizeof(HEAD_DIMS[0]);

// f(std::integral_constant<int, DH>) for a width the kernels are built for,
// else cudaErrorInvalidValue.
template <class F>
int with_head_dim(int dh, F f) {
    switch (dh) {
        case 32: return f(std::integral_constant<int, 32>{});
        case 64: return f(std::integral_constant<int, 64>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// 16 bytes from global to shared memory without a register round trip,
// zeros where ok is false (src then only has to be a valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

// Table row of offset o = j - i, or -1 (o == 1, or outside the T rows).
__device__ __forceinline__ int bd_row(int T, int o) {
    const int row = o <= 0 ? T - 1 + o : o - 2;
    return (o == 1 || row < 0 || row >= T) ? -1 : row;
}

// hi: x rounded to TF32 to nearest, ties away from zero, on the bits.  For
// every x but a NaN these are the bits of cvt.rna.tf32.f32, without the
// Inf/NaN guard ptxas wraps around it; a NaN x gets a finite hi, but its lo
// is NaN, so its products stay NaN.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// (hi, lo) of x as two floats, for a tile stored split.
__device__ __forceinline__ float2 split2(float x) {
    unsigned hi, lo;
    split(x, hi, lo);
    return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Row and column of element e of tile j of a warp's accumulator.
__device__ __forceinline__ int c_row(int m0, int e) {
    return m0 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int c_col(int n0, int j, int e) {
    return n0 + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// ---- fp32 tiles, split as their fragments are loaded (the backward)

// Tiles of W floats a row, the column swizzled by the row's low 3 bits:
// (row & 3) picks one of four 8-bank groups, (row & 4) a half of it, so a
// fragment load is free of bank conflicts whether its 8 lane groups walk
// rows and its 4 lanes columns, or the other way round.
__device__ __forceinline__ int swz(int row) { return ((row & 3) << 3) | (row & 4); }

__device__ __forceinline__ int at(int row, int col, int w) { return row * w + (col ^ swz(row)); }

// The tile's rows are the operand's m (or n) index, its columns k: the
// lane's rows x0 + g + 8i share row & 7 and so one swizzle f, and
// (k + c) ^ f = (k ^ (f & 24)) + (c ^ (f & 7)) for c = t + 4h < 8.
template <int W>
struct RowView {
    const float* p[2];
    int s;
    __device__ __forceinline__ RowView(const float* tile, int x0) {
        const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
        const int f = swz(x0 + g);
        p[0] = tile + (x0 + g) * W + (t ^ (f & 7));
        p[1] = tile + (x0 + g) * W + ((t + 4) ^ (f & 7));
        s = f & 24;
    }
    __device__ __forceinline__ float operator()(int k, int h, int i) const {
        return p[h][8 * i * W + (k ^ s)];
    }
};

// The tile's rows are the operand's k index (shifted by rs), its columns m
// (or n): the lane's rows k + t + 4h + rs share row & 7 for every k.
template <int W, int NI>
struct KView {
    const float* p[2][NI];
    __device__ __forceinline__ KView(const float* tile, int x0, int rs = 0) {
        const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = t + 4 * h + rs;
#pragma unroll
            for (int i = 0; i < NI; ++i)
                p[h][i] = tile + row * W + ((x0 + g + 8 * i) ^ swz(row));
        }
    }
    __device__ __forceinline__ float operator()(int k, int h, int i) const {
        return p[h][i][k * W];
    }
};

// One 8-deep step of a warp's tile product in 3xTF32: c[j] += lo.hi' +
// hi.lo' + hi.hi' for the tiles j at columns n0 + 8j, the small terms
// first.  The tiles interleave, so consecutive mma of a step are
// independent.
template <int NT, class FA, class FB>
__device__ __forceinline__ void mma_step(float (&c)[NT][4], const FA& A, const FB& B, int k) {
    unsigned ah[4], al[4], bh[NT][2], bl[NT][2];
    split(A(k, 0, 0), ah[0], al[0]);
    split(A(k, 0, 1), ah[1], al[1]);
    split(A(k, 1, 0), ah[2], al[2]);
    split(A(k, 1, 1), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        split(B(k, 0, j), bh[j][0], bl[j][0]);
        split(B(k, 1, j), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], ah, bh[j]);
}

// c[j] += A[m0:m0+16, 0:K] . B[0:K, n0+8j:n0+8j+8], one warp, A and B
// views (or masks of views) placed at m0 and n0.
template <int K, int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const FA& A, const FB& B) {
#pragma unroll
    for (int k = 0; k < K; k += 8) mma_step(c, A, B, k);
}

// The same over k in [k_lo, k_hi), multiples of 8 known only at run time.
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma_range(float (&c)[NT][4], const FA& A, const FB& B,
                                               int k_lo, int k_hi) {
#pragma unroll 2
    for (int k = k_lo; k < k_hi; k += 8) mma_step(c, A, B, k);
}

// Add a warp's accumulator tiles to memory as float4 atomics: lanes 2s and
// 2s+1 swap halves, so each holds four columns of one row.  dst(row) gives
// the row's first float in memory, or nullptr for a row that adds nothing.
template <int NT, class F>
__device__ __forceinline__ void emit_rows(const float (&c)[NT][4], int m0, int n0, F dst) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const bool odd = t & 1;
    float* base = dst(m0 + g + (odd ? 8 : 0));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const float r0 = __shfl_xor_sync(FULL, odd ? c[j][0] : c[j][2], 1);
        const float r1 = __shfl_xor_sync(FULL, odd ? c[j][1] : c[j][3], 1);
        const float4 x = odd ? make_float4(r0, r1, c[j][2], c[j][3])
                             : make_float4(c[j][0], c[j][1], r0, r1);
        if (base != nullptr)
            atomicAdd(reinterpret_cast<float4*>(base + n0 + 8 * j + 4 * (t >> 1)), x);
    }
}

// ---- tiles stored split, (hi, lo) per element (the forward)

// Tiles of W (hi, lo) pairs a row.  A pair is 8 bytes and a warp's 64-bit
// load is served 16 lanes at a time, 4 rows x 4 neighbouring columns (both
// the A and the B pattern): swizzling the column by (row & 3) << 2 puts the
// 4 rows in the four 8-bank groups.  W is a multiple of 16.
__device__ __forceinline__ int sw2(int row) { return (row & 3) << 2; }

__device__ __forceinline__ int at2(int row, int col, int w) { return row * w + (col ^ sw2(row)); }

// Rows are the operand's m (or n) index, columns its k: as RowView, with
// (k + c) ^ f = (k ^ (f & 8)) + (c ^ (f & 4)) for c = t + 4h < 8.
template <int W>
struct RowView2 {
    const float2* p[2];
    int s;
    __device__ __forceinline__ RowView2(const float2* tile, int x0) {
        const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
        const int f = sw2(x0 + g);
        p[0] = tile + (x0 + g) * W + (t ^ (f & 4));
        p[1] = tile + (x0 + g) * W + ((t + 4) ^ (f & 4));
        s = f & 8;
    }
    __device__ __forceinline__ float2 operator()(int k, int h, int i) const {
        return p[h][8 * i * W + (k ^ s)];
    }
};

// An A fragment (k-step k) of a split tile: ah, al.
template <class FA>
__device__ __forceinline__ void load_a(const FA& A, int k, unsigned (&ah)[4], unsigned (&al)[4]) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        const float2 v = A(k, x >> 1, x & 1);
        ah[x] = __float_as_uint(v.x);
        al[x] = __float_as_uint(v.y);
    }
}

// B fragments of NT tiles (k-step k) of a split tile: bh, bl.
template <int NT, class FB>
__device__ __forceinline__ void load_b(const FB& B, int k, unsigned (&bh)[NT][2],
                                       unsigned (&bl)[NT][2]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float2 v = B(k, h, j);
            bh[j][h] = __float_as_uint(v.x);
            bl[j][h] = __float_as_uint(v.y);
        }
}

// c[j] += the 3xTF32 product of split fragments, small terms first, the
// tiles interleaved.
template <int NT>
__device__ __forceinline__ void mma3(float (&c)[NT][4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[NT][2],
                                     const unsigned (&bl)[NT][2]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], ah, bh[j]);
}

}  // namespace ttx
