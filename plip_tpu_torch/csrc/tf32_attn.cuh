// Building blocks of the key-tiled attention cores off wgmma (csrc/mha.cu's
// tiled_fwd_kernel, csrc/mha_bwd.cu's tiled_bwd_rows_kernel and
// tiled_bwd_keys_kernel): fp32, and bf16 at every head_dim but the 64 that
// runs on wgmma, on the tensor cores' TF32 products with fp32 sums.
//
// - fp32 operands go in as three TF32 products, big . big + big . small +
//   small . big, where big is the value with its low 13 mantissa bits
//   cleared and small what is left (cleared the same way): the split that
//   PyTorch's fp32 SDPA takes (cutlass's OpMultiplyAddFastF32), each product
//   exact, about fp32's precision in the sum. bf16 values are TF32 values
//   already (their low 16 bits are zero), so bf16 operands (q, k, v, g and
//   the bf16-rounded P, dS, e_c, q / denom, g / denom) take one exact
//   product.
// - mma.sync.m16n8k8 with the operands from row-major fp32 tiles in shared
//   memory: 64 keys (or query rows) by a chunk of kDc head columns (64, or
//   128 for a head wider than 64; a head wider than 128 goes a chunk at a
//   time), rows kDc + 4 floats apart, zero at and past D and the sequence.
//   warp_mma takes either operand as stored (row-major in its M or N, or
//   k-major) so that q . k^T, g . v^T (both k-contiguous), P . v, dS . k
//   (P, dS row-major, v, k k-major) and P^T . g, dS^T . q (P, dS k-major)
//   read the tiles as they lie: no transpose anywhere.
// - Every output is the same sequence of products over k in ascending order,
//   whichever warp computes it: the backward's two kernels rebuild the same
//   logits and dp bit for bit. A sum over a head's columns runs 64 columns
//   to an accumulator, the partial sums added in IEEE fp32 (warp_mma_nt); a
//   sum over keys or query rows runs a tile (64 or 32) to an accumulator.
// - A thread's outputs are the accumulator fragment of m16n8k8: rows g and
//   g + 8 of the warp's 16 (g = lane / 4), columns 2 t and 2 t + 1 of each
//   8-column tile (t = lane % 4). A row lies in the 4 lanes of a quad, so a
//   row's statistics are each thread's values, then two shuffles (max4,
//   sum4), and a thread reads back only the strip elements it wrote.
// - Tiles come by cp.async (fp32: 16 bytes where the head's columns and
//   pointer allow, else 4), or through registers (bf16, converted; q scaled),
//   into a two-stage ring that the kernels walk item by item: the next item's
//   tiles are in flight while this one is computed.

#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace plip {
namespace tc {

constexpr int kKT = 64;           // keys a tile
constexpr int kDo = 64;           // output columns a pass (ctx, dq, dk, dv)
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper (227 KB)
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int ld_tile(int dc) { return dc + 4; }
// Strip rows: 4 mod 32 floats apart, so that the 8 rows of an A fragment hit
// 8 bank groups.
__host__ __device__ constexpr int ld_strip(int keys) { return keys + 4; }
// The keys a strip row holds: a window of win_tiles key tiles, or every key
// of the sequence rounded up to 32 if fewer.
__host__ __device__ inline int strip_keys(int win_tiles, int S) {
  const int all = (S + 31) & ~31;
  return kKT * win_tiles < all ? kKT * win_tiles : all;
}
// The head's columns of chunk c (dc wide) that the products sum, rounded up
// to 8 (the tiles are zero past D).
__device__ __forceinline__ int chunk_k(int D, int c, int dc) {
  return (min(dc, D - c * dc) + 7) & ~7;
}

// The thread's place in an m16n8k8 fragment.
struct Frag {
  int w, g, t;
  __device__ Frag() : w(threadIdx.x >> 5), g((threadIdx.x >> 2) & 7), t(threadIdx.x & 3) {}
  // row and column of accumulator element e of tile (m, n), in the warp's tile
  __device__ int row(int m, int e) const { return 16 * m + g + 8 * (e >> 1); }
  __device__ int col(int n, int e) const { return 8 * n + 2 * t + (e & 1); }
};

template <int kM, int kN>
__device__ __forceinline__ void zero(float (&acc)[kM][kN][4]) {
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
}

template <int kM, int kN>
__device__ __forceinline__ void add(float (&acc)[kM][kN][4], const float (&x)[kM][kN][4]) {
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += x[m][n][e];
}

__device__ __forceinline__ uint32_t tf32_big(float x) { return __float_as_uint(x) & 0xffffe000u; }
__device__ __forceinline__ uint32_t tf32_small(float x) {
  return __float_as_uint(x - __uint_as_float(tf32_big(x))) & 0xffffe000u;
}

// d += a . b, m16n8k8, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's acc[m][n] += sum_{k < nk} A(16 m + row, k) B(k, 8 n + col) over
// its kM x kN tiles of 16 x 8 and the live column tiles n < nl (uniform in
// the warp); nk a multiple of 8. A(r, k) is A[k * lda + r] (kAT: A stored
// k-major) or A[r * lda + k]; B(k, c) is B[c * ldb + k] (kBT: B stored with
// its columns as rows, as k in q . k^T) or B[k * ldb + c]. kSplit: the
// operands are fp32 (three TF32 products), else bf16 values (one).
template <bool kAT, bool kBT, int kM, int kN, bool kSplit>
__device__ __forceinline__ void warp_mma(float (&acc)[kM][kN][4], const float* __restrict__ A,
                                         int lda, const float* __restrict__ B, int ldb, int nk,
                                         int nl) {
  const Frag f;
  for (int k = 0; k < nk; k += 8) {
    uint32_t ab[kM][4], as[kM][4], bb[kN][2], bs[kN][2];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // (row g + 8 (r % 2), column t + 4 (r / 2))
        const int i = 16 * m + f.g + 8 * (r & 1), kk = k + f.t + 4 * (r >> 1);
        const float x = kAT ? A[kk * lda + i] : A[i * lda + kk];
        ab[m][r] = tf32_big(x);
        as[m][r] = kSplit ? tf32_small(x) : 0u;
      }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // (row t + 4 r, column g); dead tiles read zeros or stale
        const int c = 8 * n + f.g, kk = k + f.t + 4 * r;
        const float y = n < nl ? (kBT ? B[c * ldb + kk] : B[kk * ldb + c]) : 0.f;
        bb[n][r] = tf32_big(y);
        bs[n][r] = kSplit ? tf32_small(y) : 0u;
      }
    // the small products first, each pass over every tile: no product waits
    // on the one before it
    if (kSplit) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (n < nl) mma_tf32(acc[m][n], as[m], bb[n]);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (n < nl) mma_tf32(acc[m][n], ab[m], bs[n]);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        if (n < nl) mma_tf32(acc[m][n], ab[m], bb[n]);
  }
}

// warp_mma of q . k^T or g . v^T (A and B both k-contiguous rows) over a
// head's columns: each 64 of them summed into a fresh accumulator and added
// to acc in IEEE fp32, as the bf16 wgmma kernels add their tiles, so a wide
// head's logits do not drift further from the plain version's fp32 sums.
template <int kM, int kN, bool kSplit>
__device__ __forceinline__ void warp_mma_nt(float (&acc)[kM][kN][4], const float* __restrict__ A,
                                            int lda, const float* __restrict__ B, int ldb,
                                            int nk, int nl) {
  for (int k = 0; k < nk; k += 64) {
    float part[kM][kN][4];
    zero(part);
    warp_mma<false, true, kM, kN, kSplit>(part, A + k, lda, B + k, ldb, min(64, nk - k), nl);
    add(acc, part);
  }
}

// Max and sum over the 4 lanes of a quad (the lanes that hold one row of an
// accumulator): a butterfly, so every lane gets the same bits.
__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r0 .. r0 + kRows - 1 and columns c0 .. c0 + kCols - 1 of one head's
// block in global memory (src at its row 0, column 0; ld elements a row)
// into dst [kRows][ldd] fp32, zero at rows >= r_end or columns >= c_end (the
// head's D), by kThreads threads. fp32 by cp.async (not waited for here), 16
// bytes where `vec` (D, the row stride and the pointer multiples of 4
// floats); bf16 through registers, four values a load where `vec`.
template <typename T, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const T* __restrict__ src,
                                          size_t ld, int r0, int r_end, int c0, int c_end,
                                          bool vec) {
  constexpr int kChunks = kRows * kCols / 4;  // 4 columns each
  for (int e = threadIdx.x; e < kChunks; e += kThreads) {
    const int rr = e / (kCols / 4), cc = 4 * (e % (kCols / 4));
    const int r = r0 + rr, c = c0 + cc;
    float* d = dst + rr * ldd + cc;
    const T* p = src + (size_t)(r < r_end ? r : 0) * ld + c;
    if constexpr (std::is_same<T, float>::value) {
      const uint32_t a = hopper::smem_u32(d);
      if (vec) {
        const bool ok = r < r_end && c < c_end;
        hopper::cp_async16(a, ok ? p : src, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = r < r_end && c + u < c_end;
          hopper::cp_async4(a + 4 * u, ok ? p + u : src, ok);
        }
      }
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < r_end) {
        if (vec) {
          if (c < c_end) {
            const uint2 raw = *reinterpret_cast<const uint2*>(p);
            const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
            const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
            v = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                            __high2float(hi));
          }
        } else {
          v.x = c < c_end ? to_f(p[0]) : 0.f;
          v.y = c + 1 < c_end ? to_f(p[1]) : 0.f;
          v.z = c + 2 < c_end ? to_f(p[2]) : 0.f;
          v.w = c + 3 < c_end ? to_f(p[3]) : 0.f;
        }
      }
      *reinterpret_cast<float4*>(d) = v;
    }
  }
}

// load_tile through registers for both dtypes, each value times `mul` and
// rounded to T (K3's, K5's and K12's q * D^-1/2, cast before the dot).
template <typename T, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_tile_scaled(float* dst, int ldd, const T* __restrict__ src,
                                                 size_t ld, int r0, int r_end, int c0,
                                                 int c_end, float mul) {
  constexpr int kChunks = kRows * kCols / 4;
  for (int e = threadIdx.x; e < kChunks; e += kThreads) {
    const int rr = e / (kCols / 4), cc = 4 * (e % (kCols / 4));
    const int r = r0 + rr, c = c0 + cc;
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = r < r_end && c + u < c_end ? round_to<T>(to_f(src[(size_t)r * ld + c + u]) * mul)
                                        : 0.f;
    *reinterpret_cast<float4*>(dst + rr * ldd + cc) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory) once per kernel and
// device: `ready` is the caller's (one static array per instantiation).
template <typename K>
cudaError_t allow_smem(K* kernel, int (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = 1;
  return err;
}

}  // namespace tc
}  // namespace plip
