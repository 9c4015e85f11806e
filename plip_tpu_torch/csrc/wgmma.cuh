// Hopper building blocks of the port's bf16 kernels (csrc/mha.cu,
// csrc/mha_bwd.cu, K1's one-block core in csrc/attention_sublayer.cu, K2's
// one-block core backward in csrc/attention_sublayer_bwd.cu and the GEMM
// main loop of csrc/wgmma_gemm.cuh), as inline PTX for sm_90a, on 64 x 64
// bf16 tiles:
//
// - The tile in shared memory, with the 128-byte swizzle: row r (128 bytes,
//   one head's D = 64 values) at byte r * 128, its 16-byte chunk c stored at
//   chunk c ^ (r % 8). A tile starts on a 1024-byte boundary. The same tile is
//   a K-major operand of wgmma (its rows are the product's M or N rows: q, k
//   in q . k^T) and an MN-major one (its rows are the product's K: v in P . v,
//   k in dS . k; A or B of A^T . B, as e_c^T . g), with the descriptors
//   below. An MN-major operand wider than 64 is several such tiles side by
//   side along M or N (one 128-byte swizzle atom each); a K-major one taller
//   than 64 rows is tiles stacked row after row.
// - wgmma.mma_async m64n64k16 and m64n128k16, fp32 accumulators, bf16
//   operands: SS (A and B from shared memory; either may be MN-major, the
//   transpose-A and transpose-B bits) and RS (A from registers), with
//   wgmma's fence, commit and wait.
// - A thread's share of an accumulator stored as bf16 pairs, and eight bf16
//   values divided in fp32 and rounded back (the deferred softmax's q /
//   denom and g / denom).
// - The accumulator's layout. Thread t of the warpgroup (warp w = t / 32,
//   lane l, g = l / 4, q = l % 4) holds d[v] (v < 32 at n = 64, v < 64 at
//   n = 128) at row 16 w + g + 8 h and column 8 c + 2 q + e, where c = v / 4,
//   h = (v / 2) % 2, e = v % 2. So a thread holds two rows, and a row is
//   spread over the four lanes of a quad: a row reduction is the thread's own
//   values, then two shuffles.
// - The repack of an accumulator, cast to bf16, into the A fragments of the
//   next product: A's k-step kk (columns 16 kk .. 16 kk + 15) is the four
//   registers {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
//   {d[8kk+6], d[8kk+7]}, each pair packed low column first. No shuffle.
// - The tile ring's copies: cp.async.cg of 16 bytes straight into the
//   swizzled layout, with a source size of 0 (zero fill) for rows or columns
//   past the matrix's end.
//
// Shared memory written by threads (st.shared, or cp.async once waited for)
// is read by wgmma through the async proxy: the writer runs
// fence_proxy_async() before the barrier that publishes the tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace plip {
namespace hopper {

constexpr int kTileBytes = 64 * 128;  // a tile: 64 rows (q rows or keys) of 64 bf16
constexpr int kWarpgroup = 128;       // threads of a warpgroup (a block)

// The first 1024-byte boundary at or after p (the launch adds 1024 bytes of
// slack to the dynamic shared memory).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of chunk c (8 bf16 values) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Descriptors of a swizzled tile at shared address `addr` (the 14-bit field
// holds addr / 16). Bits 16-29: the leading byte offset, bits 32-45: the
// stride byte offset, both in 16-byte units; bits 62-63: 1, the 128-byte
// swizzle. K-major: the 8-row groups of M or N lie 1024 bytes apart (stride
// offset); the k-step of 16 values (32 bytes) stays inside a 128-byte row, so
// the leading offset is unused (1, as CUTLASS sets it) and k-step kk starts at
// addr + 32 kk. MN-major: the 64 N values of a row are one swizzle atom and
// the 8-row groups of K lie 1024 bytes apart; k-step kk (rows 16 kk ..) starts
// at addr + 2048 kk. With N = 64 there is one atom, so both offsets are 1024.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// An MN-major operand wider than one swizzle atom (n = 128: two tiles side by
// side, `atom_bytes` apart): the leading byte offset is the distance from one
// 64-wide atom to the next along M or N, the stride byte offset the 1024
// bytes from one 8-row group of K to the next.
__device__ __forceinline__ uint64_t desc_mnmajor_wide(uint32_t addr, uint32_t atom_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(atom_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across a
// wgmma's issue or its wait (the registers change asynchronously between).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments in registers that an RS wgmma reads
// asynchronously: they stay live (unmoved, unreused) until this point.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

#define PLIP_WGMMA_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PLIP_WGMMA_OUT32(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

// d (+)= A . B, A [64 x 16] and B [16 x 64] both from shared memory; B
// MN-major when kTransB, A when kTransA. accumulate = 0: d = A . B (d's old
// values unread).
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PLIP_WGMMA_D32
      ", %32, %33, p, 1, 1, %36, %35;\n}\n"
      : PLIP_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB), "n"(kTransA));
}

// d += A . B, A [64 x 16] from registers (a: this thread's four packed bf16
// pairs, the layout in the header), B [16 x 64] from shared memory, MN-major
// when kTransB.
template <int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PLIP_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PLIP_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

#define PLIP_WGMMA_D64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define PLIP_WGMMA_OUT64(d)                                                                 \
  PLIP_WGMMA_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),     \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),         \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d += A . B at n = 128: A [64 x 16] and B [16 x 128] both from shared
// memory, A MN-major when kTransA, B MN-major when kTransB (otherwise both
// K-major). d's old values are always added (zero them first).
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PLIP_WGMMA_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : PLIP_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

#undef PLIP_WGMMA_D64
#undef PLIP_WGMMA_OUT64
#undef PLIP_WGMMA_D32
#undef PLIP_WGMMA_OUT32

// d = A . B^T over a full 64-deep tile pair (q . k^T, g . v^T, k . q^T, ...):
// four SS k-steps, both tiles K-major. Issued, not waited for.
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss<0>(d, desc_kmajor(a_tile + 32 * kk), desc_kmajor(b_tile + 32 * kk), kk);
}

// d = A^T . B over a full 64-deep tile pair whose rows are both the
// product's K (e_c^T . g, dS^T . q: rows are queries, A's columns keys, B's
// the head dimension): four SS k-steps, both tiles MN-major. Issued, not
// waited for.
__device__ __forceinline__ void issue_atb(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss<1, 1>(d, desc_mnmajor(a_tile + 2048 * kk), desc_mnmajor(b_tile + 2048 * kk), kk);
}

// d += A . B with A in registers (a[kk]: k-step kk) and B a tile whose rows
// are the product's K (MN-major): four RS k-steps. Issued, not waited for.
__device__ __forceinline__ void issue_ab(float (&d)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<1>(d, a[kk], desc_mnmajor(b_tile + 2048 * kk));
}

// Two fp32 values as a bf16 pair, low column first, each rounded to nearest
// even (as __float2bfloat16).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator d, each value cast to bf16, as the A fragments of the next
// product (the header's repack).
__device__ __forceinline__ void to_a_frags(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Eight bf16 values, each divided by d in fp32 and rounded back.
__device__ __forceinline__ uint4 div_bf16x8(uint4 v, float d) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    w[i] = pack_bf16(__low2float(p) / d, __high2float(p) / d);
  }
  return v;
}

// Stores a thread's share of a 64 x 64 fp32 accumulator as bf16, each value
// f(value, row half hh), for the rows below S: out points at row 0 of the
// tile's columns, ld elements a row.
template <typename F>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, int ld, const float (&d)[32],
                                          int row0, int S, F f) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int v = 0; v < 32; v += 2) {
    const int hh = (v >> 1) & 1, i = row0 + 8 * hh, col = 8 * (v >> 2) + c0;
    if (i < S)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(i) * ld + col) =
          pack_bf16(f(d[v], hh), f(d[v + 1], hh));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r0 .. r0 + 63 of one head's 64 columns into the swizzled tile at
// shared address dst: src points at row 0 of the head's columns, ld elements
// a row (16-byte aligned, as every row start is); rows at or past S are
// zero. Each thread of the warpgroup issues four 16-byte copies; eight
// neighbouring threads copy one row's 128 bytes.
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src, int ld,
                                                int r0, int S) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x % kWarpgroup + kWarpgroup * i, r = e >> 3, c = e & 7, j = r0 + r;
    const bool ok = j < S;
    cp_async16(dst + sw128(r, c), src + static_cast<size_t>(ok ? j : 0) * ld + c * 8, ok);
  }
}

// A 64 x 64 tile of a row-major bf16 matrix (ld elements a row, every row
// start 16-byte aligned) into the swizzled tile at shared address dst: rows
// r0 .. r0 + 63, columns c0 .. c0 + 63. Rows at or past r_end and 8-column
// chunks at or past c_end (a multiple of 8, or past the last chunk) are
// zero. kThreads threads (a multiple of 128) from thread 0 share the copies;
// eight neighbouring threads copy one row's 128 bytes.
template <int kThreads>
__device__ __forceinline__ void load_tile_2d(uint32_t dst, const __nv_bfloat16* src, int ld,
                                             int r0, int r_end, int c0, int c_end) {
#pragma unroll
  for (int i = 0; i < 512 / kThreads; ++i) {
    const int e = threadIdx.x % kThreads + kThreads * i, r = e >> 3, c = e & 7;
    const int row = r0 + r, col = c0 + 8 * c;
    const bool ok = row < r_end && col < c_end;
    cp_async16(dst + sw128(r, c), src + (ok ? static_cast<size_t>(row) * ld + col : 0), ok);
  }
}

}  // namespace hopper
}  // namespace plip
