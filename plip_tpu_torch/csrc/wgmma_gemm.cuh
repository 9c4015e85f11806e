// The bf16 GEMM main loop of the port on Hopper (sm_90a): one block computes
// a 128 x 128 tile of C = op(A) . op(B) in fp32, over a range of K, for any
// operand layout, and hands the tile to an epilogue. K2's grad_gemm
// (csrc/attention_sublayer_bwd.cu) runs its NT and TN products on it, and
// the epilogue GEMMs of csrc/gemm.cuh (gemm_bias_residual, gemm_bias_gelu,
// gemm_bias_gelu_f32: NN; gemm_nt_gelu_bwd: NT) their whole K range.
//
// Operands, as they lie in device memory (row-major, bf16, every row start
// 16-byte aligned):
//   A: kAMn = false: [M][K] (K-major);  kAMn = true: [K][M] (M-major, A^T)
//   B: kBMn = false: [N][K] (K-major);  kBMn = true: [K][N] (N-major)
// NT (A . B^T) is <false, false>, TN (A^T . B) <true, true>, NN <false, true>.
//
// The design:
// - 256 threads, two consumer warpgroups; warpgroup w owns rows 64 w .. of
//   the tile and runs wgmma m64n128k16 (csrc/wgmma.cuh) from shared memory,
//   both operands in 64 x 64 tiles with the 128-byte swizzle: A's two tiles
//   (one a warpgroup), B's two (its 128 columns). A K-major operand's tile
//   has rows m (or n) and 64 values of K; an MN-major one has rows k and 64
//   values of M (or N), read with the transpose bit. So every layout shares
//   one tile, one loader and one descriptor pair.
// - A ring of kStages stages of 64-deep K steps (32 KB each), filled by
//   cp.async from all 256 threads with zero fill at the M, N and K edges;
//   kInFlight wgmma batches stay in flight across the barrier that frees a
//   stage, and kStages - 1 - kInFlight steps' copies are in flight while a
//   step's wgmma runs. grad_gemm: 5 stages (161 KB with the alignment
//   slack, one block an SM), one batch in flight; the epilogue GEMMs: 3
//   stages (97 KB, two blocks an SM), none.
// - fp32 accumulation in the tensor cores over the whole K range, 64
//   registers a thread; the epilogue gets each thread's column pairs, and
//   load_vec / store_vec move them (or a row chunk) as one access.

#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace plip {
namespace hopper {

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 64;
constexpr int kGemmThreads = 256;  // two consumer warpgroups
constexpr int kGemmStages = 5;

// A stage from a 1024-byte boundary: A's two tiles, then B's two.
struct GemmSmem {
  static constexpr uint32_t kA = 0;
  static constexpr uint32_t kB = 2 * kTileBytes;
  static constexpr uint32_t kStage = 4 * kTileBytes;
};

// The dynamic shared memory of a ring of `stages` stages (+ alignment slack).
constexpr size_t gemm_smem_bytes(int stages) { return stages * GemmSmem::kStage + 1024; }

// acc = sum over k in [kb, ke) of op(A)[m, k] op(B)[k, n] for this
// warpgroup's 64 rows (m0 + 64 w ..) and the tile's 128 columns (n0 ..).
// Every thread of the block calls it (kStages, kInFlight: the header).
template <bool kAMn, bool kBMn, int kStages = kGemmStages, int kInFlight = 1>
__device__ __forceinline__ void gemm_mainloop(const __nv_bfloat16* __restrict__ A,
                                              const __nv_bfloat16* __restrict__ B, int M,
                                              int N, int K, int m0, int n0, int kb, int ke,
                                              unsigned char* smem_raw, float (&acc)[64]) {
  constexpr int kAhead = kStages - 1 - kInFlight;
  const uint32_t base = smem_u32(align_1024(smem_raw));
  const int wg = threadIdx.x / kWarpgroup;
  const int lda = kAMn ? M : K, ldb = kBMn ? N : K;
  const int n_k = (ke - kb + kGemmBK - 1) / kGemmBK;
  auto stage = [&](int it) { return base + (it % kStages) * GemmSmem::kStage; };
  auto issue = [&](int it) {
    if (it < n_k) {
      const int k0 = kb + it * kGemmBK;
      const uint32_t s = stage(it);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a = s + GemmSmem::kA + h * kTileBytes;
        const uint32_t b = s + GemmSmem::kB + h * kTileBytes;
        if constexpr (kAMn) load_tile_2d<kGemmThreads>(a, A, lda, k0, ke, m0 + 64 * h, M);
        else load_tile_2d<kGemmThreads>(a, A, lda, m0 + 64 * h, M, k0, ke);
        if constexpr (kBMn) load_tile_2d<kGemmThreads>(b, B, ldb, k0, ke, n0 + 64 * h, N);
        else load_tile_2d<kGemmThreads>(b, B, ldb, n0 + 64 * h, N, k0, ke);
      }
    }
    cp_async_commit();  // empty past the last step: the group count stays uniform
  };
#pragma unroll
  for (int v = 0; v < 64; ++v) acc[v] = 0.f;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) issue(s);

  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kAhead - 1>();  // step it has landed (this thread's copies)
    fence_proxy_async();          // ... and is visible to wgmma
    // everyone's copies; every warpgroup has retired the wgmma of step
    // it - 1 - kInFlight, whose stage is refilled next
    __syncthreads();
    issue(it + kAhead);
    const uint32_t a = stage(it) + GemmSmem::kA + wg * kTileBytes;
    const uint32_t b = stage(it) + GemmSmem::kB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K-major: k-step kk is 32 bytes into each 128-byte row; MN-major: 16
      // rows of K (2048 bytes) down, B's second 64 columns one tile over
      const uint64_t da = kAMn ? desc_mnmajor(a + 2048 * kk) : desc_kmajor(a + 32 * kk);
      const uint64_t db = kBMn ? desc_mnmajor_wide(b + 2048 * kk, kTileBytes)
                               : desc_kmajor(b + 32 * kk);
      mma_ss_n128<kAMn, kBMn>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<kInFlight>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();  // no copy outlives the block (the trailing groups are empty)
}

// kW consecutive values of a row-major T array at p, read or written as one
// access of kW * sizeof(T) bytes (p aligned to that, or to 16 bytes past
// it): a column pair of the accumulator (kW = 2), a 16-byte row chunk of a
// bf16 tile (kW = 8), one fp32 value (kW = 1). Stores round to nearest even.
template <typename T, int kW>
struct alignas(sizeof(T) * kW < 16 ? sizeof(T) * kW : 16) Vec {
  T v[kW];
};

template <int kW, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[kW]) {
  const Vec<T, kW> r = *reinterpret_cast<const Vec<T, kW>*>(p);
#pragma unroll
  for (int i = 0; i < kW; ++i) x[i] = to_f(r.v[i]);
}

template <int kW, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[kW]) {
  Vec<T, kW> r;
#pragma unroll
  for (int i = 0; i < kW; ++i) r.v[i] = from_f<T>(x[i]);
  *reinterpret_cast<Vec<T, kW>*>(p) = r;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x0, float x1) {
  const float x[2] = {x0, x1};
  store_vec<2>(p, x);
}

// epi(m, n, acc[m][n], acc[m][n + 1]) for each column pair this thread holds
// (n even); the epilogue checks the bounds.
template <class Epi>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[64], int m0, int n0, Epi epi) {
  const int t = threadIdx.x % kWarpgroup, lane = t % 32;
  const int row = m0 + 64 * (threadIdx.x / kWarpgroup) + 16 * (t / 32) + lane / 4;
  const int col = n0 + 2 * (lane % 4);
#pragma unroll
  for (int v = 0; v < 64; v += 2)
    epi(row + 8 * ((v >> 1) & 1), col + 8 * (v >> 2), acc[v], acc[v + 1]);
}

}  // namespace hopper
}  // namespace plip
