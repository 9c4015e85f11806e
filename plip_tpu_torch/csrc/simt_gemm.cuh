// The fp32 GEMM of the port on Hopper (sm_90a), on the CUDA cores: one block
// computes a tile of C = A . op(B) in full fp32 (every product an FFMA into
// an fp32 sum; no TF32, no 3xTF32) and hands it to an epilogue functor.
// csrc/gemm.cuh runs the fp32 epilogue GEMMs on it (gemm_bias_residual,
// gemm_bias_gelu, gemm_bias_gelu_f32: NN; gemm_nt_gelu_bwd: NT), whose
// bf16 counterparts run the wgmma main loop of csrc/wgmma_gemm.cuh. fp32 is
// the dtype PLIP and CLIPTuner take by default, so this is K1's QKV and
// out-projection product on the default path.
//
// Operands, row-major fp32: A [M][K], or [K][M] (kTA: op(A) = A^T); B [K][N]
// (NN: the [in, out] weight) or [N][K] (kTB: op(B) = B^T). Block z of the
// grid sums k in [z kslice, min(K, (z + 1) kslice)): one slice (kslice >= K)
// for the epilogue GEMMs, several for K2's products (grad_gemm in
// csrc/attention_sublayer_bwd.cu, NT and TN), whose epilogue writes slice z
// apart.
//
// What bounds it: 2 M N K FLOPs against 4 (M K + K N + M N) bytes, some 300
// FLOPs a byte at the towers' shapes (M = 600 to 20,000 token rows, K and N
// 512 to 3,072), against the card's 20 (67 TFLOP/s of fp32 FMA over 3.35
// TB/s): the FFMA rate. The design keeps the FMA pipes fed:
// - 256 threads, 16 x 16; each owns a kMT x kNT register micro-tile (8 x 8
//   in the 128 x 128 block tile), read from shared memory as 16-byte loads:
//   per k, kMT/4 + kNT/4 loads for kMT kNT FFMAs (4 for 64 at 8 x 8). Its
//   rows are 4-row groups 64 apart, its columns 4-column groups 64 apart, so
//   the 16 threads of a half-warp read 256 contiguous bytes of the B row
//   (no bank conflict) and share one A address (a broadcast).
// - k-major tiles: As[k][m] and Bs[k][n], rows padded by 4 floats. A goes
//   there through registers, transposed (a thread stores a 4 x 1 column;
//   the padding puts a warp's 32 stores in 32 banks); NN's B and TN's A are
//   k-major already and come by 16-byte cp.async; NT's B goes through
//   registers as A does.
// - a two-stage ring of 8-deep K steps: the next step's global loads (into
//   registers, and B's cp.async) are issued before this step's 8 x 64
//   FFMAs a thread and stored after them, one barrier a step.
// - the block tile is a template (Tile below): 128 x 128, or 64 x 128, 64 x
//   64 and 32 x 64 where the 128 x 128 grid would leave SMs idle (the
//   caller's plan: ops/attention.py simt_gemm_plan).
// - 16-byte global loads and epilogue accesses where each operand's rows
//   (K for A and NT's B, M for TN's A, N for B and C) are multiples of 4
//   and every pointer is 16-byte aligned (`vec`); otherwise one float at a
//   time, with the same tiles.
// On an H100 (700 W) it reaches 60% of the FFMA bound at ViT-B/32's QKV
// product at batch 256 (cuBLAS's SGEMM: 70%). At 8 x 8 the four 16-byte
// shared loads a k take as many shared-memory cycles as the 64 FFMAs take
// FMA-pipe cycles; a 16 x 8 micro-tile halves that ratio but took 201-205
// registers (one block of 256 or two of 128 threads an SM) and measured
// 8-12% slower, as did a 16-deep K step (128 registers, spills).

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace plip {
namespace simt {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 8;         // K step

// kMT x kNT outputs a thread; the block tile is 16 kMT x 16 kNT.
template <int kMT, int kNT>
struct Tile {
  static constexpr int kBM = 16 * kMT, kBN = 16 * kNT;
  static constexpr int kGM = kMT < 4 ? kMT : 4;  // a thread's rows in one load
  static constexpr int kGN = kNT < 4 ? kNT : 4;
  static constexpr int kLdA = kBM + 4, kLdB = kBN + 4;  // padded k-major rows
  static constexpr int kStage = kBK * (kLdA + kLdB);   // floats a stage
  // 4-float chunks of a stage's A and B tiles (8 k a row of A or NT's B)
  static constexpr int kChunksA = kBM * kBK / 4, kChunksB = kBN * kBK / 4;
  static_assert(kMT % kGM == 0 && kNT % kGN == 0 && kGN == 4, "4-column groups");
  static_assert(kChunksA <= kThreads && kChunksB <= kThreads, "a chunk a thread");
};

template <int kW>
struct alignas(4 * kW) F32s {
  float v[kW];
};

// Row i of a thread's micro-tile (or column, with kG = kGN): groups of kG
// rows, 16 kG apart.
template <int kG>
__device__ __forceinline__ int micro(int i, int t) {
  return 16 * kG * (i / kG) + kG * t + i % kG;
}

// Four floats of row r of an [rows][ld] matrix from column c: one 16-byte
// load (vec), else one float at a time; zero past (r_end, c_end).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int ld, int r, int r_end,
                                        int c, int c_end, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= r_end) return x;
  const float* q = p + (size_t)r * ld + c;
  if (vec) {
    if (c < c_end) x = *reinterpret_cast<const float4*>(q);
  } else {
    x.x = c < c_end ? q[0] : 0.f;
    x.y = c + 1 < c_end ? q[1] : 0.f;
    x.z = c + 2 < c_end ? q[2] : 0.f;
    x.w = c + 3 < c_end ? q[3] : 0.f;
  }
  return x;
}

// The chunk as column r of rows k0 .. k0 + 3 of a k-major tile.
__device__ __forceinline__ void store_col(float* tile, int ld, int k0, int r, float4 x) {
  tile[(k0 + 0) * ld + r] = x.x;
  tile[(k0 + 1) * ld + r] = x.y;
  tile[(k0 + 2) * ld + r] = x.z;
  tile[(k0 + 3) * ld + r] = x.w;
}

// C = op(A) . op(B) for the block tile at (m0, n0), handed to epi(m, n,
// x[kW]) for kW consecutive columns (4 with `vec`, else 1); kSliced: over
// the K slice of blockIdx.z (kslice a multiple of kBK unless it covers K),
// else over all of K (the epilogue GEMMs: no registers spent on the slice's
// bounds, which at 127 a thread of 128 cost their main loop 10%).
template <int kMT, int kNT, bool kTA, bool kTB, bool kSliced, typename Epi>
__global__ void __launch_bounds__(kThreads, 2)
gemm_f32_simt_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N,
                     int K, int kslice, int vec, Epi epi) {
  using L = Tile<kMT, kNT>;
  __shared__ __align__(16) float smem[2 * L::kStage];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * L::kBM, n0 = blockIdx.x * L::kBN;
  const int kb = kSliced ? blockIdx.z * kslice : 0;
  const int ke = kSliced ? min(K, kb + kslice) : K;
  const int n_k = (ke - kb + kBK - 1) / kBK;
  // this thread's chunk of A (and of NT's B): row t / 2, k 4 (t % 2) ..
  const bool has_a = t < L::kChunksA, has_b = t < L::kChunksB;
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb = ra;

  // row k0 + k of a k-major operand [K][ld] (TN's A, NN's B): columns c0 + c
  // .. + 3 of its tile into row k of the stage's tile at dst, zero past
  // (ke, c_end)
  auto copy_row = [&](float* dst, const float* src, int ld, int k0, int k, int c0, int c,
                      int c_end) {
    const int gk = k0 + k, gc = c0 + c;
    const uint32_t d = hopper::smem_u32(dst);
    const float* row = src + (size_t)(gk < ke ? gk : 0) * ld;
    if (vec) {
      hopper::cp_async16(d, row + (gc < c_end ? gc : 0), gk < ke && gc < c_end);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hopper::cp_async4(d + 4 * i, row + (gc + i < c_end ? gc + i : 0),
                          gk < ke && gc + i < c_end);
    }
  };
  auto fetch = [&](int k0, int s) {  // global -> registers (A, NT's B), cp.async (TN's A, NN's B)
    float* st = smem + s * L::kStage;
    if constexpr (kTA) {
      if (has_a) {  // row k of A^T's tile: BM / 4 chunks
        constexpr int kRowChunks = L::kBM / 4;
        const int k = t / kRowChunks, c = 4 * (t % kRowChunks);
        copy_row(st + k * L::kLdA + c, A, M, k0, k, m0, c, M);
      }
    } else if (has_a) {
      ra = load4(A, K, m0 + t / 2, M, k0 + 4 * (t % 2), ke, vec);
    }
    if constexpr (kTB) {
      if (has_b) rb = load4(B, K, n0 + t / 2, N, k0 + 4 * (t % 2), ke, vec);
    } else if (has_b) {  // row k of B: BN / 4 chunks
      constexpr int kRowChunks = L::kBN / 4;
      const int k = t / kRowChunks, c = 4 * (t % kRowChunks);
      copy_row(st + kBK * L::kLdA + k * L::kLdB + c, B, N, k0, k, n0, c, N);
    }
    hopper::cp_async_commit();
  };
  auto stash = [&](int s) {  // registers -> the k-major tiles of stage s
    float* st = smem + s * L::kStage;
    if constexpr (!kTA)
      if (has_a) store_col(st, L::kLdA, 4 * (t % 2), t / 2, ra);
    if constexpr (kTB)
      if (has_b) store_col(st + kBK * L::kLdA, L::kLdB, 4 * (t % 2), t / 2, rb);
  };

  float acc[kMT][kNT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j] = 0.f;

  fetch(kb, 0);
  stash(0);
  hopper::cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_k;
    if (more) fetch(kb + (kt + 1) * kBK, cur ^ 1);  // its stage was freed by the last barrier
    const float* As = smem + cur * L::kStage;
    const float* Bs = As + kBK * L::kLdA;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kMT], b[kNT];
#pragma unroll
      for (int g = 0; g < kMT / L::kGM; ++g) {
        const F32s<L::kGM> v = *reinterpret_cast<const F32s<L::kGM>*>(
            As + k * L::kLdA + micro<L::kGM>(g * L::kGM, ty));
#pragma unroll
        for (int i = 0; i < L::kGM; ++i) a[g * L::kGM + i] = v.v[i];
      }
#pragma unroll
      for (int g = 0; g < kNT / L::kGN; ++g) {
        const F32s<L::kGN> v = *reinterpret_cast<const F32s<L::kGN>*>(
            Bs + k * L::kLdB + micro<L::kGN>(g * L::kGN, tx));
#pragma unroll
        for (int j = 0; j < L::kGN; ++j) b[g * L::kGN + j] = v.v[j];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      stash(cur ^ 1);
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // stage cur is free; stage cur ^ 1 is everyone's
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int m = m0 + micro<L::kGM>(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < kNT / L::kGN; ++g) {
      const int n = n0 + micro<L::kGN>(g * L::kGN, tx);
      const float* x = &acc[i][g * L::kGN];
      if (vec) {
        const float x4[4] = {x[0], x[1], x[2], x[3]};
        if (n < N) epi(m, n, x4);  // N % 4 == 0: the four columns are in
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x1[1] = {x[j]};
          if (n + j < N) epi(m, n + j, x1);
        }
      }
    }
  }
}

template <int kMT, int kNT, bool kTA, bool kTB, bool kSliced, typename Epi>
cudaError_t launch_tile(const float* a, const float* b, int M, int N, int K, int kslice,
                        bool vec, Epi epi, cudaStream_t s) {
  using L = Tile<kMT, kNT>;
  const int splits = (K + kslice - 1) / kslice;
  if ((M + L::kBM - 1) / L::kBM > 65535 || splits > 65535 || (splits > 1 && kslice % kBK) ||
      (!kSliced && splits > 1))
    return cudaErrorInvalidValue;
  const dim3 grid((N + L::kBN - 1) / L::kBN, (M + L::kBM - 1) / L::kBM, splits);
  gemm_f32_simt_kernel<kMT, kNT, kTA, kTB, kSliced, Epi><<<grid, kThreads, 0, s>>>(
      a, b, M, N, K, kslice, (int)vec, epi);
  return cudaGetLastError();
}

// The block tiles the caller's plan picks from (ops/attention.py
// SIMT_GEMM_TILES, in this order): 128 x 128, 64 x 128, 64 x 64, 32 x 64;
// one run over K (the epilogue GEMMs).
template <bool kTB, typename Epi>
cudaError_t launch_gemm_f32(const float* a, const float* b, int M, int N, int K, int tile,
                            bool vec, Epi epi, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_tile<8, 8, false, kTB, false>(a, b, M, N, K, K, vec, epi, s);
    case 1: return launch_tile<4, 8, false, kTB, false>(a, b, M, N, K, K, vec, epi, s);
    case 2: return launch_tile<4, 4, false, kTB, false>(a, b, M, N, K, K, vec, epi, s);
    case 3: return launch_tile<2, 4, false, kTB, false>(a, b, M, N, K, K, vec, epi, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt
}  // namespace plip
