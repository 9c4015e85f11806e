// The tiled GEMM the port's forward products share, by hand for Hopper
// (sm_90a): C = A . op(B) with fp32 accumulation, each element handed to an
// epilogue functor `epi(m, n, acc)` that adds the bias, the residual or the
// activation and casts, where the TPU kernels do:
//
//   gemm_bias_residual  (csrc/attention_sublayer.cu): cast(acc + bias) [+ R]
//   gemm_bias_gelu, gemm_nt_gelu_bwd  (csrc/mlp.cu): QuickGELU and its VJP
//
// bf16 on tensor cores (WMMA 16x16x16, fp32 accumulators, a 64x64 tile, 4
// warps); fp32 on CUDA cores (64x64x16 tiles, 4x4 outputs a thread), full
// fp32, no TF32. No cp.async/TMA pipeline and no wgmma: wgmma with a TMA ring
// is the next step for every product here.
//
// The templates live in namespace plip, not in an unnamed namespace: nvcc's
// host stubs cannot name a kernel of one unnamed namespace instantiated with
// an epilogue type of another (each .cu keeps its epilogues in its own).

#pragma once

#include <mma.h>

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace plip {

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] . op(B), fp32 sum, handed to the epilogue. op(B) = B
// [K, N] row-major, or B^T with B stored [N, K] (kTB).
// ---------------------------------------------------------------------------

// fp32 on CUDA cores: 64x64 output tile, 256 threads, 4x4 outputs a thread.
constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16;

template <bool kTB, typename Epi>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N,
                int K, Epi epi) {
  __shared__ float As[kSimtBK][kSimtBM + 4];  // As[k][m]
  __shared__ float Bs[kSimtBK][kSimtBN + 4];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSimtBM, n0 = blockIdx.x * kSimtBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
    for (int i = tid; i < kSimtBM * kSimtBK; i += blockDim.x) {
      const int r = i / kSimtBK, c = i % kSimtBK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    // consecutive threads read consecutive addresses in either layout
    for (int i = tid; i < kSimtBK * kSimtBN; i += blockDim.x) {
      const int r = kTB ? i % kSimtBK : i / kSimtBN;  // k
      const int c = kTB ? i / kSimtBK : i % kSimtBN;  // n
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < K && gn < N) v = kTB ? B[(size_t)gn * K + gk] : B[(size_t)gk * N + gn];
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

// bf16 on tensor cores (WMMA 16x16x16, fp32 accumulators): 64x64 output
// tile, 4 warps of 32x32, K steps of 32. Tiles are loaded as 16-byte chunks
// of 8 bf16 along each operand's contiguous dimension, so the wrapper
// requires that dimension to be a multiple of 8 (K for A; N for B, or K for
// a transposed B); a chunk is then wholly inside or wholly outside the
// matrix. A transposed B is kept in shared memory as it lies in device
// memory and read through a col_major fragment.
constexpr int kWBM = 64, kWBN = 64, kWBK = 32;
constexpr int kWLdA = kWBK + 8, kWLdC = kWBN + 4;

template <bool kTB, typename Epi>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int M, int N,
                 int K, Epi epi) {
  using namespace nvcuda;
  using LayoutB = typename std::conditional<kTB, wmma::col_major, wmma::row_major>::type;
  // B as [k][n] (ld 72) or, transposed, [n][k] (ld 40); the 8-element pad
  // keeps rows 16-byte aligned.
  constexpr int kLdB = kTB ? kWBK + 8 : kWBN + 8;
  constexpr int kBSize = kTB ? kWBN * kLdB : kWBK * kLdB;
  __shared__ __align__(128) bf16 As[kWBM * kWLdA];
  __shared__ __align__(128) bf16 Bs[kBSize];
  __shared__ __align__(128) float Cs[kWBM * kWLdC];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kWBM, n0 = blockIdx.x * kWBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += kWBK) {
    // A stored [M][K]: 64 rows (m) x 4 chunks (k)
    for (int i = tid; i < kWBM * (kWBK / 8); i += blockDim.x) {
      const int r = i / (kWBK / 8), c = (i % (kWBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const uint4 v = (gm < M && gk < K)
                          ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk)
                          : zero;
      *reinterpret_cast<uint4*>(As + r * kWLdA + c) = v;
    }
    if (kTB) {  // B stored [N][K]: 64 rows (n) x 4 chunks (k)
      for (int i = tid; i < kWBN * (kWBK / 8); i += blockDim.x) {
        const int r = i / (kWBK / 8), c = (i % (kWBK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        const uint4 v = (gn < N && gk < K)
                            ? *reinterpret_cast<const uint4*>(B + (size_t)gn * K + gk)
                            : zero;
        *reinterpret_cast<uint4*>(Bs + r * kLdB + c) = v;
      }
    } else {  // B stored [K][N]: 32 rows (k) x 8 chunks (n)
      for (int i = tid; i < kWBK * (kWBN / 8); i += blockDim.x) {
        const int r = i / (kWBN / 8), c = (i % (kWBN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        const uint4 v = (gk < K && gn < N)
                            ? *reinterpret_cast<const uint4*>(B + (size_t)gk * N + gn)
                            : zero;
        *reinterpret_cast<uint4*>(Bs + r * kLdB + c) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kWLdA + kk, kWLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(b[j], kTB ? Bs + n * kLdB + kk : Bs + kk * kLdB + n, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kWLdC + wn * 32 + j * 16,
                              acc[i][j], kWLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kWBM * kWBN; i += blockDim.x) {
    const int r = i / kWBN, c = i % kWBN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) epi(m, n, Cs[r * kWLdC + c]);
  }
}

template <typename T, bool kTB, typename Epi>
cudaError_t launch_gemm(const void* a, const void* b, int M, int N, int K, Epi epi,
                        cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((N + kSimtBN - 1) / kSimtBN, (M + kSimtBM - 1) / kSimtBM);
    gemm_f32_kernel<kTB, Epi><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), M, N, K, epi);
  } else {
    // the contiguous dimension of each operand must hold whole 8-element chunks
    if (K % 8 || (!kTB && N % 8)) return cudaErrorInvalidValue;
    const dim3 grid((N + kWBN - 1) / kWBN, (M + kWBM - 1) / kWBM);
    gemm_bf16_kernel<kTB, Epi><<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), M, N, K, epi);
  }
  return cudaGetLastError();
}

}  // namespace plip
