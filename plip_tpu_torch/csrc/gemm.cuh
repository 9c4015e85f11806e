// The GEMM of the port's epilogue products, by hand for Hopper (sm_90a):
// C = A . op(B) with fp32 accumulation over the whole K range, handed to an
// epilogue functor that adds the bias, the residual or the activation and
// casts, where the TPU kernels do:
//
//   gemm_bias_residual  (csrc/attention_sublayer.cu): cast(acc + bias) [+ R]
//   gemm_bias_gelu, gemm_bias_gelu_f32, gemm_nt_gelu_bwd  (csrc/mlp.cu):
//                       QuickGELU on the cast h1 or on the fp32 sum, and its VJP
//
// bf16 on wgmma (epilogue_gemm_wgmma_kernel below): the main loop of
// csrc/wgmma_gemm.cuh on a 128 x 128 tile, two blocks an SM, and an
// epilogue that stages the fp32 tile in shared memory and moves bias, R, h
// and the outputs in 16-byte row chunks. fp32, the dtype PLIP and CLIPTuner
// take by default: the CUDA-core main loop of csrc/simt_gemm.cuh (full
// fp32, no TF32; a 128 x 128 tile of 8 x 8 register micro-tiles, or a
// smaller tile the caller plans, a two-stage ring, 16-byte accesses).
//
// What bounds it on the card: at the towers' shapes (N = 1,600 to 18,464
// token rows, W = 768 or 1024) a product does 2 N W 4W FLOPs against about
// 2 N 4W bf16 bytes an output, some 200-400 FLOPs a byte, at or above the
// card's 295, so tensor-core throughput first (in fp32 the FFMA rate, far
// above its 20 FLOPs a byte); gemm_bias_gelu's two [N, 4W]
// outputs bring the bytes close. A block's epilogue moves 32 KB an output
// through device memory with its tensor cores idle, so a second block on
// the SM runs its main loop meanwhile.
//
// The templates live in namespace plip, not in an unnamed namespace: nvcc's
// host stubs cannot name a kernel of one unnamed namespace instantiated with
// an epilogue type of another (each .cu keeps its epilogues in its own).

#pragma once

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "simt_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace plip {

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] . op(B), fp32 sum, handed to the epilogue. op(B) = B
// [K, N] row-major, or B^T with B stored [N, K] (kTB).
// ---------------------------------------------------------------------------

// bf16 on wgmma: the main loop of csrc/wgmma_gemm.cuh over the whole K
// range (no K slices: the epilogue needs the whole sum), a 128 x 128 tile a
// block, 256 threads. A is [M][K] (K-major); B is the [in, out] weight
// stored [K][N] (N-major, kBMn) or, transposed, [N][K] (K-major).
//
// Two blocks an SM, so that one block's epilogue (which moves the output
// tiles through device memory) runs under the other's main loop: a ring of
// kEpiStages (3) stages (97 KB of shared memory a block), two K steps'
// copies in flight while a step's wgmma runs, and no wgmma batch in flight
// across the barrier that frees a stage; 128 registers a thread at most.
//
// The epilogue stages the fp32 tile in the ring, which is free once both
// warpgroups' last wgmma has retired: each thread writes its column pairs
// (rows padded to kStageLd floats, so a half-warp's 8-byte stores hit 32
// distinct banks); then each thread takes 16-byte row chunks of 8 columns,
// 16 threads to a row, so the epilogue's loads (bias, R, h) and its stores
// are whole 16-byte accesses. That needs N % 8 == 0 and every array it
// touches 16-byte aligned (the wrappers check both).
constexpr int kEpiStages = 3;
constexpr int kStageLd = hopper::kGemmBN + 8;
static_assert(hopper::kGemmBM * kStageLd * 4 + 1024 <= hopper::gemm_smem_bytes(kEpiStages),
              "the staged tile fits the ring");

template <bool kBMn, typename Epi>
__global__ void __launch_bounds__(hopper::kGemmThreads, 2)
epilogue_gemm_wgmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int M,
                           int N, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  const int m0 = blockIdx.y * hopper::kGemmBM, n0 = blockIdx.x * hopper::kGemmBN;
  float acc[64];
  hopper::gemm_mainloop<false, kBMn, kEpiStages, 0>(A, B, M, N, K, m0, n0, 0, K, gemm_smem,
                                                    acc);
  float* tile = reinterpret_cast<float*>(hopper::align_1024(gemm_smem));
  __syncthreads();  // every warpgroup's wgmma has read its last stage
  hopper::gemm_epilogue(acc, 0, 0, [&](int r, int c, float x0, float x1) {
    *reinterpret_cast<float2*>(tile + r * kStageLd + c) = make_float2(x0, x1);
  });
  __syncthreads();
  constexpr int kChunks = hopper::kGemmBN / 8;  // a row's 16-byte chunks
#pragma unroll 4
  for (int i = threadIdx.x; i < hopper::kGemmBM * kChunks; i += hopper::kGemmThreads) {
    const int r = i / kChunks, c = 8 * (i % kChunks), m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * kStageLd + c);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * kStageLd + c + 4);
    const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    epi(m, n, x);
  }
}

// The epilogue is a functor with
//   template <int kW> void operator()(int m, int n, const float (&x)[kW])
// for the fp32 sums of columns n .. n + kW - 1 of row m (kW = 4 or 1 from
// the fp32 kernel, 8 from the bf16 one); it reads and writes them as one
// access each (csrc/wgmma_gemm.cuh: load_vec, store_vec). fp32 takes the
// block tile `tile` of the caller's plan (csrc/simt_gemm.cuh) and moves 16
// bytes at a time where K and N are multiples of 4 and `aligned` (every
// pointer of the product and of its epilogue 16-byte aligned); bf16 ignores
// both.
template <typename T, bool kTB, typename Epi>
cudaError_t launch_gemm(const void* a, const void* b, int M, int N, int K, int tile,
                        bool aligned, Epi epi, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    const bool vec = aligned && K % 4 == 0 && N % 4 == 0;
    return simt::launch_gemm_f32<kTB>(static_cast<const float*>(a),
                                      static_cast<const float*>(b), M, N, K, tile, vec, epi,
                                      s);
  } else {
    // whole 16-byte chunks: of each operand's rows (cp.async) and of the
    // outputs' rows (the epilogue)
    if (K % 8 || N % 8 || (M + hopper::kGemmBM - 1) / hopper::kGemmBM > 65535)
      return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
      return cudaErrorMisalignedAddress;
    constexpr int kSmem = (int)hopper::gemm_smem_bytes(kEpiStages);
    cudaError_t err = cudaFuncSetAttribute(epilogue_gemm_wgmma_kernel<!kTB, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + hopper::kGemmBN - 1) / hopper::kGemmBN,
                    (M + hopper::kGemmBM - 1) / hopper::kGemmBM);
    epilogue_gemm_wgmma_kernel<!kTB, Epi><<<grid, hopper::kGemmThreads, kSmem, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), M, N, K, epi);
    return cudaGetLastError();
  }
}

}  // namespace plip
