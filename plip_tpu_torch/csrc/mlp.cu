// MLP half of the CLIP blocks, by hand for Hopper (sm_90a):
//
//   y = x + fc2(QuickGELU(fc1(LN2 x))),   QuickGELU(h) = h * sigmoid(1.702 h)
//
// Three GEMMs with the activation in their epilogue, which the ports of four
// TPU kernels run between K1's and K2's kernels (plip_tpu_torch/ops/mlp.py,
// plip_tpu_torch/ops/block_bwd.py, plip_tpu_torch/ops/block.py):
//
//   gemm_bias_gelu    h1 = cast(A . B + bias) and act = cast(h * sigmoid(1.702 h)),
//                     h the CAST h1 in fp32 (the TPU kernels' rounding,
//                     plip_tpu/ops/mlp.py:85-91, block_bwd.py:159-165; the
//                     composed forward's QuickGELU runs on bf16 tensors
//                     instead). Writes act and, when asked, h1.
//   gemm_bias_gelu_f32  act = cast(h * sigmoid(1.702 h)), h = A . B + bias in
//                     fp32, never cast (plip_tpu/ops/block.py:98-102, the
//                     whole-block forward K10): a third rounding of QuickGELU.
//                     Writes act only.
//   gemm_nt_gelu_bwd  dh1 = cast(fp32(G . B^T) * (s + 1.702 h s (1 - s))),
//                     s = sigmoid(1.702 h), h the cast h1 (mlp.py:96-100,
//                     block_bwd.py:179-183): the fp32 da [N, 4W] of the TPU
//                     kernels stays in registers and is never written.
//
// They replace, with ln_rows, gemm_bias_residual, grad_gemm, ln_bwd_rows and
// col_sum of csrc/attention_sublayer*.cu around them:
//
//   plip_tpu/ops/mlp.py:187 _mlp_fwd_kernel (K9): ln_rows, gemm_bias_gelu,
//       gemm_bias_residual (fc2 with its bias and the residual);
//   plip_tpu/ops/mlp.py:54 _mlp_bwd_kernel (K8): ln_rows and gemm_bias_gelu
//       (the recompute), grad_gemm TN (dW2 = act^T . g, dW1 = ln^T . dh1),
//       gemm_nt_gelu_bwd (dh1), grad_gemm NT (dln = dh1 . W1^T, fp32),
//       ln_bwd_rows (dx = g + cast(dx_ln)), col_sum (db1, db2, dgamma, dbeta);
//   plip_tpu/ops/block_bwd.py:70 _block_bwd_kernel (K7): K8's chain on the
//       recomputed attention output y, after K1's kernels and before K4's
//       core backward (csrc/mha_bwd.cu) and K2's products;
//   plip_tpu/ops/block.py:57 _block_kernel (K10): K1's sublayer forward, then
//       ln_rows, gemm_bias_gelu_f32, gemm_bias_residual (fc2 and the residual).
//
// What bounds it on the card. Each GEMM is 2*N*W*4W FLOPs against about
// 2*N*4W*2 bytes of h1 and act (or h1 and dh1) in bf16: at N = 6400, W = 768
// some 230 FLOPs a byte, near the card's ridge, so tensor-core throughput
// and the [N, 4W] traffic both count. The GEMM of gemm.cuh runs bf16 on
// wgmma (128 x 128 tiles, a cp.async ring, two blocks an SM so that one
// block's epilogue traffic overlaps the other's main loop) and moves bias,
// h and the outputs in 16-byte row chunks; fp32 (the default dtype) runs on
// the CUDA-core main loop of simt_gemm.cuh (8 x 8 register micro-tiles, a
// block tile planned by ops/attention.py simt_gemm_plan). The
// TPU kernels kept h1, act and dh1 in VMEM; here they make one round trip
// through device memory each.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take) so the caller can raise.

#include <math.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

using namespace plip;

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

// The epilogues (gemm.cuh): columns n .. n + kW - 1 of row m of the fp32
// product, into row-major [M, ld].
template <typename T>
struct BiasGelu {
  const float* bias;
  T* h;  // may be null
  T* act;
  int ld;
  template <int kW>
  __device__ __forceinline__ void operator()(int m, int n, const float (&x)[kW]) const {
    const size_t o = (size_t)m * ld + n;
    float b[kW], hf[kW], a[kW];
    hopper::load_vec<kW>(bias + n, b);
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      hf[i] = round_to<T>(x[i] + b[i]);
      a[i] = hf[i] * sigmoid_f(1.702f * hf[i]);
    }
    if (h) hopper::store_vec<kW>(h + o, hf);
    hopper::store_vec<kW>(act + o, a);
  }
};

// K10's rounding: QuickGELU on the fp32 h1 = acc + bias, one cast, no h1.
template <typename T>
struct BiasGeluF32 {
  const float* bias;
  T* act;
  int ld;
  template <int kW>
  __device__ __forceinline__ void operator()(int m, int n, const float (&x)[kW]) const {
    float b[kW], a[kW];
    hopper::load_vec<kW>(bias + n, b);
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float hf = x[i] + b[i];
      a[i] = hf * sigmoid_f(1.702f * hf);
    }
    hopper::store_vec<kW>(act + (size_t)m * ld + n, a);
  }
};

template <typename T>
struct GeluBwd {
  const T* h;
  T* dh;
  int ld;
  template <int kW>
  __device__ __forceinline__ void operator()(int m, int n, const float (&x)[kW]) const {
    const size_t o = (size_t)m * ld + n;
    float hf[kW], d[kW];
    hopper::load_vec<kW>(h + o, hf);
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float s = sigmoid_f(1.702f * hf[i]);
      d[i] = x[i] * (s + 1.702f * hf[i] * s * (1.f - s));
    }
    hopper::store_vec<kW>(dh + o, d);
  }
};

}  // namespace

extern "C" {

// a [M, K] . w [K, N] (the [in, out] weight) + bias (fp32 [N]) -> act [M, N]
// and, unless h is null, h [M, N], in the compute dtype. tile: fp32's block
// tile (ops/attention.py simt_gemm_plan); bf16 ignores it, as below.
int plip_gemm_bias_gelu(const void* a, const void* w, const float* bias, void* h,
                        void* act, int M, int N, int K, int tile, int dtype, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16({a, w, bias, h, act});
  if (dtype == kF32)
    return launch_gemm<float, false>(
        a, w, M, N, K, tile, aligned,
        BiasGelu<float>{bias, static_cast<float*>(h), static_cast<float*>(act), N}, s);
  if (dtype == kBF16)
    return launch_gemm<bf16, false>(
        a, w, M, N, K, tile, aligned,
        BiasGelu<bf16>{bias, static_cast<bf16*>(h), static_cast<bf16*>(act), N},
        s);
  return cudaErrorInvalidValue;
}

// a [M, K] . w [K, N] + bias (fp32 [N]) -> act [M, N] in the compute dtype,
// the activation taken on the fp32 sum.
int plip_gemm_bias_gelu_f32(const void* a, const void* w, const float* bias, void* act,
                            int M, int N, int K, int tile, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16({a, w, bias, act});
  if (dtype == kF32)
    return launch_gemm<float, false>(
        a, w, M, N, K, tile, aligned, BiasGeluF32<float>{bias, static_cast<float*>(act), N},
        s);
  if (dtype == kBF16)
    return launch_gemm<bf16, false>(
        a, w, M, N, K, tile, aligned, BiasGeluF32<bf16>{bias, static_cast<bf16*>(act), N},
        s);
  return cudaErrorInvalidValue;
}

// g [M, K] . w^T with w [N, K] (fc2's [in, out] weight, in = N), and h
// [M, N] (the cast fc1 output) -> dh [M, N], in the compute dtype.
int plip_gemm_nt_gelu_bwd(const void* g, const void* w, const void* h, void* dh, int M,
                          int N, int K, int tile, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16({g, w, h, dh});
  if (dtype == kF32)
    return launch_gemm<float, true>(
        g, w, M, N, K, tile, aligned,
        GeluBwd<float>{static_cast<const float*>(h), static_cast<float*>(dh), N}, s);
  if (dtype == kBF16)
    return launch_gemm<bf16, true>(
        g, w, M, N, K, tile, aligned,
        GeluBwd<bf16>{static_cast<const bf16*>(h), static_cast<bf16*>(dh), N},
        s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
