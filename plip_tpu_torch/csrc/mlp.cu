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
// and the [N, 4W] traffic both count. The tiled GEMM of gemm.cuh (WMMA with
// fp32 accumulators, a 64x64 tile, no cp.async/TMA pipeline; CUDA cores in
// fp32) reaches a small share of either. The TPU kernels kept h1, act and
// dh1 in VMEM; here they make one round trip through device memory each.
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

// The epilogues: element (m, n) of the fp32 product, into row-major [M, ld].
template <typename T>
struct BiasGelu {
  const float* bias;
  T* h;  // may be null
  T* act;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = (size_t)m * ld + n;
    const T hv = from_f<T>(acc + bias[n]);
    const float hf = to_f(hv);
    if (h) h[o] = hv;
    act[o] = from_f<T>(hf * sigmoid_f(1.702f * hf));
  }
};

// K10's rounding: QuickGELU on the fp32 h1 = acc + bias, one cast, no h1.
template <typename T>
struct BiasGeluF32 {
  const float* bias;
  T* act;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const float hf = acc + bias[n];
    act[(size_t)m * ld + n] = from_f<T>(hf * sigmoid_f(1.702f * hf));
  }
};

template <typename T>
struct GeluBwd {
  const T* h;
  T* dh;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = (size_t)m * ld + n;
    const float hf = to_f(h[o]);
    const float s = sigmoid_f(1.702f * hf);
    dh[o] = from_f<T>(acc * (s + 1.702f * hf * s * (1.f - s)));
  }
};

}  // namespace

extern "C" {

// a [M, K] . w [K, N] (the [in, out] weight) + bias (fp32 [N]) -> act [M, N]
// and, unless h is null, h [M, N], in the compute dtype.
int plip_gemm_bias_gelu(const void* a, const void* w, const float* bias, void* h,
                        void* act, int M, int N, int K, int dtype, int device,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * kWBM) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_gemm<float, false>(
        a, w, M, N, K,
        BiasGelu<float>{bias, static_cast<float*>(h), static_cast<float*>(act), N}, s);
  if (dtype == kBF16)
    return launch_gemm<bf16, false>(
        a, w, M, N, K, BiasGelu<bf16>{bias, static_cast<bf16*>(h), static_cast<bf16*>(act), N},
        s);
  return cudaErrorInvalidValue;
}

// a [M, K] . w [K, N] + bias (fp32 [N]) -> act [M, N] in the compute dtype,
// the activation taken on the fp32 sum.
int plip_gemm_bias_gelu_f32(const void* a, const void* w, const float* bias, void* act,
                            int M, int N, int K, int dtype, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * kWBM) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_gemm<float, false>(
        a, w, M, N, K, BiasGeluF32<float>{bias, static_cast<float*>(act), N}, s);
  if (dtype == kBF16)
    return launch_gemm<bf16, false>(
        a, w, M, N, K, BiasGeluF32<bf16>{bias, static_cast<bf16*>(act), N}, s);
  return cudaErrorInvalidValue;
}

// g [M, K] . w^T with w [N, K] (fc2's [in, out] weight, in = N), and h
// [M, N] (the cast fc1 output) -> dh [M, N], in the compute dtype.
int plip_gemm_nt_gelu_bwd(const void* g, const void* w, const void* h, void* dh, int M,
                          int N, int K, int dtype, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * kWBM) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_gemm<float, true>(
        g, w, M, N, K,
        GeluBwd<float>{static_cast<const float*>(h), static_cast<float*>(dh), N}, s);
  if (dtype == kBF16)
    return launch_gemm<bf16, true>(
        g, w, M, N, K, GeluBwd<bf16>{static_cast<const bf16*>(h), static_cast<bf16*>(dh), N},
        s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
