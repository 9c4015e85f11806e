// The epilogue of a row-parallel product under tensor parallelism, by hand
// for Hopper (sm_90a):
//
//   out[M, N] = cast(acc[M, N] + bias[N]) + residual[M, N]           (K1's order)
//   out[M, N] = cast(cast(acc[M, N]) + cast(bias[N])) + residual[M, N]  (composed)
//
// acc is the fp32 sum over the tp ranks of their partial products (the
// out-projection's or fc2's input rows, csrc/attention_sublayer.cu's
// gemm_partial, then an all-reduce over the tp group); bias fp32; residual
// and out in the compute dtype. K1's order is gemm_bias_residual's (the fp32
// bias added to the fp32 sum, one cast, the residual added in the compute
// dtype); the composed order is the composed towers' linear (the product
// cast, the bias added in the compute dtype), so each path rounds as it
// does without a mesh (in fp32 the two are one). It replaces no TPU kernel
// of its own: under GSPMD the JAX package gathers K1's operands instead of
// splitting its product.
//
// Elementwise and bound by its bytes: each thread takes kV consecutive
// values of a row (16 bytes of the residual and the output: 8 bf16 or 4
// fp32), acc and bias in 16-byte loads; a grid of the caller's blocks
// strides over the rows. Where N % kV or a base's alignment forbids that,
// one value at a time.

#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using plip::hopper::load_vec;
using plip::hopper::store_vec;

constexpr int kThreads = 256;

template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
tp_epilogue_kernel(const float* __restrict__ acc, const float* __restrict__ bias,
                   const T* __restrict__ residual, T* __restrict__ out, int64_t chunks,
                   int N, bool composed) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < chunks;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t e = i * kV;
    const int n = (int)(e % N);
    float a[kV], b[kV], r[kV], y[kV];
    load_vec<kV>(acc + e, a);
    load_vec<kV>(bias + n, b);
    load_vec<kV>(residual + e, r);
#pragma unroll
    for (int j = 0; j < kV; ++j)
      y[j] = r[j] + (composed ? plip::round_to<T>(plip::round_to<T>(a[j]) +
                                                  plip::round_to<T>(b[j]))
                              : plip::round_to<T>(a[j] + b[j]));
    store_vec<kV>(out + e, y);  // the residual add rounds in the store
  }
}

template <typename T>
cudaError_t launch_tp_epilogue(const float* acc, const float* bias, const void* residual,
                               void* out, int M, int N, int blocks, bool composed,
                               cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const T* r = static_cast<const T*>(residual);
  T* o = static_cast<T*>(out);
  const int64_t total = (int64_t)M * N;
  if (N % kV == 0 && plip::aligned16({acc, bias, residual, out})) {
    tp_epilogue_kernel<T, kV><<<blocks, kThreads, 0, s>>>(acc, bias, r, o, total / kV, N,
                                                          composed);
  } else {
    tp_epilogue_kernel<T, 1><<<blocks, kThreads, 0, s>>>(acc, bias, r, o, total, N, composed);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks: the grid (ops/tp.py tp_epilogue_plan), the rows walked in strides;
// composed: the composed order (the file's head), else K1's.
int plip_tp_epilogue(const float* acc, const float* bias, const void* residual, void* out,
                     int M, int N, int blocks, int composed, int dtype, int device,
                     void* stream) {
  if (M <= 0 || N <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_tp_epilogue<float>(acc, bias, residual, out, M, N, blocks, composed, s);
  if (dtype == plip::kBF16)
    return launch_tp_epilogue<plip::bf16>(acc, bias, residual, out, M, N, blocks, composed,
                                          s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
