// Pre-LN attention sublayer of the CLIP towers, by hand for Hopper (sm_90a):
//
//   y = x + ctx(qkv) . Wout + bout,   qkv = LN1(x) . Wqkv + bqkv,
//   ctx per head = softmax(q . k^T * D^-1/2, masked) . v
//
// Replaces the TPU kernel plip_tpu/ops/attention.py:_attn_sublayer_kernel
// (wrapper _pallas_attn_sublayer_flat), which runs all of this in one Pallas
// program per block of batch rows. Here it is three kernels behind one torch
// function (plip_tpu_torch/ops/attention.py:attention_sublayer):
//
//   ln_rows             one block per token row: fp32 mean and variance, the
//                       affine in fp32, one cast to the compute dtype.
//   gemm_bias_residual  C = cast(A . B + bias) [+ residual], fp32 accumulation:
//                       the tiled GEMM of gemm.cuh (bf16: WMMA tensor-core
//                       tiles, 64x64x32, 4 warps; fp32: CUDA-core tiles,
//                       64x64x16, so fp32 stays full fp32, no TF32).
//   attn_core           one block per (sequence, head), S <= 256: k and v of
//                       the head in shared memory as fp32, one warp per query
//                       row, logits scaled after the dot, causal and
//                       column >= s_valid masks, fp32 softmax, P cast to the
//                       compute dtype before P . v (fp32 sum). Up to S = 128
//                       the softmax normalizes first; above it the divide is
//                       deferred past P . v (the TPU kernel's _pipe_fwd).
//
// The rounding points are the TPU kernel's: LN statistics fp32; qkv and the
// out-projection accumulate in fp32, add the fp32 bias, then cast; the
// residual x + y is added in the compute dtype.
//
// What bounds it on the card. The two GEMMs hold almost all of the FLOPs
// (2*N*W*4W per layer against 4*N*S*W for the core), so at serving batch
// sizes the sublayer is bound by tensor-core throughput. This simple design
// leaves most of it on the table: the WMMA GEMM has no cp.async/TMA pipeline,
// no wgmma, and a 64x64 tile; ln, qkv and ctx make a round trip through
// device memory between the kernels (the TPU kernel kept them in VMEM); and
// attn_core runs its dots on CUDA cores. Fusing LN into the QKV GEMM's
// A-tile load, keeping ctx on chip, and wgmma with a TMA ring are the next
// steps.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take) so the caller can raise.

#include <math.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

using namespace plip;

// ---------------------------------------------------------------------------
// ln_rows
// ---------------------------------------------------------------------------

constexpr int kLnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int width,
               float eps) {
  __shared__ float red[32];
  const T* row = x + (size_t)blockIdx.x * width;
  T* orow = out + (size_t)blockIdx.x * width;
  float s = 0.f;
  for (int i = threadIdx.x; i < width; i += blockDim.x) s += to_f(row[i]);
  const float mean = block_sum(s, red) / width;
  float v = 0.f;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const float d = to_f(row[i]) - mean;
    v += d * d;
  }
  const float inv = rsqrtf(block_sum(v, red) / width + eps);
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    orow[i] = from_f<T>((to_f(row[i]) - mean) * inv * scale[i] + bias[i]);
}

// ---------------------------------------------------------------------------
// gemm_bias_residual: C[M, N] = cast(A[M, K] . B[K, N] + bias[N]) (+ R[M, N])
// A, B, R, C row-major; B is the [in, out] weight as the JAX package keeps it.
// The tiled GEMM of gemm.cuh with this epilogue.
// ---------------------------------------------------------------------------

template <typename T>
struct BiasResidual {
  const float* bias;
  const T* R;  // may be null
  T* C;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = (size_t)m * ld + n;
    T y = from_f<T>(acc + bias[n]);
    if (R) y = from_f<T>(to_f(R[o]) + to_f(y));
    C[o] = y;
  }
};

// ---------------------------------------------------------------------------
// attn_core: qkv [B*S, 3W] (columns [q heads | k heads | v heads], each head's
// D columns contiguous) -> ctx [B*S, W]. One block per (sequence, head).
// ---------------------------------------------------------------------------

constexpr int kCoreThreads = 256;
constexpr int kMaxSeq = 256;       // eight logits per lane
constexpr int kNormalizeSeq = 128; // above: deferred divide

size_t core_smem_bytes(int S, int D) {
  // k with a padded row (D + 1: lanes read one column of 32 rows without
  // bank conflicts), v, and per warp one q row and one row of P.
  return sizeof(float) *
         ((size_t)S * (D + 1) + (size_t)S * D + (kCoreThreads / 32) * (size_t)(D + S));
}

// kLogits = ceil(S / 32) rounded up to 4 or 8: the logits a lane holds.
// kDefer: p = exp(l - m) is cast as it is, P . v is divided by the fp32 row
// sum afterwards; otherwise p / sum is cast (normalize-first).
template <typename T, int kLogits, bool kDefer>
__global__ void __launch_bounds__(kCoreThreads)
attn_core_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int S, int heads,
                 int D, int causal, int s_valid, float scale) {
  extern __shared__ float smem[];
  const int W = heads * D, W3 = 3 * W, KS = D + 1;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = blockDim.x / 32;
  float* Ks = smem;
  float* Vs = Ks + S * KS;
  float* qw = Vs + S * D + warp * (D + S);
  float* pw = qw + D;
  const T* base = qkv + (size_t)b * S * W3;

  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    const int j = i / D, d = i % D;
    Ks[j * KS + d] = to_f(base[(size_t)j * W3 + W + h * D + d]);
    Vs[j * D + d] = to_f(base[(size_t)j * W3 + 2 * W + h * D + d]);
  }
  __syncthreads();

  for (int i = warp; i < S; i += nwarp) {
    for (int d = lane; d < D; d += 32) qw[d] = to_f(base[(size_t)i * W3 + h * D + d]);
    __syncwarp();
    float l[kLogits];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kLogits; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < S && j < s_valid && !(causal && j > i)) {
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qw[d], Ks[j * KS + d], a);
        s = a * scale;
      }
      l[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);  // finite: column 0 is never masked
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kLogits; ++t) {
      l[t] = expf(l[t] - m);
      sum += l[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kLogits; ++t) {
      const int j = lane + 32 * t;
      if (j < S) pw[j] = round_to<T>(kDefer ? l[t] : l[t] / sum);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a = fmaf(pw[j], Vs[j * D + d], a);
      ctx[((size_t)b * S + i) * W + h * D + d] = from_f<T>(kDefer ? a / sum : a);
    }
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

template <typename T, int kLogits, bool kDefer>
cudaError_t launch_core_sched(const void* qkv, void* ctx, int B, int S, int heads,
                              int D, int causal, int s_valid, cudaStream_t stream) {
  const size_t smem = core_smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<T, kLogits, kDefer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  attn_core_kernel<T, kLogits, kDefer><<<B * heads, kCoreThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(ctx), S, heads, D, causal, s_valid,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_core(const void* qkv, void* ctx, int B, int S, int heads, int D,
                        int causal, int s_valid, cudaStream_t stream) {
  if (S <= kNormalizeSeq)
    return launch_core_sched<T, kNormalizeSeq / 32, false>(qkv, ctx, B, S, heads, D,
                                                           causal, s_valid, stream);
  return launch_core_sched<T, kMaxSeq / 32, true>(qkv, ctx, B, S, heads, D, causal,
                                                  s_valid, stream);
}

}  // namespace

extern "C" {

int plip_ln_rows(const void* x, const float* scale, const float* bias, void* out,
                 int rows, int width, float eps, int dtype, int device, void* stream) {
  if (rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    ln_rows_kernel<float><<<rows, kLnThreads, 0, s>>>(
        static_cast<const float*>(x), scale, bias, static_cast<float*>(out), width, eps);
  else if (dtype == plip::kBF16)
    ln_rows_kernel<plip::bf16><<<rows, kLnThreads, 0, s>>>(
        static_cast<const plip::bf16*>(x), scale, bias, static_cast<plip::bf16*>(out),
        width, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// residual may be null (no residual add).
int plip_gemm_bias_residual(const void* a, const void* w, const float* bias,
                            const void* residual, void* out, int M, int N, int K,
                            int dtype, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * plip::kWBM) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return plip::launch_gemm<float, false>(
        a, w, M, N, K,
        BiasResidual<float>{bias, static_cast<const float*>(residual),
                            static_cast<float*>(out), N},
        s);
  if (dtype == plip::kBF16)
    return plip::launch_gemm<plip::bf16, false>(
        a, w, M, N, K,
        BiasResidual<plip::bf16>{bias, static_cast<const plip::bf16*>(residual),
                                 static_cast<plip::bf16*>(out), N},
        s);
  return cudaErrorInvalidValue;
}

int plip_attn_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                   int causal, int s_valid, int dtype, int device, void* stream) {
  if (B <= 0 || heads <= 0 || S <= 0 || S > kMaxSeq || head_dim <= 0 ||
      head_dim > 128 || s_valid < 1 || s_valid > S)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_core<float>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, s);
  if (dtype == plip::kBF16)
    return launch_core<plip::bf16>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
