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
//   gemm_bias_residual  C = cast(A . B + bias) [+ residual], fp32 accumulation.
//                       bf16: WMMA tensor-core tiles (64x64x32, 4 warps).
//                       fp32: CUDA-core tiles (64x64x16, 4x4 outputs a thread),
//                       so fp32 stays full fp32 (no TF32).
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

#include <mma.h>

#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
// ---------------------------------------------------------------------------

template <typename T, bool kResid>
__device__ __forceinline__ void store_out(const T* R, T* C, int N, int m, int n,
                                          float acc, const float* bias) {
  T y = from_f<T>(acc + bias[n]);
  if (kResid) y = from_f<T>(to_f(R[(size_t)m * N + n]) + to_f(y));
  C[(size_t)m * N + n] = y;
}

// fp32 on CUDA cores: 64x64 output tile, 256 threads, 4x4 outputs a thread.
constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16;

template <bool kResid>
__global__ void __launch_bounds__(256)
gemm_simt_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ bias, const float* __restrict__ R,
                     float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kSimtBK][kSimtBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[kSimtBK][kSimtBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSimtBM, n0 = blockIdx.x * kSimtBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
    for (int i = tid; i < kSimtBM * kSimtBK; i += blockDim.x) {
      const int r = i / kSimtBK, c = i % kSimtBK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < kSimtBK * kSimtBN; i += blockDim.x) {
      const int r = i / kSimtBN, c = i % kSimtBN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
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
      if (n < N) store_out<float, kResid>(R, C, N, m, n, acc[i][j], bias);
    }
  }
}

// bf16 on tensor cores (WMMA 16x16x16, fp32 accumulators): 64x64 output
// tile, 4 warps of 32x32, K steps of 32. Tiles are loaded as 16-byte chunks
// of 8 bf16, so the wrapper requires K % 8 == 0 and N % 8 == 0; a chunk is
// then wholly inside or wholly outside the matrix.
constexpr int kWBM = 64, kWBN = 64, kWBK = 32;
constexpr int kWLdA = kWBK + 8, kWLdB = kWBN + 8, kWLdC = kWBN + 4;

template <bool kResid>
__global__ void __launch_bounds__(128)
gemm_wmma_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                      const float* __restrict__ bias, const bf16* __restrict__ R,
                      bf16* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[kWBM * kWLdA];
  __shared__ __align__(128) bf16 Bs[kWBK * kWLdB];
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
    // A tile: 64 rows x 4 chunks; B tile: 32 rows x 8 chunks.
    for (int i = tid; i < kWBM * (kWBK / 8); i += blockDim.x) {
      const int r = i / (kWBK / 8), c = (i % (kWBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const uint4 v = (gm < M && gk < K)
                          ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk)
                          : zero;
      *reinterpret_cast<uint4*>(As + r * kWLdA + c) = v;
    }
    for (int i = tid; i < kWBK * (kWBN / 8); i += blockDim.x) {
      const int r = i / (kWBN / 8), c = (i % (kWBN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const uint4 v = (gk < K && gn < N)
                          ? *reinterpret_cast<const uint4*>(B + (size_t)gk * N + gn)
                          : zero;
      *reinterpret_cast<uint4*>(Bs + r * kWLdB + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kWLdA + kk, kWLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kWLdB + wn * 32 + j * 16, kWLdB);
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
    if (m < M && n < N) store_out<bf16, kResid>(R, C, N, m, n, Cs[r * kWLdC + c], bias);
  }
}

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
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32) {
    const dim3 grid((N + kSimtBN - 1) / kSimtBN, (M + kSimtBM - 1) / kSimtBM);
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(w);
    const float* R = static_cast<const float*>(residual);
    float* C = static_cast<float*>(out);
    if (residual)
      gemm_simt_f32_kernel<true><<<grid, 256, 0, s>>>(A, B, bias, R, C, M, N, K);
    else
      gemm_simt_f32_kernel<false><<<grid, 256, 0, s>>>(A, B, bias, R, C, M, N, K);
  } else if (dtype == plip::kBF16) {
    if (K % 8 || N % 8) return cudaErrorInvalidValue;
    const dim3 grid((N + kWBN - 1) / kWBN, (M + kWBM - 1) / kWBM);
    const plip::bf16* A = static_cast<const plip::bf16*>(a);
    const plip::bf16* B = static_cast<const plip::bf16*>(w);
    const plip::bf16* R = static_cast<const plip::bf16*>(residual);
    plip::bf16* C = static_cast<plip::bf16*>(out);
    if (residual)
      gemm_wmma_bf16_kernel<true><<<grid, 128, 0, s>>>(A, B, bias, R, C, M, N, K);
    else
      gemm_wmma_bf16_kernel<false><<<grid, 128, 0, s>>>(A, B, bias, R, C, M, N, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
