// Backward of the pre-LN attention sublayer, by hand for Hopper (sm_90a):
//
//   y = x + ctx(qkv) . Wout + bout,   qkv = LN1(x) . Wqkv + bqkv
//   from x and g = dL/dy:  dx, dgamma1, dbeta1, dWqkv, dbqkv, dWout, dbout
//
// Replaces the TPU kernel plip_tpu/ops/attention.py:_attn_sublayer_bwd_kernel
// (K2, wrapper _pallas_attn_sublayer_bwd_flat) with its attention core
// _core_fwd_bwd_block. The TPU kernel does everything in one Pallas program
// per block of batch rows, carrying the weight grads in VMEM across its
// sequential grid. Blocks of a CUDA grid run in no order, so here the
// function is split into four kernels behind one torch function
// (plip_tpu_torch/ops/attention_bwd.py:attention_sublayer_bwd), and LN1 and
// qkv are recomputed with K1's ln_rows and gemm_bias_residual:
//
//   grad_gemm      C = op(A) . op(B), fp32 accumulation of exact bf16 (or
//                  fp32) products, either operand transposed. NT (A . B^T):
//                  dctx = g . Wout^T (cast to the compute dtype) and dln =
//                  dqkv . Wqkv^T (fp32). TN (A^T . B): dWout = ctx^T . g and
//                  dWqkv = ln^T . dqkv, summed over the B*S token rows in K
//                  slices, each slice's fp32 sum written apart and the
//                  slices added by col_sum (deterministic, no atomics).
//                  bf16: wgmma on a 128 x 128 tile (csrc/wgmma_gemm.cuh),
//                  slices planned by the caller to fill the card. fp32 (a
//                  check, not a mode): CUDA-core tiles (64x64x16), full
//                  fp32, no TF32, slices of 1024 rows, each k tile's
//                  products summed apart before they join the running sum.
//   attn_core_bwd  one block per (sequence, head), S <= 128: recomputes the
//                  logits and returns the context (for dWout) and dqkv.
//   ln_bwd_rows    LN1 backward in fp32 plus the residual: dx = g + dx_ln,
//                  and each block's partial sums of dgamma and dbeta.
//   col_sum        fp32 column sums: dbqkv, dbout, dgamma/dbeta from the
//                  partials, and the K slices of the TN products.
//
// Rounding points are the TPU kernel's, with the core's pipelined,
// deferred-divide schedule, which it takes at every S (_pipe_bwd):
//   e = exp(l - m) in fp32, denom = rowsum(e), e_c = e cast once;
//   ctx = (e_c . v) / denom, cast;   ghn = (g / denom) cast;
//   dv = e_c^T . ghn;  dp = g . v^T;  ds_u = (e * (dp - rowsum(dp*e)/denom)) cast;
//   dq = (ds_u . k) * scale / denom;  dk = ds_u^T . ((q / denom) cast) * scale;
//   dctx is cast to the compute dtype, dln stays fp32, the LN backward runs
//   in fp32 and dx = g + cast(dx_ln) is added in the compute dtype.
//
// What bounds it on the card. The four GEMMs (2*N*W*4W FLOPs each pass of
// the sublayer, 4 of them here) hold most of the work: at N = 1,600 to
// 16,448 token rows and W = 768 to 1024 each does about 300 to 700 FLOPs a
// byte it must move in bf16, at or above the card's 295 (989 TFLOP/s over
// 3.35 TB/s), so grad_gemm is bound by tensor-core throughput. Its
// bf16 design follows: wgmma m64n128k16 from 128-byte-swizzled shared
// memory (the only path to the card's full tensor-core rate), two
// warpgroups on a 128 x 128 tile, a five-stage cp.async ring so that the
// next K steps' copies run under the current step's wgmma, and TN's sum
// over the token rows cut into only as many slices as the 132 SMs need
// (ops/attention_bwd.py: tn_slice_rows), since every slice costs an fp32
// [M, N] written and read again by col_sum. The other kernels move bytes:
// the recompute of LN1 and qkv, and ln/qkv/ctx/dqkv/dln, make round trips
// through device memory that the TPU kernel kept in VMEM; fusing the
// recompute and the LN backward into the GEMMs' prologue and epilogue is
// the next step. attn_core_bwd's one-block kernel runs its dots on CUDA
// cores (csrc/mha_bwd.cu's key-tiled kernels run on wgmma).
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take) so the caller can raise.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace plip;

// ---------------------------------------------------------------------------
// grad_gemm: C[M, N] = op(A) . op(B).
// op(A) = A [M, K] row-major, or A^T with A stored [K, M] (kTA).
// op(B) = B [K, N] row-major, or B^T with B stored [N, K] (kTB).
// Only NT (A . B^T) and TN (A^T . B) are built. Block z of the grid sums k
// in [z*kslice, min(K, (z+1)*kslice)): NT runs K as one slice; TN takes the
// slice the caller planned (ops/attention_bwd.py: tn_slice_rows; fp32 1024
// rows) and, with more than one, writes fp32 to C + z*M*N (the caller adds
// the slices).
// ---------------------------------------------------------------------------

// fp32 on CUDA cores: 64x64 output tile, 256 threads, 4x4 outputs a thread.
constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16;

template <bool kTA, bool kTB>
__global__ void __launch_bounds__(256)
grad_gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K, int kslice) {
  __shared__ float As[kSimtBK][kSimtBM + 4];  // As[k][m]
  __shared__ float Bs[kSimtBK][kSimtBN + 4];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSimtBM, n0 = blockIdx.x * kSimtBN;
  const int kb = blockIdx.z * kslice, ke = min(K, kb + kslice);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kSimtBK) {
    // consecutive threads read consecutive addresses in either layout
    for (int i = tid; i < kSimtBM * kSimtBK; i += blockDim.x) {
      const int r = kTA ? i % kSimtBM : i / kSimtBK;  // m
      const int c = kTA ? i / kSimtBM : i % kSimtBK;  // k
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < ke) v = kTA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      As[c][r] = v;
    }
    for (int i = tid; i < kSimtBK * kSimtBN; i += blockDim.x) {
      const int r = kTB ? i % kSimtBK : i / kSimtBN;  // k
      const int c = kTB ? i / kSimtBK : i % kSimtBN;  // n
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < ke && gn < N) v = kTB ? B[(size_t)gn * K + gk] : B[(size_t)gk * N + gn];
      Bs[r][c] = v;
    }
    __syncthreads();
    float part[4][4] = {};  // this k tile's sums, added to acc once
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
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
  float* Cz = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) Cz[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// bf16 on wgmma: the main loop of csrc/wgmma_gemm.cuh, a 128 x 128 tile a
// block; NT reads both operands K-major, TN both MN-major (the transpose-A
// and transpose-B bits). Each operand's contiguous dimension must hold whole
// 8-element chunks (16-byte copies); a chunk is then wholly inside or wholly
// outside the matrix and the K slice (a multiple of the 64-deep K step).
template <bool kTN, typename TOut>
__global__ void __launch_bounds__(hopper::kGemmThreads, 1)
grad_gemm_wgmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                       TOut* __restrict__ C, int M, int N, int K, int kslice) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  const int m0 = blockIdx.y * hopper::kGemmBM, n0 = blockIdx.x * hopper::kGemmBN;
  const int kb = blockIdx.z * kslice, ke = min(K, kb + kslice);
  float acc[64];
  hopper::gemm_mainloop<kTN, kTN>(A, B, M, N, K, m0, n0, kb, ke, gemm_smem, acc);
  TOut* Cz = C + (size_t)blockIdx.z * M * N;
  hopper::gemm_epilogue(acc, m0, n0, [&](int m, int n, float x0, float x1) {
    if (m >= M || n >= N) return;
    TOut* c = Cz + (size_t)m * N + n;
    if (N % 2 == 0) {  // n is even, so the pair is in the row and aligned
      hopper::store_pair(c, x0, x1);
    } else {
      c[0] = from_f<TOut>(x0);
      if (n + 1 < N) c[1] = from_f<TOut>(x1);
    }
  });
}

template <bool kTN, typename TOut>
cudaError_t launch_grad_gemm_wgmma(const void* a, const void* b, void* out, int M, int N,
                                   int K, int kslice, int splits, cudaStream_t s) {
  constexpr int kSmem = (int)hopper::gemm_smem_bytes(hopper::kGemmStages);
  cudaError_t err = cudaFuncSetAttribute(grad_gemm_wgmma_kernel<kTN, TOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + hopper::kGemmBN - 1) / hopper::kGemmBN,
                  (M + hopper::kGemmBM - 1) / hopper::kGemmBM, splits);
  grad_gemm_wgmma_kernel<kTN, TOut><<<grid, hopper::kGemmThreads, kSmem, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<TOut*>(out), M,
      N, K, kslice);
  return cudaGetLastError();
}

template <bool kTN>
cudaError_t launch_grad_gemm(const void* a, const void* b, void* out, int M, int N, int K,
                             int kslice, int dtype, int out_f32, cudaStream_t s) {
  constexpr bool kTA = kTN, kTB = !kTN;
  const int splits = (K + kslice - 1) / kslice;
  if ((splits > 1 && !out_f32) || (!kTN && splits > 1)) return cudaErrorInvalidValue;
  if (dtype == kF32) {
    const dim3 grid((N + kSimtBN - 1) / kSimtBN, (M + kSimtBM - 1) / kSimtBM, splits);
    grad_gemm_f32_kernel<kTA, kTB><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), M, N, K, kslice);
    return cudaGetLastError();
  }
  if (dtype != kBF16) return cudaErrorInvalidValue;
  // the contiguous dimension of each operand holds whole 8-element chunks, a
  // slice whole K steps
  if ((kTA ? M : K) % 8 || (kTB ? K : N) % 8 || (splits > 1 && kslice % hopper::kGemmBK) ||
      (M + hopper::kGemmBM - 1) / hopper::kGemmBM > 65535)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorMisalignedAddress;
  if (out_f32) return launch_grad_gemm_wgmma<kTN, float>(a, b, out, M, N, K, kslice, splits, s);
  return launch_grad_gemm_wgmma<kTN, bf16>(a, b, out, M, N, K, kslice, splits, s);
}

// ---------------------------------------------------------------------------
// attn_core_bwd: qkv [B*S, 3W] (columns [q heads | k heads | v heads], each
// head's D columns contiguous) and dctx [B*S, W] -> ctx [B*S, W] (the
// forward's context, recomputed) and dqkv [B*S, 3W]. One block per
// (sequence, head), 8 warps.
//
//   1. k and v of the head into shared memory (compute dtype).
//   2. One warp per query row i: the row's logits (four columns a lane),
//      e, denom, dp and ds_u; the row of e_c and of ds_u into shared memory;
//      then ctx_i and dq_i, lanes over the head dimension.
//   3. q/denom and g/denom, cast, overwrite k and v in shared memory.
//   4. One warp per key column j: dk_j and dv_j, lanes over the head dim.
// Every value kept in shared memory is one the TPU kernel casts to the
// compute dtype, so storing it in that dtype loses nothing.
// ---------------------------------------------------------------------------

constexpr int kCoreThreads = 256;
constexpr int kMaxSeq = 128;  // four logits per lane

template <typename T>
__global__ void __launch_bounds__(kCoreThreads)
attn_core_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                     T* __restrict__ ctx, T* __restrict__ dqkv, int S, int heads, int D,
                     int causal, int s_valid, float scale) {
  extern __shared__ float smem[];
  const int W = heads * D, W3 = 3 * W;
  // k and v rows padded by one 4-byte word: lanes that read one column of
  // 32 rows then hit 32 different banks
  const int LD = D + 4 / (int)sizeof(T);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = blockDim.x / 32;
  float* denom_s = smem;                     // [S]
  float* qw = denom_s + S + warp * 2 * D;    // this warp's q row, fp32
  float* gw = qw + D;                        // this warp's g row, fp32
  T* Ks = reinterpret_cast<T*>(denom_s + S + nwarp * 2 * D);  // [S][LD]; later q/denom
  T* Vs = Ks + S * LD;                       // [S][LD]; later g/denom
  T* Es = Vs + S * LD;                       // [S][S] e_c
  T* DSs = Es + S * S;                       // [S][S] ds_u
  const size_t row0 = (size_t)b * S;

  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    const int j = i / D, d = i % D;
    Ks[j * LD + d] = qkv[(row0 + j) * W3 + W + h * D + d];
    Vs[j * LD + d] = qkv[(row0 + j) * W3 + 2 * W + h * D + d];
  }
  __syncthreads();

  for (int i = warp; i < S; i += nwarp) {
    for (int d = lane; d < D; d += 32) {
      qw[d] = to_f(qkv[(row0 + i) * W3 + h * D + d]);
      gw[d] = to_f(dctx[(row0 + i) * W + h * D + d]);
    }
    __syncwarp();
    const int jend = min(causal ? i + 1 : S, s_valid);  // columns that are kept
    float e[kMaxSeq / 32], dp[kMaxSeq / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < jend) {
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qw[d], to_f(Ks[j * LD + d]), a);
        s = a * scale;
      }
      e[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);  // finite: column 0 is never masked
    float denom = 0.f, dsum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      e[t] = expf(e[t] - m);  // 0 where masked
      denom += e[t];
      float a = 0.f;
      if (j < jend)
        for (int d = 0; d < D; ++d) a = fmaf(gw[d], to_f(Vs[j * LD + d]), a);
      dp[t] = a;
      dsum += a * e[t];
    }
    denom = warp_sum(denom);
    dsum = warp_sum(dsum);
    const float c = dsum / denom;
#pragma unroll
    for (int t = 0; t < kMaxSeq / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        Es[i * S + j] = from_f<T>(e[t]);
        DSs[i * S + j] = from_f<T>(e[t] * (dp[t] - c));
      }
    }
    if (lane == 0) denom_s[i] = denom;
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float a = 0.f, q = 0.f;
      for (int j = 0; j < jend; ++j) {
        a = fmaf(to_f(Es[i * S + j]), to_f(Vs[j * LD + d]), a);
        q = fmaf(to_f(DSs[i * S + j]), to_f(Ks[j * LD + d]), q);
      }
      ctx[(row0 + i) * W + h * D + d] = from_f<T>(a / denom);
      dqkv[(row0 + i) * W3 + h * D + d] = from_f<T>((q * scale) / denom);
    }
    __syncwarp();  // qw and gw are rewritten for the warp's next row
  }
  __syncthreads();  // every warp is done with k and v

  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const float den = denom_s[r];
    Ks[r * LD + d] = from_f<T>(to_f(qkv[(row0 + r) * W3 + h * D + d]) / den);
    Vs[r * LD + d] = from_f<T>(to_f(dctx[(row0 + r) * W + h * D + d]) / den);
  }
  __syncthreads();

  for (int j = warp; j < S; j += nwarp) {
    const int ibeg = causal ? j : 0;  // rows that keep column j
    const bool kept = j < s_valid;
    for (int d = lane; d < D; d += 32) {
      float dk = 0.f, dv = 0.f;
      if (kept)
        for (int i = ibeg; i < S; ++i) {
          dk = fmaf(to_f(DSs[i * S + j]), to_f(Ks[i * LD + d]), dk);
          dv = fmaf(to_f(Es[i * S + j]), to_f(Vs[i * LD + d]), dv);
        }
      dqkv[(row0 + j) * W3 + W + h * D + d] = from_f<T>(dk * scale);
      dqkv[(row0 + j) * W3 + 2 * W + h * D + d] = from_f<T>(dv);
    }
  }
}

template <typename T>
size_t core_bwd_smem_bytes(int S, int D) {
  const int LD = D + 4 / (int)sizeof(T);
  return sizeof(float) * ((size_t)S + (kCoreThreads / 32) * 2 * (size_t)D) +
         sizeof(T) * (2 * (size_t)S * LD + 2 * (size_t)S * S);
}

template <typename T>
cudaError_t launch_core_bwd(const void* qkv, const void* dctx, void* ctx, void* dqkv,
                            int B, int S, int heads, int D, int causal, int s_valid,
                            cudaStream_t stream) {
  const size_t smem = core_bwd_smem_bytes<T>(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  attn_core_bwd_kernel<T><<<B * heads, kCoreThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dctx), static_cast<T*>(ctx),
      static_cast<T*>(dqkv), S, heads, D, causal, s_valid, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ln_bwd_rows: for each row of x [rows, W] (compute dtype), dln [rows, W]
// (fp32) and g [rows, W] (the residual's grad):
//   xhat = (x - mean) * rstd, dxhat = dln * gamma,
//   dx_ln = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dx = g + cast(dx_ln), added in the compute dtype;
// and per block of kLnBwdRows rows, partial[block] = [sum dln*xhat | sum dln]
// ([2W] fp32), which col_sum adds into dgamma and dbeta.
// ---------------------------------------------------------------------------

constexpr int kLnBwdThreads = 256;
constexpr int kLnBwdRows = 8;

template <typename T>
__global__ void __launch_bounds__(kLnBwdThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dln,
                   const T* __restrict__ g, const float* __restrict__ gamma,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int width,
                   float eps) {
  extern __shared__ float acc[];  // [2W]: this block's sums of dln*xhat, dln
  __shared__ float red[32];
  for (int c = threadIdx.x; c < 2 * width; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();
  const int r0 = blockIdx.x * kLnBwdRows, r1 = min(rows, r0 + kLnBwdRows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * width;
    const float* dr = dln + (size_t)r * width;
    float s = 0.f;
    for (int c = threadIdx.x; c < width; c += blockDim.x) s += to_f(xr[c]);
    const float mean = block_sum(s, red) / width;
    float v = 0.f;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const float d = to_f(xr[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(block_sum(v, red) / width + eps);
    float sa = 0.f, sb = 0.f;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float dxh = dr[c] * gamma[c];
      sa += dxh;
      sb += dxh * xh;
    }
    const float ma = block_sum(sa, red) / width;
    const float mb = block_sum(sb, red) / width;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float dxh = dr[c] * gamma[c];
      const float dxl = rstd * (dxh - ma - xh * mb);
      const size_t o = (size_t)r * width + c;
      dx[o] = from_f<T>(to_f(g[o]) + round_to<T>(dxl));
      acc[c] += dr[c] * xh;
      acc[width + c] += dr[c];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * width; c += blockDim.x)
    partial[(size_t)blockIdx.x * 2 * width + c] = acc[c];
}

// ---------------------------------------------------------------------------
// col_sum: out[n] = sum over r of in[r, n], fp32, for in [R, N] in fp32 or
// the compute dtype. A block takes 32 columns (one a lane, so loads are
// coalesced); its 8 warps each sum every 8th row and the 8 sums are added.
// For R <= 8 rows (the slices of a TN product: few rows, millions of
// columns) a thread takes one column and adds its rows in order from 0, the
// order of the general kernel's sums at such R (so fp32 results are the
// same bits); a block then moves 256 columns instead of 32.
// ---------------------------------------------------------------------------

constexpr int kShortRows = 8;

template <typename T>
__global__ void __launch_bounds__(256)
col_sum_kernel(const T* __restrict__ in, float* __restrict__ out, int R, int N) {
  __shared__ float part[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (n < N)
    for (int r = ty; r < R; r += 8) s += to_f(in[(size_t)r * N + n]);
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += part[k][tx];
    out[n] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
col_sum_short_kernel(const T* __restrict__ in, float* __restrict__ out, int R, int N) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float t = 0.f;
  for (int r = 0; r < R; ++r) t += to_f(in[(size_t)r * N + n]);
  out[n] = t;
}

template <typename T>
void launch_col_sum(const T* in, float* out, int rows, int cols, cudaStream_t s) {
  if (rows <= kShortRows)
    col_sum_short_kernel<T><<<(cols + 255) / 256, 256, 0, s>>>(in, out, rows, cols);
  else
    col_sum_kernel<T><<<(cols + 31) / 32, 256, 0, s>>>(in, out, rows, cols);
}

}  // namespace

extern "C" {

// tn = 0: out = a [M, K] . b [N, K]^T, [M, N] in fp32 (out_f32) or the
// compute dtype, kslice >= K. tn = 1: out = a [K, M]^T . b [K, N] in fp32,
// [splits, M, N] for splits = ceil(K / kslice) > 1 (bf16: kslice a multiple
// of 64), else [M, N]. bf16 operands 16-byte aligned.
int plip_grad_gemm(const void* a, const void* b, void* out, int M, int N, int K, int kslice,
                   int tn, int out_f32, int dtype, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kslice <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tn) return launch_grad_gemm<true>(a, b, out, M, N, K, kslice, dtype, out_f32, s);
  return launch_grad_gemm<false>(a, b, out, M, N, K, kslice, dtype, out_f32, s);
}

int plip_attn_core_bwd(const void* qkv, const void* dctx, void* ctx, void* dqkv, int B,
                       int S, int heads, int head_dim, int causal, int s_valid,
                       int dtype, int device, void* stream) {
  if (B <= 0 || heads <= 0 || S <= 0 || S > kMaxSeq || head_dim <= 0 ||
      head_dim > 128 || s_valid < 1 || s_valid > S)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_core_bwd<float>(qkv, dctx, ctx, dqkv, B, S, heads, head_dim, causal,
                                  s_valid, s);
  if (dtype == plip::kBF16)
    return launch_core_bwd<plip::bf16>(qkv, dctx, ctx, dqkv, B, S, heads, head_dim,
                                       causal, s_valid, s);
  return cudaErrorInvalidValue;
}

// partial: [ceil(rows / 8), 2 * width] fp32.
int plip_ln_bwd_rows(const void* x, const float* dln, const void* g, const float* gamma,
                     void* dx, float* partial, int rows, int width, float eps, int dtype,
                     int device, void* stream) {
  if (rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)width * sizeof(float);
  const int grid = (rows + kLnBwdRows - 1) / kLnBwdRows;
  if (dtype == plip::kF32) {
    err = cudaFuncSetAttribute(ln_bwd_rows_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ln_bwd_rows_kernel<float><<<grid, kLnBwdThreads, smem, s>>>(
        static_cast<const float*>(x), dln, static_cast<const float*>(g), gamma,
        static_cast<float*>(dx), partial, rows, width, eps);
  } else if (dtype == plip::kBF16) {
    err = cudaFuncSetAttribute(ln_bwd_rows_kernel<plip::bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ln_bwd_rows_kernel<plip::bf16><<<grid, kLnBwdThreads, smem, s>>>(
        static_cast<const plip::bf16*>(x), dln, static_cast<const plip::bf16*>(g), gamma,
        static_cast<plip::bf16*>(dx), partial, rows, width, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// in: [rows, cols] fp32 or bf16 (dtype); out: [cols] fp32.
int plip_col_sum(const void* in, float* out, int rows, int cols, int dtype, int device,
                 void* stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    launch_col_sum(static_cast<const float*>(in), out, rows, cols, s);
  else if (dtype == plip::kBF16)
    launch_col_sum(static_cast<const plip::bf16*>(in), out, rows, cols, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
