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
//   ln_rows             fp32 mean and variance, the affine in fp32, one cast
//                       to the compute dtype; a row in a warp's registers
//                       (layer_norm.cuh). Also every other LayerNorm of the
//                       towers (ops/attention.py layer_norm_rows).
//   gemm_bias_residual  C = cast(A . B + bias) [+ residual], fp32 accumulation:
//                       the GEMM of gemm.cuh (bf16: wgmma on 128 x 128
//                       tiles, two blocks an SM; fp32: the CUDA-core loop of
//                       simt_gemm.cuh, 8 x 8 register micro-tiles, full
//                       fp32, no TF32).
//   attn_core           bf16 at head_dim 64: S <= 128, the head on chip, one
//                       q . k^T on wgmma (below); longer, csrc/mha.cu's
//                       key-tiled kernel. fp32, the dtype PLIP and
//                       CLIPTuner take by default (S <= 256), and bf16 at
//                       another head_dim (S <= 256): 64 query rows a block,
//                       the head's live k and v in shared memory, both dots
//                       register-tiled on CUDA cores (below); fp32 past 256,
//                       the key-tiled kernel. All: logits scaled after the
//                       dot, causal and column >= s_valid masks, fp32
//                       softmax against the exact row max, P cast to the
//                       compute dtype before P . v (fp32 sum). Up to S = 128
//                       the softmax normalizes first; above it the divide is
//                       deferred past P . v (the TPU kernel's _pipe_fwd);
//                       every kernel takes either schedule (the
//                       normalize-first context K7 recomputes at any S).
//
// The rounding points are the TPU kernel's: LN statistics fp32; qkv and the
// out-projection accumulate in fp32, add the fp32 bias, then cast; the
// residual x + y is added in the compute dtype.
//
// What bounds it on the card. The two GEMMs hold almost all of the FLOPs
// (2*N*W*4W per layer against 4*N*S*W for the core), so at serving batch
// sizes the sublayer is bound by tensor-core throughput, which gemm.cuh
// approaches on wgmma (a 128 x 128 tile, a cp.async ring; its first
// design, WMMA on 64 x 64 tiles with synchronous loads, left most of it on
// the table); ln, qkv and ctx make a round trip through device memory
// between the kernels (the TPU kernel kept them in VMEM). The core at short
// S is bound by bytes: one head's q, k and v (S*D*2 bytes each) in and its
// context out against 4*S^2*D FLOPs, S/2 FLOPs a byte (25-64 at S =
// 50-128), under the card's 295 (in fp32 S/4 a byte against the 20 of the
// FFMA rate, so near the ridge). Its first design ran both dots as scalar
// fmaf loops on CUDA cores, one warp a query row, one shared-memory load
// an FMA, with the head's k and v in shared memory as fp32 (about 101 KB
// at S = 197, two blocks an SM): 64x its bytes bound at ViT-B/16. The
// CUDA-core kernel that serves fp32 now holds a thread's 4 x 16 logits
// and 4 x 4 context values in registers, 16 FMAs a 16-byte load.
// The bf16 core now holds the head as bf16 in swizzled tiles (at most 16 KB
// each of k and v), loads each once per q tile with cp.async, computes a q
// tile's logits over every live key tile once on wgmma (they stay in
// registers: 32 fp32 a thread a key tile), takes the exact max and the row
// sum from registers, runs P . v from registers, and skips the logits no
// row of a warp may see (ragged tiles, padding rows, the causal triangle).
// Past two key tiles a q tile's logits no longer fit one warpgroup's
// registers at the occupancy that csrc/mha.cu's key-tiled kernel reaches
// (it streams the keys in two passes, five blocks an SM), and that kernel
// measured faster there, so S > 128 takes it. Fusing LN into the QKV
// GEMM's A-tile load and keeping ctx on chip are the next steps for the
// sublayer.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take) so the caller can raise.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"
#include "layer_norm.cuh"
#include "wgmma.cuh"

namespace {

using namespace plip;

// ---------------------------------------------------------------------------
// ln_rows: y = (x - mean) * rstd * scale + bias per row of x [rows, W], fp32
// statistics (the variance the mean of squared deviations), one cast.
//
// Bound by bytes: 2 * W * size a row (x in, y out) against about 8 W
// operations. (One block a row, three scalar passes over it and two block
// sums' barriers, the first design, ran at 7-13% of that bound.) A row lives
// in registers (layer_norm.cuh): one warp a row at the towers' widths (a few
// warps where registers run short), read once with 16-byte loads, mean and
// variance from shuffles over the registers, scale and bias held in
// registers across the rows a warp takes, a grid of rows walked in strides
// that fills the SMs. Widths past the register layout's reach
// (ops/attention.py LN_MAX_WIDTH) take ln_rows_wide_kernel, one block a row.
// ---------------------------------------------------------------------------

template <typename T, int V, int kChunks>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int rows, int width,
               int warps, float eps) {
  __shared__ float red[2 * kLnWarps];
  const LnLane l(warps);
  const int chunks = width / V, stride = 32 * warps;
  float sc[kChunks][V], bi[kChunks][V];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = l.t + k * stride;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sc[k][i] = c < chunks ? __ldg(scale + c * V + i) : 0.f;
      bi[k][i] = c < chunks ? __ldg(bias + c * V + i) : 0.f;
    }
  }
  for (int r = blockIdx.x * l.groups + l.group; r < rows; r += gridDim.x * l.groups) {
    const T* xr = x + (size_t)r * width;
    T* yr = out + (size_t)r * width;
    LnRaw<T, V> v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (l.t + k * stride < chunks)
        v[k].load(xr + (l.t + k * stride) * V);
      else
        v[k].zero();
    }
    float mean, rstd;
    ln_stats<V, kChunks>(v, chunks, width, eps, red, l, mean, rstd);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = l.t + k * stride;
      if (c < chunks) {
        float y[V];
#pragma unroll
        for (int i = 0; i < V; ++i) y[i] = (v[k][i] - mean) * rstd * sc[k][i] + bi[k][i];
        ln_store<T, V>(yr + c * V, y);
      }
    }
  }
}

// One block a row, any width.
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
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

template <typename T, int V>
cudaError_t launch_ln_rows_vec(const T* x, const float* scale, const float* bias, T* out,
                               int rows, int width, int values, int warps, int blocks,
                               float eps, cudaStream_t s) {
  switch (values) {
#define PLIP_LN_ROWS(kValues)                                                              \
  case kValues:                                                                            \
    ln_rows_kernel<T, V, kValues / V><<<blocks, kLnThreads, 0, s>>>(x, scale, bias, out,   \
                                                                     rows, width, warps, eps); \
    break;
    PLIP_LN_ROWS(8)
    PLIP_LN_ROWS(16)
    PLIP_LN_ROWS(24)
    PLIP_LN_ROWS(32)
#undef PLIP_LN_ROWS
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// vec: 16 bytes' worth of T (x and out 16-byte aligned, width a multiple of
// it) or 1; values: the register bucket; warps: warps a row, 0 for
// ln_rows_wide_kernel (one block a row, blocks ignored).
template <typename T>
cudaError_t launch_ln_rows(const void* x, const float* scale, const float* bias, void* out,
                           int rows, int width, int vec, int values, int warps, int blocks,
                           float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (warps == 0) {
    ln_rows_wide_kernel<T><<<rows, kLnThreads, 0, s>>>(xt, scale, bias, ot, width, eps);
    return cudaGetLastError();
  }
  constexpr int kVec = 16 / sizeof(T);
  if ((warps != 1 && warps != 2 && warps != 4 && warps != 8) || blocks <= 0 ||
      width > 32 * warps * values)
    return cudaErrorInvalidValue;
  if (vec == 1)
    return launch_ln_rows_vec<T, 1>(xt, scale, bias, ot, rows, width, values, warps, blocks,
                                    eps, s);
  if (vec != kVec || width % kVec) return cudaErrorInvalidValue;
  if (!aligned16({x, out})) return cudaErrorMisalignedAddress;
  return launch_ln_rows_vec<T, kVec>(xt, scale, bias, ot, rows, width, values, warps, blocks,
                                     eps, s);
}

// ---------------------------------------------------------------------------
// gemm_bias_residual: C[M, N] = cast(A[M, K] . B[K, N] + bias[N]) (+ R[M, N])
// A, B, R, C row-major; B is the [in, out] weight as the JAX package keeps it.
// The GEMM of gemm.cuh with this epilogue: the residual is added to the cast
// sum in fp32 and cast again, which is the add in the compute dtype.
// ---------------------------------------------------------------------------

template <typename T>
struct BiasResidual {
  const float* bias;
  const T* R;  // may be null
  T* C;
  int ld;
  template <int kW>
  __device__ __forceinline__ void operator()(int m, int n, const float (&x)[kW]) const {
    const size_t o = (size_t)m * ld + n;
    float b[kW], y[kW];
    hopper::load_vec<kW>(bias + n, b);
#pragma unroll
    for (int i = 0; i < kW; ++i) y[i] = round_to<T>(x[i] + b[i]);
    if (R) {
      float r[kW];
      hopper::load_vec<kW>(R + o, r);
#pragma unroll
      for (int i = 0; i < kW; ++i) y[i] = r[i] + y[i];  // cast by the store
    }
    hopper::store_vec<kW>(C + o, y);
  }
};

// gemm_bias_residual's fp32 partial mode (gemm_partial): C[M, N] = A . B in
// fp32, no bias, no cast, no residual. Under tensor parallelism a rank's
// share of a row-parallel product (the out-projection's or fc2's input
// rows); the ranks' sums are all-reduced, then csrc/tp_epilogue.cu adds the
// bias and the residual in K1's order.
struct Partial {
  float* C;
  int ld;
  template <int kW>
  __device__ __forceinline__ void operator()(int m, int n, const float (&x)[kW]) const {
    hopper::store_vec<kW>(C + (size_t)m * ld + n, x);
  }
};

// ---------------------------------------------------------------------------
// attn_core, one block per 64 query rows of a (sequence, head), on CUDA
// cores: fp32 (the default dtype) at S <= 256, and bf16 at a head_dim other
// than 64 (the wgmma kernel below is built for 64). qkv [B*S, 3W] (columns
// [q heads | k heads | v heads], each head's D columns contiguous) -> ctx
// [B*S, W]; D a multiple of 4, up to 128.
// grid = (q tiles, heads, B), 256 threads, 16 x 16 (tx, ty).
//
//   1. The q tile and the head's live keys of k and v into shared memory as
//      fp32, once: fp32 by 16-byte cp.async, bf16 by 8-byte loads. A key is
//      live below min(S, s_valid) and, causal, below the tile's last row + 1;
//      key tiles past the live keys are neither loaded nor multiplied, and
//      live rows of k and v past those keys are zero up to the tile's end.
//      Where k and v side by side would not fit (core_v_over_k), v comes
//      over k after step 2, its copies under step 3's writes of P.
//   2. The logits of the q tile, register-tiled: thread (tx, ty) holds rows
//      4 ty .. 4 ty + 3 against keys tx + 16 jj of each 64-key tile (16 a
//      tile), each a 16-byte load of q and of k per 4 d (q shared by the
//      half-warp, k rows padded to an odd count of 16-byte units: no bank
//      conflict), scaled by D^-1/2 after the dot, masked (causal, s_valid)
//      to -inf.
//   3. The exact row max and the fp32 row sum from registers: the thread's
//      values, then shuffles among the 16 threads of a row. P = cast(e /
//      sum) (normalize-first) or cast(e) (deferred), rounded to T and kept
//      as fp32 in shared memory, over the q tile (ViT-B/32: 51 KB a block
//      at S = 50, four blocks an SM; 102 KB at S = 77, two).
//   4. P . v register-tiled: a thread takes 4 rows x 4 columns (two items at
//      D = 128), 16-byte loads of P and v per 4 keys, keys up to the rows'
//      last live one; deferred, divided by the row sum; one cast.
// The keys one row may see are the reference's: pairs masked to -inf give
// e = 0 exactly, so P, the sum and the context are the same sums as the
// plain version's, in another order.
// ---------------------------------------------------------------------------

constexpr int kCoreThreads = 256;
constexpr int kCoreQT = 64;   // query rows a block; keys a tile
constexpr int kMaxSeq = 256;  // four key tiles

// k and q rows of the one-block core padded to an odd count of 16-byte
// units (16 threads read 16 rows without a bank conflict).
__host__ __device__ __forceinline__ int core_ldk(int D) { return (D / 4) % 2 ? D : D + 4; }

// The shared memory of a block (ops/attention.py _core_smem_bytes), in fp32:
// the q tile, which P overwrites once the logits are in registers; k and v
// of ceil(S / 64) key tiles, v beside k or, v_over_k, over k once the
// logits are in; the row sums.
size_t core_smem_bytes(int S, int D, bool v_over_k) {
  const size_t keys = (size_t)kCoreQT * ((S + kCoreQT - 1) / kCoreQT);
  const size_t qp = kCoreQT * std::max<size_t>(core_ldk(D), keys + 4);
  return sizeof(float) * (qp + keys * core_ldk(D) + (v_over_k ? 0 : keys * D) + kCoreQT);
}

// v goes over k where the two side by side would pass the card's 227 KB a
// block (ops/attention.py core_v_over_k): past 128 tokens at the widest
// heads (head_dim 96 at S > 192, 128 at S > 128). Then v is loaded only
// after the logits, under the writes of P.
constexpr size_t kMaxSmem = 232448;
bool core_v_over_k(int S, int D) { return core_smem_bytes(S, D, false) > kMaxSmem; }

// Four values of T at src into dst as fp32; zero unless ok (src is then
// any mapped address).
__device__ __forceinline__ void load4_f32(float* dst, const float* src, bool ok) {
  hopper::cp_async16(hopper::smem_u32(dst), src, ok);
}
__device__ __forceinline__ void load4_f32(float* dst, const bf16* src, bool ok) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    x = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kKT: key tiles of 64 the block's registers hold (S <= 64 kKT). kVOverK:
// v over k (core_v_over_k).
template <typename T, int kKT, bool kVOverK>
__global__ void __launch_bounds__(kCoreThreads)
attn_core_simt_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int S, int heads,
                      int D, int causal, int s_valid, int defer, float scale) {
  extern __shared__ __align__(16) float core_smem[];
  const int ldk = core_ldk(D), ldp = kCoreQT * kKT + 4, dc = D / 4;
  float* Qs = core_smem;                     // [64][ldk]
  float* Ps = core_smem;                     // [64][ldp], over q after the logits
  float* Ks = Qs + kCoreQT * max(ldk, ldp);  // [64 kKT][ldk]
  float* Vs = kVOverK ? Ks : Ks + kCoreQT * kKT * ldk;  // [64 kKT][D]
  float* rsum = Vs + (kVOverK ? kCoreQT * kKT * ldk : kCoreQT * kKT * D);  // [64]
  const int W = heads * D, W3 = 3 * W;
  const int q0 = blockIdx.x * kCoreQT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (size_t)b * S * W3 + h * D;
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kCoreQT);
  const int live = (n_keys + kCoreQT - 1) / kCoreQT;  // live key tiles, <= kKT

  for (int e = threadIdx.x; e < kCoreQT * dc; e += kCoreThreads) {
    const int r = e / dc, c = 4 * (e % dc);
    const bool ok = q0 + r < S;
    load4_f32(Qs + r * ldk + c, ok ? base + (size_t)(q0 + r) * W3 + c : qkv, ok);
  }
  // k and (with_v) v of the live key tiles, zero from n_keys; one loop for
  // both, whose index math they share
  auto load_kv = [&](bool with_k, bool with_v) {
    for (int e = threadIdx.x; e < kCoreQT * live * dc; e += kCoreThreads) {
      const int j = e / dc, c = 4 * (e % dc);
      const bool ok = j < n_keys;
      const T* row = base + (size_t)(ok ? j : 0) * W3 + c;
      if (with_k) load4_f32(Ks + j * ldk + c, row + W, ok);
      if (with_v) load4_f32(Vs + j * D + c, row + 2 * W, ok);
    }
  };
  load_kv(true, !kVOverK);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float l[kKT][4][4];  // [key tile][row 4 ty + i][key tx + 16 jj]
#pragma unroll
  for (int c = 0; c < kKT; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) l[c][i][jj] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * ldk + d);
#pragma unroll
    for (int c = 0; c < kKT; ++c) {
      if (c >= live) break;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 k = *reinterpret_cast<const float4*>(
            Ks + (kCoreQT * c + tx + 16 * jj) * ldk + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          l[c][i][jj] = fmaf(q[i].w, k.w, fmaf(q[i].z, k.z, fmaf(q[i].y, k.y,
                        fmaf(q[i].x, k.x, l[c][i][jj]))));
      }
    }
  }

  float mx[4], sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    mx[i] = -INFINITY;
#pragma unroll
    for (int c = 0; c < kKT; ++c)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = kCoreQT * c + tx + 16 * jj;
        const bool keep = c < live && j < n_keys && !(causal && j > row);
        l[c][i][jj] = keep ? l[c][i][jj] * scale : -INFINITY;
        mx[i] = fmaxf(mx[i], l[c][i][jj]);
      }
    mx[i] = half_warp_max(mx[i]);  // finite: key 0 is never masked
    sum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kKT; ++c)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        l[c][i][jj] = expf(l[c][i][jj] - mx[i]);  // masked: exp(-inf) = 0
        sum[i] += l[c][i][jj];
      }
    sum[i] = half_warp_sum(sum[i]);
  }
  __syncthreads();  // every thread's logits are in: P goes over q (v over k)
  if (kVOverK) {
    load_kv(false, true);
    hopper::cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kKT; ++c) {
      if (c >= live) break;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        Ps[(4 * ty + i) * ldp + kCoreQT * c + tx + 16 * jj] =
            round_to<T>(defer ? l[c][i][jj] : l[c][i][jj] / sum[i]);
    }
    if (tx == 0) rsum[4 * ty + i] = sum[i];
  }
  if (kVOverK) hopper::cp_async_wait<0>();
  __syncthreads();

  const int kend = (n_keys + 3) & ~3;  // P and v are zero from n_keys to there
  for (int it = threadIdx.x; it < (kCoreQT / 4) * dc; it += kCoreThreads) {
    const int r0 = 4 * (it / dc), c = 4 * (it % dc);
    if (q0 + r0 >= S) continue;
    const int jend = causal ? min(kend, q0 + r0 + 4) : kend;
    float acc[4][4] = {};
    for (int j = 0; j < jend; j += 4) {
      float4 p[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = *reinterpret_cast<const float4*>(Vs + (j + jj) * D + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][0] = fmaf(pi[jj], v[jj].x, acc[i][0]);
          acc[i][1] = fmaf(pi[jj], v[jj].y, acc[i][1]);
          acc[i][2] = fmaf(pi[jj], v[jj].z, acc[i][2]);
          acc[i][3] = fmaf(pi[jj], v[jj].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
      if (row >= S) break;
      const float den = defer ? rsum[r0 + i] : 1.f;
      const float y[4] = {acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den};
      hopper::store_vec<4>(ctx + ((size_t)b * S + row) * W + h * D + c, y);
    }
  }
}

template <typename T, int kKT, bool kVOverK>
cudaError_t launch_core_simt_layout(const void* qkv, void* ctx, int B, int S, int heads,
                                    int D, int causal, int s_valid, int defer,
                                    cudaStream_t stream) {
  const size_t smem = core_smem_bytes(S, D, kVOverK);
  cudaError_t err = cudaFuncSetAttribute(attn_core_simt_kernel<T, kKT, kVOverK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kCoreQT - 1) / kCoreQT, heads, B);
  attn_core_simt_kernel<T, kKT, kVOverK><<<grid, kCoreThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(ctx), S, heads, D, causal, s_valid, defer,
      (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// Up to two key tiles k and v fit side by side at any head_dim <= 128.
template <typename T, int kKT>
cudaError_t launch_core_simt_tiles(const void* qkv, void* ctx, int B, int S, int heads, int D,
                                   int causal, int s_valid, int defer, cudaStream_t stream) {
  if (kKT > 2 && core_v_over_k(S, D))  // kKT > 2: no v-over-k kernel below three tiles
    return launch_core_simt_layout<T, kKT, (kKT > 2)>(qkv, ctx, B, S, heads, D, causal,
                                                      s_valid, defer, stream);
  return launch_core_simt_layout<T, kKT, false>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                defer, stream);
}

// S <= 256, D % 4 == 0, qkv and ctx 16-byte aligned.
template <typename T>
cudaError_t launch_core_simt(const void* qkv, void* ctx, int B, int S, int heads, int D,
                             int causal, int s_valid, int defer, cudaStream_t stream) {
  if (D % 4 || reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(ctx) % 16)
    return D % 4 ? cudaErrorInvalidValue : cudaErrorMisalignedAddress;
  switch ((S + kCoreQT - 1) / kCoreQT) {
    case 1: return launch_core_simt_tiles<T, 1>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                defer, stream);
    case 2: return launch_core_simt_tiles<T, 2>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                defer, stream);
    case 3: return launch_core_simt_tiles<T, 3>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                defer, stream);
    default: return launch_core_simt_tiles<T, 4>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                 defer, stream);
  }
}

// ---------------------------------------------------------------------------
// attn_core, bf16: the head on chip, one q . k^T, wgmma (csrc/wgmma.cuh).
// grid = (q tiles, heads, B): one warpgroup takes query rows q0..q0+63 of
// (sequence b, head h) against every key of the head, D = 64, S <= 128.
//
//   1. cp.async: the q tile and the head's live key tiles of k (a copy group
//      each), then its live tiles of v, into 128-byte-swizzled tiles, zero
//      past S. A key tile is live unless it lies wholly at or past s_valid or,
//      causal, wholly above the diagonal (then it is neither loaded nor used).
//   2. s = q . k^T for each live key tile: 32 fp32 logits a thread a tile,
//      each tile's wgmma issued as its k lands; while the next tile's copy
//      and wgmma run, the last one's logits are scaled by D^-1/2 (after the
//      dot), masked (causal, s_valid, past S) to -inf and folded into the
//      exact row max.
//   3. e = exp(l - m) and the fp32 row sum from those registers (the
//      thread's values, then the quad's); normalize-first P = cast(e / sum),
//      deferred P = cast(e).
//   4. P repacked in registers as wgmma's A fragments, P . v into an fp32
//      accumulator (deferred: each key tile's P . v issued as soon as its P
//      is cast, under the next tile's exponentials); deferred, divided by
//      the row sum; one cast of the context.
// A warp computes only the logits its rows may see: none when its 16 rows
// all lie past S, no key tile past its last row (causal) or past n_keys, and
// only the first 32 keys of a tile that holds no more (the ragged last tile
// of S = 77); the rest are P = 0.
// ---------------------------------------------------------------------------

constexpr int kWgD = 64;        // the head width the bf16 core is built for
constexpr int kWgMaxSeq = 128;  // two key tiles; longer: csrc/mha.cu

// Shared memory: the q tile, k and v tiles; 1024 bytes of alignment slack.
size_t wgmma_core_smem_bytes(int tiles) {
  return hopper::kTileBytes * (1 + 2 * (size_t)tiles) + 1024;
}

// The logits of one key tile (its first kN of this thread's 32 values; kN =
// 16: the tile's first 32 keys) scaled after the dot, masked unless `full`,
// and folded into the running row max m. j0: the tile's first key plus this
// thread's first column.
template <int kN>
__device__ __forceinline__ void scale_mask_max(float (&s)[32], bool full, int j0, int n_keys,
                                               int causal, int row0, float scale,
                                               float (&m)[2]) {
#pragma unroll
  for (int v = 0; v < kN; ++v) {
    const int hh = (v >> 1) & 1, j = j0 + 8 * (v >> 2) + (v & 1);
    if (full) {
      s[v] *= scale;
    } else {
      const bool ok = j < n_keys && !(causal && j > row0 + 8 * hh);
      s[v] = ok ? s[v] * scale : -INFINITY;
    }
    m[hh] = fmaxf(m[hh], s[v]);
  }
}

// e = exp(l - m) of the first kN values (the rest 0) into s; adds them to rs.
template <int kN>
__device__ __forceinline__ void exp_sum(float (&s)[32], const float (&m)[2], float (&rs)[2]) {
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    if (v < kN) {
      s[v] = expf(s[v] - m[(v >> 1) & 1]);  // masked: exp(-inf) = 0
      rs[(v >> 1) & 1] += s[v];
    } else {
      s[v] = 0.f;
    }
  }
}

template <int kN>
__device__ __forceinline__ void normalize(float (&s)[32], const float (&rs)[2]) {
#pragma unroll
  for (int v = 0; v < kN; ++v) s[v] /= rs[(v >> 1) & 1];
}

// min blocks: what an SM holds at the registers the logits take
template <int kTiles>
__global__ void __launch_bounds__(hopper::kWarpgroup, kTiles == 1 ? 5 : 4)
attn_core_wgmma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int S,
                       int heads, int causal, int s_valid, int defer, float scale) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t s_q = smem_u32(sm);
  const uint32_t s_k = s_q + kTileBytes, s_v = s_k + kTiles * kTileBytes;
  const int W = heads * kWgD, W3 = 3 * W;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const bf16* base = qkv + (size_t)b * S * W3 + h * kWgD;
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + 64);
  const int n_tiles = (n_keys + 63) / 64;  // live key tiles, <= kTiles

  // one copy group a key tile (q with the first), then one of v
  load_tile_2d<kWarpgroup>(s_q, base, W3, q0, S, 0, kWgD);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    if (t < n_tiles)
      load_tile_2d<kWarpgroup>(s_k + t * kTileBytes, base + W, W3, 64 * t, S, 0, kWgD);
    cp_async_commit();  // empty for a dead tile: the group count stays uniform
  }
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    if (t < n_tiles)
      load_tile_2d<kWarpgroup>(s_v + t * kTileBytes, base + 2 * W, W3, 64 * t, S, 0, kWgD);
  cp_async_commit();

  // This thread's two rows (accumulator halves hh = 0, 1) and first column;
  // nk: the keys this warp's rows may see (the header's note).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c0 = 2 * (lane % 4);
  const int row0 = q0 + 16 * warp + lane / 4;
  const int nk = q0 + 16 * warp >= S ? 0 : causal ? min(n_keys, q0 + 16 * warp + 16) : n_keys;
  float mx[2] = {-INFINITY, -INFINITY};  // this thread's running row max
  auto fold = [&](float (&st)[32], int t) {
    if (64 * t >= nk) return;  // the warp's rows see no key of this tile
    const bool full = 64 * t + 64 <= nk && !(causal && 64 * t + 63 > q0);
    if (nk - 64 * t <= 32)
      scale_mask_max<16>(st, false, 64 * t + c0, n_keys, causal, row0, scale, mx);
    else
      scale_mask_max<32>(st, full, 64 * t + c0, n_keys, causal, row0, scale, mx);
  };
  // key tile t: its copy waited for, its logits issued, the last tile's folded
  float s[kTiles][32];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    cp_async_wait_n(kTiles - t);
    fence_proxy_async();
    __syncthreads();
    if (t < n_tiles) {
      wgmma_fence();
      issue_abt(s[t], s_q, s_k + t * kTileBytes);
    }
    wgmma_commit();  // empty for a dead tile: the batch count stays uniform
    if (t > 0) {
      wgmma_wait<1>();  // tile t - 1's logits
      fence_acc(s[t - 1]);
      fold(s[t - 1], t - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(s[kTiles - 1]);
  fold(s[kTiles - 1], kTiles - 1);
  float m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) m[hh] = quad_max(mx[hh]);
  // m is finite for a live warp: key 0 is never masked

  auto exp_tile = [&](float (&st)[32], int t, float (&rs)[2]) {
    if (64 * t >= nk) {
#pragma unroll
      for (int v = 0; v < 32; ++v) st[v] = 0.f;
    } else if (nk - 64 * t <= 32) {
      exp_sum<16>(st, m, rs);
    } else {
      exp_sum<32>(st, m, rs);
    }
  };
  auto sum_rows = [&](float (&rs)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rs[hh] = quad_sum(rs[hh]);
  };
  cp_async_wait<0>();  // v
  fence_proxy_async();
  __syncthreads();
  float o[32], rs[2] = {0.f, 0.f};
  uint32_t a[kTiles][4][4];
#pragma unroll
  for (int v = 0; v < 32; ++v) o[v] = 0.f;
  if (defer) {  // P = cast(e): each tile's P . v goes as soon as it is cast
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      exp_tile(s[t], t, rs);
      to_a_frags(s[t], a[t]);
      if (t < n_tiles) {
        wgmma_fence();
        issue_ab(o, a[t], s_v + t * kTileBytes);
      }
    }
    wgmma_commit();
    sum_rows(rs);
  } else {  // P = cast(e / sum): the sum first
#pragma unroll
    for (int t = 0; t < kTiles; ++t) exp_tile(s[t], t, rs);
    sum_rows(rs);
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (64 * t < nk) {
        if (nk - 64 * t <= 32) normalize<16>(s[t], rs);
        else normalize<32>(s[t], rs);
      }
      to_a_frags(s[t], a[t]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
      if (t < n_tiles) issue_ab(o, a[t], s_v + t * kTileBytes);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(o);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) fence_frags(a[t]);

  bf16* out = ctx + (size_t)b * S * W + h * kWgD;
#pragma unroll
  for (int v = 0; v < 32; v += 2) {
    const int hh = (v >> 1) & 1, i = row0 + 8 * hh, col = 8 * (v >> 2) + c0;
    if (i < S) {
      const float d = defer ? rs[hh] : 1.f;
      *reinterpret_cast<uint32_t*>(out + (size_t)i * W + col) =
          pack_bf16(o[v] / d, o[v + 1] / d);
    }
  }
}

template <int kTiles>
cudaError_t launch_core_wgmma_tiles(const void* qkv, void* ctx, int B, int S, int heads,
                                    int causal, int s_valid, int defer, cudaStream_t stream) {
  const int smem = (int)wgmma_core_smem_bytes(kTiles);
  cudaError_t err = cudaFuncSetAttribute(attn_core_wgmma_kernel<kTiles>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64, heads, B);
  attn_core_wgmma_kernel<kTiles><<<grid, hopper::kWarpgroup, smem, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx), S, heads, causal, s_valid,
          defer, (float)(1.0 / sqrt((double)kWgD)));
  return cudaGetLastError();
}

// S <= 128: one or two key tiles of 64.
cudaError_t launch_core_wgmma(const void* qkv, void* ctx, int B, int S, int heads, int causal,
                              int s_valid, int defer, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(ctx) % 4)
    return cudaErrorMisalignedAddress;
  if (S <= 64)
    return launch_core_wgmma_tiles<1>(qkv, ctx, B, S, heads, causal, s_valid, defer, stream);
  return launch_core_wgmma_tiles<2>(qkv, ctx, B, S, heads, causal, s_valid, defer, stream);
}

}  // namespace

extern "C" {

// The plan (ops/attention.py ln_layout, ln_rows_plan): vec, values, warps, blocks as
// launch_ln_rows takes them.
int plip_ln_rows(const void* x, const float* scale, const float* bias, void* out,
                 int rows, int width, int vec, int values, int warps, int blocks, float eps,
                 int dtype, int device, void* stream) {
  if (rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_ln_rows<float>(x, scale, bias, out, rows, width, vec, values, warps, blocks,
                                 eps, s);
  if (dtype == plip::kBF16)
    return launch_ln_rows<plip::bf16>(x, scale, bias, out, rows, width, vec, values, warps,
                                      blocks, eps, s);
  return cudaErrorInvalidValue;
}

// residual may be null (no residual add). tile: fp32's block tile
// (ops/attention.py simt_gemm_plan); bf16 ignores it.
int plip_gemm_bias_residual(const void* a, const void* w, const float* bias,
                            const void* residual, void* out, int M, int N, int K, int tile,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = plip::aligned16({a, w, bias, residual, out});
  if (dtype == plip::kF32)
    return plip::launch_gemm<float, false>(
        a, w, M, N, K, tile, aligned,
        BiasResidual<float>{bias, static_cast<const float*>(residual),
                            static_cast<float*>(out), N},
        s);
  if (dtype == plip::kBF16)
    return plip::launch_gemm<plip::bf16, false>(
        a, w, M, N, K, tile, aligned,
        BiasResidual<plip::bf16>{bias, static_cast<const plip::bf16*>(residual),
                                 static_cast<plip::bf16*>(out), N},
        s);
  return cudaErrorInvalidValue;
}

// gemm_bias_residual's fp32 partial mode: out [M, N] fp32 = a . w, a and w in
// the compute dtype (the GEMM of gemm_bias_residual, its epilogue Partial).
int plip_gemm_partial(const void* a, const void* w, float* out, int M, int N, int K,
                      int tile, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = plip::aligned16({a, w, out});
  if (dtype == plip::kF32)
    return plip::launch_gemm<float, false>(a, w, M, N, K, tile, aligned, Partial{out, N}, s);
  if (dtype == plip::kBF16)
    return plip::launch_gemm<plip::bf16, false>(a, w, M, N, K, tile, aligned,
                                                Partial{out, N}, s);
  return cudaErrorInvalidValue;
}

// defer: the softmax divide deferred past P . v (K1's forward above 128
// tokens) or normalize-first, in either dtype. bf16 at head_dim 64 and S <=
// 128 runs the wgmma kernel (qkv 16-byte and ctx 4-byte aligned); fp32, and
// bf16 at another head_dim, the CUDA-core kernel (S <= 256, head_dim a
// multiple of 4 up to 128, qkv and ctx 16-byte aligned).
int plip_attn_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                   int causal, int s_valid, int defer, int dtype, int device, void* stream) {
  if (B <= 0 || heads <= 0 || S <= 0 || S > kMaxSeq || head_dim <= 0 ||
      head_dim > 128 || s_valid < 1 || s_valid > S || B > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_core_simt<float>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, defer, s);
  if (dtype == plip::kBF16) {
    if (head_dim == kWgD && S <= kWgMaxSeq)
      return launch_core_wgmma(qkv, ctx, B, S, heads, causal, s_valid, defer, s);
    return launch_core_simt<plip::bf16>(qkv, ctx, B, S, heads, head_dim, causal, s_valid,
                                        defer, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
