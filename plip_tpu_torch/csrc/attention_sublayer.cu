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
//                       the GEMM of gemm.cuh (bf16: wgmma on 128 x 128
//                       tiles, two blocks an SM; fp32: CUDA-core tiles,
//                       64x64x16, so fp32 stays full fp32, no TF32).
//   attn_core           bf16: S <= 128, the head on chip, one q . k^T on
//                       wgmma (below); longer, csrc/mha.cu's key-tiled
//                       kernel. fp32 (a check, not a mode): S <= 256, one
//                       block per (sequence, head), k and v in shared memory
//                       as fp32, one warp per query row, CUDA cores. Both
//                       (and the key-tiled kernel): logits scaled after
//                       the dot, causal and column >= s_valid masks, fp32
//                       softmax against the exact row max, P cast to the
//                       compute dtype before P . v (fp32 sum). Up to S = 128
//                       the softmax normalizes first; above it the divide is
//                       deferred past P . v (the TPU kernel's _pipe_fwd);
//                       bf16 takes either schedule (the normalize-first
//                       context K7 recomputes at any S).
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
// 50-128), under the card's 295. Its first design ran both dots as scalar
// fmaf loops on CUDA cores with the head's k and v in shared memory as fp32
// (about 101 KB at S = 197, two blocks an SM): 64x its bytes bound at
// ViT-B/16.
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

#include "common.cuh"
#include "gemm.cuh"
#include "wgmma.cuh"

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

// defer: the softmax divide deferred past P . v (K1's forward above 128
// tokens) or normalize-first. fp32 takes K1's own schedule only (defer ==
// S > 128) and head_dim <= 128; bf16 either schedule at S <= 128 and
// head_dim 64, with qkv 16-byte and ctx 4-byte aligned.
int plip_attn_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                   int causal, int s_valid, int defer, int dtype, int device, void* stream) {
  if (B <= 0 || heads <= 0 || S <= 0 || S > kMaxSeq || head_dim <= 0 ||
      head_dim > 128 || s_valid < 1 || s_valid > S)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32) {
    if ((defer != 0) != (S > kNormalizeSeq)) return cudaErrorInvalidValue;
    return launch_core<float>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, s);
  }
  if (dtype == plip::kBF16) {
    if (S > kWgMaxSeq || head_dim != kWgD || B > 65535 || heads > 65535)
      return cudaErrorInvalidValue;
    return launch_core_wgmma(qkv, ctx, B, S, heads, causal, s_valid, defer, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
