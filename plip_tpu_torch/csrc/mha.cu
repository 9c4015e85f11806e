// Attention core of the composed towers, by hand for Hopper (sm_90a):
//
//   ctx[b, i, head] = softmax_j(q_i . k_j, masked) . v_j,
//   q scaled by D^-1/2 and cast to the compute dtype BEFORE the dot
//
// on the fused activations qkv [B, S, 3W] (columns [q heads | k heads | v
// heads], each head's D columns contiguous) -> ctx [B, S, W]. Four entry
// points, one kernel:
//
//   plip_mha_core    replaces plip_tpu/ops/attention.py:36 _mha_kernel
//                    (wrapper _pallas_mha, :96), S <= 512: causal and
//                    column >= s_valid masks; normalize-first softmax at
//                    S <= 128, the divide deferred past P . v above it.
//   plip_flash_core  replaces plip_tpu/ops/attention.py:243 _flash_kernel
//                    (wrapper _pallas_flash_mha, :403), the TPU's q-blocked
//                    kernel for S > 512, at its shipped pipeline=True:
//                    deferred divide, causal order by global row, no s_valid.
//   plip_attn_core_tiled  K1's core (plip_tpu/ops/attention.py:644
//                    _attn_sublayer_kernel) past the 256 tokens of its own
//                    kernel in csrc/attention_sublayer.cu: the deferred
//                    divide with K1's scale placement, q unscaled and the
//                    fp32 logits scaled AFTER the dot (kScaleAfter), masks.
//                    With defer = 0, normalize-first at any S: the context
//                    that K7 (plip_tpu/ops/block_bwd.py:116-131) recomputes.
//   plip_headgrid_core  replaces plip_tpu/ops/attention.py:324 _headgrid_kernel
//                    (wrapper _pallas_mha_headgrid, :362): K3's scale
//                    placement, normalize-first at every S, no s_valid. It is
//                    also the forward of the JAX package's _jnp_mha (:444),
//                    which its composed paths take above 512 tokens with pad
//                    columns. The TPU's head groups (hpp) were there for its
//                    128 lanes; here every head is its own block.
//
// The TPU kernels hold a whole sequence's k and v in VMEM (tens of MB). Here
// a block holds one (sequence, head, 64-row q tile) and streams k and v
// through shared memory in 64-key tiles, so its shared memory does not grow
// with S (fp32 k and v at S = 577, D = 64 alone would take 295 KB of the
// 227 KB a block may use). The exact softmax over the full row is kept
// with passes over the key tiles, which recompute q . k^T:
//
//   pass 0  the fp32 row max m;
//   pass 1  (normalize-first only) the fp32 row sum of p = exp(l - m);
//   pass 2  p = exp(l - m), cast to the compute dtype (after / sum when
//           normalize-first), summed into the fp32 P . v accumulator; in the
//           deferred form the fp32 row sum is taken here and divides the
//           accumulator at the end. One cast to the compute dtype.
//
// So P is rounded exactly where the TPU kernels round it, and kernel and
// plain version agree to about one ulp. An online-softmax rescale (one pass)
// would round P against a running max and change the function.
//
// What bounds it on the card. At S = 577 the core is 4*S^2*D FLOPs a
// (sequence, head) against 8*S*D bytes of qkv: compute-bound in principle.
// bf16 runs both dots on tensor cores (WMMA 16x16x16, fp32 accumulators; each
// warp owns 16 query rows); fp32 runs them on CUDA cores (8x4 and 8x(D/16)
// outputs a thread) so fp32 stays full fp32. What remains slow in this simple
// design: q . k^T is computed twice (three times when normalize-first), tiles
// are loaded with scalar loads and no cp.async/TMA pipeline, and the softmax
// of a tile runs row by row with warp shuffles between the dots.
//
// Entry points launch on the stream they are given, allocate nothing, and
// return cudaGetLastError() (or cudaErrorInvalidValue for arguments they do
// not take) so the caller can raise.

#include <mma.h>

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace plip;

constexpr int kQT = 64;                       // query rows a block
constexpr int kKT = 64;                       // keys a tile
constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarpRows = kQT / (kThreads / 32);  // 16: warp w owns rows 16w..16w+15

// Row strides. fp32 tiles: D + 1, so that 16 threads reading one column of
// 16 rows hit 16 banks. bf16 tiles: D + 8, rows of whole 16-byte chunks as
// WMMA's loads want them.
template <typename T, int kD>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kLdT = kD + (kBf16 ? 8 : 1);            // Qs, Ks, Vs
  static constexpr int kLdL = (kKT > kD ? kKT : kD) + 4;       // Ls (fp32)
  static constexpr int kLdP = kKT + 8;                         // Ps (bf16)
  // Each region is a multiple of 128 bytes (64 rows of 2- or 4-byte values),
  // so every WMMA tile pointer below is 32-byte aligned.
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * kQT * kLdT;
  static constexpr size_t kV = kK + sizeof(T) * kKT * kLdT;
  static constexpr size_t kL = kV + sizeof(T) * kKT * kLdT;
  static constexpr size_t kP = kL + sizeof(float) * kQT * kLdL;
  static constexpr size_t kM = kP + (kBf16 ? sizeof(bf16) * kQT * kLdP : 0);
  static constexpr size_t kS = kM + sizeof(float) * kQT;
  static constexpr size_t kBytes = kS + sizeof(float) * kQT;
};

// The two dots of a tile and the P . v accumulator, per dtype. Both
// mappings give warp w the rows 16w..16w+15 of Ls and of the accumulator,
// so the softmax of a tile needs no block-wide barrier.
template <typename T, int kD>
struct Dots;

// fp32 on CUDA cores. Thread t: ty = t / 16 owns rows 8ty..8ty+7, tx = t % 16
// the columns tx + 16c.
template <int kD>
struct Dots<float, kD> {
  using L = Layout<float, kD>;
  float acc[8][kD / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) acc[i][c] = 0.f;
  }

  // Ls[r][c] = Qs[r] . Ks[c] over the 64 x 64 tile.
  __device__ void qk(const float* Qs, const float* Ks, float* Ls) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float a[8][4] = {};
    for (int d = 0; d < kD; ++d) {
      float q[8], k[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = Qs[(ty * 8 + i) * L::kLdT + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) k[c] = Ks[(tx + 16 * c) * L::kLdT + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[i][c] = fmaf(q[i], k[c], a[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ls[(ty * 8 + i) * L::kLdL + tx + 16 * c] = a[i][c];
  }

  // acc += P . Vs, P in Ls (rounded to fp32 already).
  __device__ void pv(const float* Ls, const void*, const float* Vs) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int j = 0; j < kKT; ++j) {
      float p[8], v[kD / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = Ls[(ty * 8 + i) * L::kLdL + j];
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) v[c] = Vs[j * L::kLdT + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kD / 16; ++c) acc[i][c] = fmaf(p[i], v[c], acc[i][c]);
    }
  }

  // The accumulator into Ls[r][0..D).
  __device__ void store(float* Ls) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c)
        Ls[(ty * 8 + i) * L::kLdL + tx + 16 * c] = acc[i][c];
  }
};

// bf16 on tensor cores: warp w computes the 16 x 64 logits strip of its rows
// and a 16 x D strip of the accumulator.
template <int kD>
struct Dots<bf16, kD> {
  using L = Layout<bf16, kD>;
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  Acc acc[kD / 16];

  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) nvcuda::wmma::fill_fragment(acc[c], 0.f);
  }

  __device__ void qk(const bf16* Qs, const bf16* Ks, float* Ls) const {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * kWarpRows;
    Acc s[kKT / 16];
#pragma unroll
    for (int c = 0; c < kKT / 16; ++c) wmma::fill_fragment(s[c], 0.f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + r0 * L::kLdT + kk, L::kLdT);
#pragma unroll
      for (int c = 0; c < kKT / 16; ++c) {
        // k^T: element (d, key) of the tile is Ks[key][d], a column-major B.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + c * 16 * L::kLdT + kk, L::kLdT);
        wmma::mma_sync(s[c], a, b, s[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kKT / 16; ++c)
      wmma::store_matrix_sync(Ls + r0 * L::kLdL + c * 16, s[c], L::kLdL,
                              wmma::mem_row_major);
  }

  // acc += Ps . Vs.
  __device__ void pv(const float*, const bf16* Ps, const bf16* Vs) {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * kWarpRows;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + r0 * L::kLdP + kk, L::kLdP);
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Vs + kk * L::kLdT + c * 16, L::kLdT);
        wmma::mma_sync(acc[c], a, b, acc[c]);
      }
    }
  }

  __device__ void store(float* Ls) const {
    const int r0 = (threadIdx.x / 32) * kWarpRows;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c)
      nvcuda::wmma::store_matrix_sync(Ls + r0 * L::kLdL + c * 16, acc[c], L::kLdL,
                                      nvcuda::wmma::mem_row_major);
  }
};

// Rows j0.. of one head's D columns (src points at row 0, column h*D of the
// q, k or v block) into a 64-row tile; rows at or past S are zero.
template <typename T, int kD>
__device__ void load_tile(T* dst, const T* src, int W3, int j0, int S) {
  for (int e = threadIdx.x; e < kKT * kD; e += kThreads) {
    const int r = e / kD, d = e % kD, j = j0 + r;
    dst[r * Layout<T, kD>::kLdT + d] = j < S ? src[(size_t)j * W3 + d] : from_f<T>(0.f);
  }
}

// One block: query rows q0..q0+63 of (sequence b, head h). grid = (q tiles,
// heads, B). Keys at or past n_keys (s_valid, and for causal the tile's last
// row) are never loaded; masked keys get p = 0. kScaleAfter: K1's placement
// of D^-1/2 (on the fp32 logits) instead of K3's and K5's (on q, cast).
template <typename T, int kD, bool kScaleAfter>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int S, int heads, int causal,
           int s_valid, int defer, float scale) {
  using L = Layout<T, kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::kQ);
  T* Ks = reinterpret_cast<T*>(smem + L::kK);
  T* Vs = reinterpret_cast<T*>(smem + L::kV);
  float* Ls = reinterpret_cast<float*>(smem + L::kL);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::kP);
  float* row_max = reinterpret_cast<float*>(smem + L::kM);
  float* row_sum = reinterpret_cast<float*>(smem + L::kS);

  const int W = heads * kD, W3 = 3 * W;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3 + h * kD;

  // q * D^-1/2 rounded to T, as K3 and K5 scale it before the dot; K1's q
  // goes in as it is.
  const float q_scale = kScaleAfter ? 1.f : scale;
  for (int e = threadIdx.x; e < kQT * kD; e += kThreads) {
    const int r = e / kD, d = e % kD, i = q0 + r;
    const float v = i < S ? to_f(base[(size_t)i * W3 + d]) * q_scale : 0.f;
    Qs[r * L::kLdT + d] = from_f<T>(v);
  }
  if (lane < kWarpRows) {
    row_max[warp * kWarpRows + lane] = -INFINITY;
    row_sum[warp * kWarpRows + lane] = 0.f;
  }
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kQT);
  const int n_tiles = (n_keys + kKT - 1) / kKT;

  Dots<T, kD> dots;
  dots.zero();
  for (int pass = 0; pass < 3; ++pass) {
    if (pass == 1 && defer) continue;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kKT;
      __syncthreads();  // every warp is done with the previous tile
      load_tile<T, kD>(Ks, base + W, W3, j0, S);
      if (pass == 2) load_tile<T, kD>(Vs, base + 2 * W, W3, j0, S);
      __syncthreads();
      dots.qk(Qs, Ks, Ls);
      __syncwarp();
      for (int rr = 0; rr < kWarpRows; ++rr) {
        const int r = warp * kWarpRows + rr, i = q0 + r;
        float l[2];
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u, j = j0 + c;
          ok[u] = j < n_keys && !(causal && j > i);
          l[u] = kScaleAfter ? Ls[r * L::kLdL + c] * scale : Ls[r * L::kLdL + c];
        }
        if (pass == 0) {
          float m = fmaxf(ok[0] ? l[0] : -INFINITY, ok[1] ? l[1] : -INFINITY);
          m = warp_max(m);
          if (lane == 0) row_max[r] = fmaxf(row_max[r], m);
          continue;
        }
        const float m = row_max[r];  // finite: key 0 is never masked
        float p[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) p[u] = ok[u] ? expf(l[u] - m) : 0.f;
        if (pass == 1 || defer) {
          const float s = warp_sum(p[0] + p[1]);
          if (lane == 0) row_sum[r] += s;
          if (pass == 1) continue;
        } else {
          p[0] /= row_sum[r];
          p[1] /= row_sum[r];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          if constexpr (L::kBf16)
            Ps[r * L::kLdP + c] = from_f<bf16>(p[u]);
          else
            Ls[r * L::kLdL + c] = p[u];
        }
      }
      __syncwarp();
      if (pass == 2) dots.pv(Ls, Ps, Vs);
    }
  }

  __syncwarp();
  dots.store(Ls);
  __syncwarp();
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr, i = q0 + r;
    if (i >= S) break;
    const float s = row_sum[r];
    for (int d = lane; d < kD; d += 32) {
      const float a = Ls[r * L::kLdL + d];
      ctx[((size_t)b * S + i) * W + h * kD + d] = from_f<T>(defer ? a / s : a);
    }
  }
}

template <typename T, int kD, bool kScaleAfter>
cudaError_t launch(const void* qkv, void* ctx, int B, int S, int heads, int causal,
                   int s_valid, int defer, cudaStream_t stream) {
  const size_t smem = Layout<T, kD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T, kD, kScaleAfter>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQT - 1) / kQT, heads, B);
  const float scale = (float)(1.0 / sqrt((double)kD));
  mha_kernel<T, kD, kScaleAfter><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(ctx), S, heads, causal, s_valid, defer,
      scale);
  return cudaGetLastError();
}

// Every tower of the config (vision and text) has head_dim 64; the kernel is
// built for that width only.
constexpr int kHeadDim = 64;

template <bool kScaleAfter>
int run(const void* qkv, void* ctx, int B, int S, int heads, int head_dim, int causal,
        int s_valid, int defer, int dtype, int device, void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || heads > 65535 || S <= 0 || s_valid < 1 ||
      s_valid > S || head_dim != kHeadDim)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float, kHeadDim, kScaleAfter>(qkv, ctx, B, S, heads, causal, s_valid,
                                                defer, s);
  if (dtype == kBF16)
    return launch<bf16, kHeadDim, kScaleAfter>(qkv, ctx, B, S, heads, causal, s_valid,
                                               defer, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K3: S <= 512; normalize-first at S <= 128, deferred divide above.
int plip_mha_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                  int causal, int s_valid, int dtype, int device, void* stream) {
  if (S > 512) return cudaErrorInvalidValue;
  return run<false>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, S > 128, dtype,
                    device, stream);
}

// K5: any S, deferred divide, no pad columns.
int plip_flash_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                    int causal, int dtype, int device, void* stream) {
  return run<false>(qkv, ctx, B, S, heads, head_dim, causal, S, 1, dtype, device, stream);
}

// K12: any S, normalize-first, no pad columns.
int plip_headgrid_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                       int causal, int dtype, int device, void* stream) {
  return run<false>(qkv, ctx, B, S, heads, head_dim, causal, S, 0, dtype, device, stream);
}

// K1's core at any S: logits scaled after the dot, masks; the divide
// deferred (defer = 1, K1's forward) or normalize-first (0, K7's recompute).
int plip_attn_core_tiled(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                         int causal, int s_valid, int defer, int dtype, int device,
                         void* stream) {
  return run<true>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, defer ? 1 : 0, dtype,
                   device, stream);
}

}  // extern "C"
