// Backward of the attention core, key-tiled, by hand for Hopper (sm_90a):
// from qkv [B*S, 3W] (columns [q heads | k heads | v heads], each head's D
// columns contiguous) and g = dL/dctx [B*S, W], with P recomputed,
//
//   logits = (q . k^T in fp32) * D^-1/2, causal and column >= s_valid masks,
//   dv = P_c^T . g,  dp = g . v^T,  dS = P o (dp - rowsum(dp o P)),
//   dq = dS . k * D^-1/2,  dk = dS^T . q * D^-1/2
//
// in one of two rounding schedules (the template parameter kSched):
//
//   kNormalizeFirst  replaces plip_tpu/ops/attention.py:125 _mha_bwd_kernel
//                    (K4, wrapper _pallas_mha_bwd, :186): P = e / rowsum(e)
//                    in fp32 with e = exp(logits - rowmax), P_c = cast(P),
//                    dsum = rowsum(dp o P) of the fp32 P, dS = cast(P o (dp -
//                    dsum)); q unscaled, the logits scaled after the dot.
//   kDeferred        the core of plip_tpu/ops/attention.py:1024
//                    _attn_sublayer_bwd_kernel (K2) past S = 128, its
//                    _core_fwd_bwd_block (:887) in the pipelined schedule:
//                    e = exp(l - m), denom = rowsum(e), e_c = cast(e);
//                    ctx = (e_c . v) / denom (also emitted); ghn = cast(g /
//                    denom), dv = e_c^T . ghn; dsum_u = rowsum(dp o e),
//                    dS_u = cast(e o (dp - dsum_u / denom)); dq = (dS_u . k *
//                    scale) / denom; dk = dS_u^T . cast(q / denom) * scale.
//
// Every product sums in fp32 and is cast once, where the TPU kernels cast.
//
// The TPU kernels hold a whole head's [S, S] P and dS in VMEM. Here nothing
// grows with S: two kernels, no atomics (a run is bit-reproducible), each
// block streaming 64-row tiles through shared memory:
//
//   core_bwd_rows  one block per (sequence, head, 64-row q tile). Passes over
//                  the key tiles: the fp32 row max m; the row sum of e (and,
//                  deferred, dsum_u); normalize-first, dsum of the fp32 P;
//                  then dS, summed into dq (and, deferred, e_c into ctx).
//                  Writes dq, ctx and the per-row fp32 m, rowsum and dsum.
//   core_bwd_keys  one block per (sequence, head, 64-key tile). Loops over
//                  the q tiles that see its keys, recomputes P and dS from
//                  the row statistics, sums dv and dk in fp32.
//
// Both recompute q . k^T and g . v^T with the same code on the same tiles, so
// the P and dS of the two kernels are bit-identical.
//
// What bounds it on the card. At L/14 (S = 257, D = 64) the backward is 10
// S^2 D FLOPs a (sequence, head) against 14 S D bytes of qkv, g and dqkv in
// bf16: compute-bound in principle. bf16 runs the dots on tensor cores (WMMA
// 16x16x16, fp32 accumulators, warp w owning rows 16w..16w+15 of a tile);
// fp32 on CUDA cores (8x4 and 8x(D/16) outputs a thread) so fp32 stays full
// fp32. What remains slow in this simple design: q . k^T is computed four
// times (three deferred) in core_bwd_rows and again in core_bwd_keys, g . v^T
// twice and again, tiles are loaded with scalar loads and no cp.async/TMA
// pipeline, and the softmax runs row by row with warp shuffles between dots.
//
// Entry points launch on the stream they are given, allocate nothing (the
// caller passes the fp32 statistics scratch [3, B, heads, S]), and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments they do not
// take) so the caller can raise.

#include <mma.h>

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace plip;

constexpr int kT = 64;          // q rows or keys a tile
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarpRows = kT / (kThreads / 32);  // 16: warp w owns rows 16w..16w+15
constexpr int kNormalizeFirst = 0, kDeferred = 1;

// Row strides. [64][D] tiles of q, g, k, v: fp32 D + 1 (16 threads reading
// one column of 16 rows hit 16 banks), bf16 D + 8 (rows of whole 16-byte
// chunks, as WMMA wants). fp32 [64][64] logits and dp: 64 + 4. Compute-dtype
// [64][64] P and dS: bf16 64 + 8, fp32 64 + 4.
template <typename T, int kD>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kLdT = kD + (kBf16 ? 8 : 1);
  static constexpr int kLdL = kT + 4;
  static constexpr int kLdP = kT + (kBf16 ? 8 : 4);
  // Each region is a multiple of 128 bytes, so every WMMA tile pointer below
  // is 32-byte aligned.
  static constexpr size_t kTile = sizeof(T) * kT * kLdT;
  static constexpr size_t kQ = 0;
  static constexpr size_t kG = kQ + kTile;
  static constexpr size_t kK = kG + kTile;
  static constexpr size_t kV = kK + kTile;
  static constexpr size_t kL = kV + kTile;
  static constexpr size_t kDP = kL + sizeof(float) * kT * kLdL;
  static constexpr size_t kP = kDP + sizeof(float) * kT * kLdL;
  static constexpr size_t kDS = kP + sizeof(T) * kT * kLdP;
  static constexpr size_t kStat = kDS + sizeof(T) * kT * kLdP;  // m, rowsum, dsum [64]
  static constexpr size_t kBytes = kStat + sizeof(float) * 3 * kT;
};

// The tile products, per dtype. Every mapping gives warp w the rows
// 16w..16w+15 of its output and reads only those rows of the first operand
// of abt, so the softmax of a tile needs no block-wide barrier.
template <typename T, int kD>
struct Mma;

// fp32 on CUDA cores. Thread t: ty = t / 16 owns rows 8ty..8ty+7, tx = t % 16
// the columns tx + 16c.
template <int kD>
struct Mma<float, kD> {
  using L = Layout<float, kD>;
  float acc[8][kD / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) acc[i][c] = 0.f;
  }

  // out[r][c] = A[r] . B[c] over the D columns: [64][ldT] x [64][ldT] -> fp32 [64][ldL].
  __device__ static void abt(const float* A, const float* B, float* out) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float a[8][4] = {};
    for (int d = 0; d < kD; ++d) {
      float x[8], y[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = A[(ty * 8 + i) * L::kLdT + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = B[(tx + 16 * c) * L::kLdT + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[i][c] = fmaf(x[i], y[c], a[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[(ty * 8 + i) * L::kLdL + tx + 16 * c] = a[i][c];
  }

  // acc += A . B: A [64][ldP] (rows, 64 k), B [64][ldT] (64 k, D).
  __device__ void ab(const float* A, const float* B) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < kT; ++k) {
      float x[8], y[kD / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = A[(ty * 8 + i) * L::kLdP + k];
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) y[c] = B[k * L::kLdT + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kD / 16; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
    }
  }

  // acc += A^T . B: A [64][ldP] (64 k, rows), B [64][ldT] (64 k, D).
  __device__ void atb(const float* A, const float* B) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < kT; ++k) {
      float x[8], y[kD / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = A[k * L::kLdP + ty * 8 + i];
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) y[c] = B[k * L::kLdT + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kD / 16; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
    }
  }

  // The accumulator into out[r][0..D) (fp32, ldL).
  __device__ void store(float* out) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) out[(ty * 8 + i) * L::kLdL + tx + 16 * c] = acc[i][c];
  }
};

// bf16 on tensor cores: warp w computes 16-row strips.
template <int kD>
struct Mma<bf16, kD> {
  using L = Layout<bf16, kD>;
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  using RowA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                      nvcuda::wmma::row_major>;
  using ColA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                      nvcuda::wmma::col_major>;
  using RowB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                      nvcuda::wmma::row_major>;
  using ColB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                      nvcuda::wmma::col_major>;
  Acc acc[kD / 16];

  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) nvcuda::wmma::fill_fragment(acc[c], 0.f);
  }

  __device__ static void abt(const bf16* A, const bf16* B, float* out) {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * kWarpRows;
    Acc s[kT / 16];
#pragma unroll
    for (int c = 0; c < kT / 16; ++c) wmma::fill_fragment(s[c], 0.f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      RowA a;
      wmma::load_matrix_sync(a, A + r0 * L::kLdT + kk, L::kLdT);
#pragma unroll
      for (int c = 0; c < kT / 16; ++c) {
        // B^T: element (d, c) of the product's right operand is B[c][d], column-major
        ColB b;
        wmma::load_matrix_sync(b, B + c * 16 * L::kLdT + kk, L::kLdT);
        wmma::mma_sync(s[c], a, b, s[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kT / 16; ++c)
      wmma::store_matrix_sync(out + r0 * L::kLdL + c * 16, s[c], L::kLdL,
                              wmma::mem_row_major);
  }

  __device__ void ab(const bf16* A, const bf16* B) {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * kWarpRows;
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      RowA a;
      wmma::load_matrix_sync(a, A + r0 * L::kLdP + kk, L::kLdP);
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        RowB b;
        wmma::load_matrix_sync(b, B + kk * L::kLdT + c * 16, L::kLdT);
        wmma::mma_sync(acc[c], a, b, acc[c]);
      }
    }
  }

  __device__ void atb(const bf16* A, const bf16* B) {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * kWarpRows;
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      // A^T: element (r, k) of the left operand is A[k][r], column-major
      ColA a;
      wmma::load_matrix_sync(a, A + kk * L::kLdP + r0, L::kLdP);
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) {
        RowB b;
        wmma::load_matrix_sync(b, B + kk * L::kLdT + c * 16, L::kLdT);
        wmma::mma_sync(acc[c], a, b, acc[c]);
      }
    }
  }

  __device__ void store(float* out) const {
    const int r0 = (threadIdx.x / 32) * kWarpRows;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c)
      nvcuda::wmma::store_matrix_sync(out + r0 * L::kLdL + c * 16, acc[c], L::kLdL,
                                      nvcuda::wmma::mem_row_major);
  }
};

// Rows r0.. of one head's D columns (src points at row 0 of that head's
// columns, ld elements a row) into a [64][ldT] tile; rows at or past S are zero.
template <typename T, int kD>
__device__ void load_tile(T* dst, const T* src, int ld, int r0, int S) {
  for (int e = threadIdx.x; e < kT * kD; e += kThreads) {
    const int r = e / kD, d = e % kD, i = r0 + r;
    dst[r * Layout<T, kD>::kLdT + d] = i < S ? src[(size_t)i * ld + d] : from_f<T>(0.f);
  }
}

// The shared memory of a block: the same regions for both kernels.
template <typename T, int kD>
struct Smem {
  using L = Layout<T, kD>;
  T *Q, *G, *K, *V, *P, *DS;
  float *Lg, *DP, *m, *rs, *ds;

  __device__ explicit Smem(unsigned char* s)
      : Q(reinterpret_cast<T*>(s + L::kQ)), G(reinterpret_cast<T*>(s + L::kG)),
        K(reinterpret_cast<T*>(s + L::kK)), V(reinterpret_cast<T*>(s + L::kV)),
        P(reinterpret_cast<T*>(s + L::kP)), DS(reinterpret_cast<T*>(s + L::kDS)),
        Lg(reinterpret_cast<float*>(s + L::kL)), DP(reinterpret_cast<float*>(s + L::kDP)),
        m(reinterpret_cast<float*>(s + L::kStat)), rs(m + kT), ds(m + 2 * kT) {}
};

// core_bwd_rows: query rows q0..q0+63 of (sequence b, head h); grid = (q
// tiles, heads, B). Keys at or past n_keys (s_valid, and for causal the
// tile's last row) are never loaded; masked keys get e = 0.
template <typename T, int kD, int kSched>
__global__ void __launch_bounds__(kThreads)
core_bwd_rows(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ ctx,
              T* __restrict__ dqkv, float* __restrict__ stats, int S, int heads, int causal,
              int s_valid, float scale) {
  using L = Layout<T, kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, kD> sm(smem);
  const int W = heads * kD, W3 = 3 * W;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3 + h * kD;

  load_tile<T, kD>(sm.Q, base, W3, q0, S);
  load_tile<T, kD>(sm.G, g + (size_t)b * S * W + h * kD, W, q0, S);
  if (lane < kWarpRows) {
    const int r = warp * kWarpRows + lane;
    sm.m[r] = -INFINITY;
    sm.rs[r] = 0.f;
    sm.ds[r] = 0.f;
  }
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kT);
  const int n_tiles = (n_keys + kT - 1) / kT;

  // pass 0: the row max; normalize-first: 1 the row sum, 2 dsum, 3 dS and
  // dq; deferred: 1 the row sum and dsum_u, 2 dS_u, dq and ctx.
  constexpr int kPasses = kSched == kDeferred ? 3 : 4;
  Mma<T, kD> dq, cx;
  dq.zero();
  cx.zero();
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool with_dp = pass >= kPasses - 2, last = pass == kPasses - 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kT;
      __syncthreads();  // every warp is done with the previous tile
      load_tile<T, kD>(sm.K, base + W, W3, j0, S);
      if (with_dp) load_tile<T, kD>(sm.V, base + 2 * W, W3, j0, S);
      __syncthreads();
      Mma<T, kD>::abt(sm.Q, sm.K, sm.Lg);
      if (with_dp) Mma<T, kD>::abt(sm.G, sm.V, sm.DP);
      __syncwarp();
      for (int rr = 0; rr < kWarpRows; ++rr) {
        const int r = warp * kWarpRows + rr, i = q0 + r;
        float l[2], e[2], dp[2];
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u, j = j0 + c;
          ok[u] = j < n_keys && !(causal && j > i);
          l[u] = sm.Lg[r * L::kLdL + c] * scale;
        }
        if (pass == 0) {
          float mx = fmaxf(ok[0] ? l[0] : -INFINITY, ok[1] ? l[1] : -INFINITY);
          mx = warp_max(mx);
          if (lane == 0) sm.m[r] = fmaxf(sm.m[r], mx);
          continue;
        }
        const float m = sm.m[r];  // finite: key 0 is never masked
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          e[u] = ok[u] ? expf(l[u] - m) : 0.f;
          dp[u] = with_dp ? sm.DP[r * L::kLdL + lane + 32 * u] : 0.f;
        }
        if (pass == 1) {
          const float s = warp_sum(e[0] + e[1]);
          const float d = kSched == kDeferred ? warp_sum(dp[0] * e[0] + dp[1] * e[1]) : 0.f;
          if (lane == 0) {
            sm.rs[r] += s;
            sm.ds[r] += d;
          }
          continue;
        }
        float w[2], sub;  // dS = w o (dp - sub)
        if (kSched == kNormalizeFirst) {
          w[0] = e[0] / sm.rs[r];  // the fp32 P
          w[1] = e[1] / sm.rs[r];
          if (pass == 2) {
            const float d = warp_sum(dp[0] * w[0] + dp[1] * w[1]);
            if (lane == 0) sm.ds[r] += d;
            continue;
          }
          sub = sm.ds[r];
        } else {
          w[0] = e[0];
          w[1] = e[1];
          sub = sm.ds[r] / sm.rs[r];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          sm.DS[r * L::kLdP + c] = from_f<T>(w[u] * (dp[u] - sub));
          if (kSched == kDeferred) sm.P[r * L::kLdP + c] = from_f<T>(e[u]);
        }
      }
      __syncwarp();
      if (last) {
        dq.ab(sm.DS, sm.K);
        if (kSched == kDeferred) cx.ab(sm.P, sm.V);
      }
    }
  }

  __syncwarp();
  dq.store(sm.Lg);
  __syncwarp();
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr, i = q0 + r;
    if (i >= S) break;
    for (int d = lane; d < kD; d += 32) {
      float v = sm.Lg[r * L::kLdL + d] * scale;
      if (kSched == kDeferred) v /= sm.rs[r];
      dqkv[((size_t)b * S + i) * W3 + h * kD + d] = from_f<T>(v);
    }
  }
  if (kSched == kDeferred) {
    __syncwarp();
    cx.store(sm.Lg);
    __syncwarp();
    for (int rr = 0; rr < kWarpRows; ++rr) {
      const int r = warp * kWarpRows + rr, i = q0 + r;
      if (i >= S) break;
      for (int d = lane; d < kD; d += 32)
        ctx[((size_t)b * S + i) * W + h * kD + d] =
            from_f<T>(sm.Lg[r * L::kLdL + d] / sm.rs[r]);
    }
  }
  if (lane < kWarpRows) {
    const int r = warp * kWarpRows + lane, i = q0 + r;
    const size_t bhs = (size_t)gridDim.z * heads * S, o = ((size_t)b * heads + h) * S + i;
    if (i < S) {
      stats[o] = sm.m[r];
      stats[bhs + o] = sm.rs[r];
      stats[2 * bhs + o] = sm.ds[r];
    }
  }
}

// core_bwd_keys: keys k0..k0+63 of (sequence b, head h); grid = (key tiles,
// heads, B). The q tiles before the key tile see none of its keys when
// causal; a tile of keys at or past s_valid gets dk = dv = 0.
template <typename T, int kD, int kSched>
__global__ void __launch_bounds__(kThreads)
core_bwd_keys(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
              const float* __restrict__ stats, int S, int heads, int causal, int s_valid,
              float scale) {
  using L = Layout<T, kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, kD> sm(smem);
  const int W = heads * kD, W3 = 3 * W;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3 + h * kD;
  const T* gbase = g + (size_t)b * S * W + h * kD;
  const size_t bhs = (size_t)gridDim.z * heads * S, so = ((size_t)b * heads + h) * S;

  load_tile<T, kD>(sm.K, base + W, W3, k0, S);
  load_tile<T, kD>(sm.V, base + 2 * W, W3, k0, S);
  const int n_keys = min(S, s_valid);
  const int qt_end = k0 < n_keys ? (S + kT - 1) / kT : 0;
  Mma<T, kD> dk, dv;
  dk.zero();
  dv.zero();
  for (int qt = causal ? k0 / kT : 0; qt < qt_end; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<T, kD>(sm.Q, base, W3, q0, S);
    load_tile<T, kD>(sm.G, gbase, W, q0, S);
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      const int i = q0 + r;
      sm.m[r] = i < S ? stats[so + i] : 0.f;
      sm.rs[r] = i < S ? stats[bhs + so + i] : 1.f;
      sm.ds[r] = i < S ? stats[2 * bhs + so + i] : 0.f;
    }
    __syncthreads();
    Mma<T, kD>::abt(sm.Q, sm.K, sm.Lg);
    Mma<T, kD>::abt(sm.G, sm.V, sm.DP);
    __syncwarp();
    for (int rr = 0; rr < kWarpRows; ++rr) {
      const int r = warp * kWarpRows + rr, i = q0 + r;
      const float m = sm.m[r], rs = sm.rs[r];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u, j = k0 + c;
        const bool ok = i < S && j < n_keys && !(causal && j > i);
        const float e = ok ? expf(sm.Lg[r * L::kLdL + c] * scale - m) : 0.f;
        const float dp = sm.DP[r * L::kLdL + c];
        float w, sub;  // the same P (or e) and dS as core_bwd_rows
        if (kSched == kNormalizeFirst) {
          w = e / rs;
          sub = sm.ds[r];
        } else {
          w = e;
          sub = sm.ds[r] / rs;
        }
        sm.P[r * L::kLdP + c] = from_f<T>(w);
        sm.DS[r * L::kLdP + c] = from_f<T>(w * (dp - sub));
      }
    }
    if (kSched == kDeferred) {  // q / denom and g / denom, cast, in place
      __syncwarp();
      for (int rr = 0; rr < kWarpRows; ++rr) {
        const int r = warp * kWarpRows + rr;
        const float rs = sm.rs[r];
        for (int d = lane; d < kD; d += 32) {
          sm.Q[r * L::kLdT + d] = from_f<T>(to_f(sm.Q[r * L::kLdT + d]) / rs);
          sm.G[r * L::kLdT + d] = from_f<T>(to_f(sm.G[r * L::kLdT + d]) / rs);
        }
      }
    }
    __syncthreads();  // the products below sum over every row of the q tile
    dv.atb(sm.P, sm.G);
    dk.atb(sm.DS, sm.Q);
  }

  // Lg is free: its last readers passed the barrier above.
  __syncwarp();
  dv.store(sm.Lg);
  __syncwarp();
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr, j = k0 + r;
    if (j >= S) break;
    for (int d = lane; d < kD; d += 32)
      dqkv[((size_t)b * S + j) * W3 + 2 * W + h * kD + d] = from_f<T>(sm.Lg[r * L::kLdL + d]);
  }
  __syncwarp();
  dk.store(sm.Lg);
  __syncwarp();
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr, j = k0 + r;
    if (j >= S) break;
    for (int d = lane; d < kD; d += 32)
      dqkv[((size_t)b * S + j) * W3 + W + h * kD + d] =
          from_f<T>(sm.Lg[r * L::kLdL + d] * scale);
  }
}

template <typename T, int kD, int kSched>
cudaError_t launch(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats, int B,
                   int S, int heads, int causal, int s_valid, cudaStream_t stream) {
  const size_t smem = Layout<T, kD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(core_bwd_rows<T, kD, kSched>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(core_bwd_keys<T, kD, kSched>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kT - 1) / kT, heads, B);
  const float scale = (float)(1.0 / sqrt((double)kD));
  const T* q = static_cast<const T*>(qkv);
  const T* gr = static_cast<const T*>(g);
  T* dq = static_cast<T*>(dqkv);
  core_bwd_rows<T, kD, kSched><<<grid, kThreads, smem, stream>>>(
      q, gr, static_cast<T*>(ctx), dq, stats, S, heads, causal, s_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  core_bwd_keys<T, kD, kSched><<<grid, kThreads, smem, stream>>>(
      q, gr, dq, stats, S, heads, causal, s_valid, scale);
  return cudaGetLastError();
}

// Every tower of the config has head_dim 64; the kernels are built for it.
constexpr int kHeadDim = 64;

template <int kSched>
int run(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats, int B, int S,
        int heads, int head_dim, int causal, int s_valid, int dtype, int device,
        void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || heads > 65535 || S <= 0 || s_valid < 1 ||
      s_valid > S || head_dim != kHeadDim)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float, kHeadDim, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, causal,
                                           s_valid, s);
  if (dtype == kBF16)
    return launch<bf16, kHeadDim, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, causal,
                                          s_valid, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K4: dqkv of mha_core, normalize-first, S <= 512. stats: fp32 scratch
// [3, B, heads, S].
int plip_mha_core_bwd(const void* qkv, const void* g, void* dqkv, float* stats, int B,
                      int S, int heads, int head_dim, int causal, int s_valid, int dtype,
                      int device, void* stream) {
  if (S > 512) return cudaErrorInvalidValue;
  return run<kNormalizeFirst>(qkv, g, nullptr, dqkv, stats, B, S, heads, head_dim, causal,
                              s_valid, dtype, device, stream);
}

// K2's core past S = 128: the recomputed ctx and dqkv, deferred divide.
int plip_attn_core_bwd_tiled(const void* qkv, const void* dctx, void* ctx, void* dqkv,
                             float* stats, int B, int S, int heads, int head_dim,
                             int causal, int s_valid, int dtype, int device, void* stream) {
  return run<kDeferred>(qkv, dctx, ctx, dqkv, stats, B, S, heads, head_dim, causal, s_valid,
                        dtype, device, stream);
}

}  // extern "C"
