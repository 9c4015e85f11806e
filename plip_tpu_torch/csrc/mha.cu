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
// a block holds one (sequence, head, 64-row q tile), grid (q tiles, heads,
// B), and streams k and v through shared memory in 64-key tiles, so its
// shared memory does not grow with S. P is rounded exactly where the TPU
// kernels round it, against the exact row max m, so kernel and plain version
// agree to about one ulp. Two passes over the key tiles, each recomputing
// s = q . k^T:
//
//   pass 1  the fp32 row max m; normalize-first also the fp32 row sum rs of
//           e = exp(l - m), carried online: rs <- rs * exp(m_old - m_new) +
//           sum exp(l - m_new) whenever the max grows;
//   pass 2  e = exp(l - m) with the final m; P = cast(e / rs) normalize-first,
//           P = cast(e) deferred (and rs += the uncast e); ctx += P . v in
//           fp32; deferred, ctx / rs at the end. One cast to the compute dtype.
//
// The online row sum is not the online (flash) softmax, which casts P against
// a running max and rescales the P . v accumulator: that moves P's rounding
// and the bf16 bars reject it (tests/test_torch_core_schedule.py). Here only
// an fp32 sum is rescaled, a reorder of fp32 arithmetic like the tensor
// cores' own, and no P is formed before m is final.
//
// What bounds it on the card. At S = 577 the core is 4 S^2 D FLOPs a
// (sequence, head) against 8 S D bytes of qkv: compute-bound on the tensor
// cores in principle, and at D = 64 the exponentials (one or two a logit,
// expf, on the 16 a clock of the SM's special-function units) and the fp32
// softmax arithmetic weigh as much as the dots. bf16 runs on one warpgroup:
// both dots are wgmma m64n64k16 (csrc/wgmma.cuh), q . k^T with both tiles in
// shared memory, P . v with P straight from the logits' registers (the fp32
// accumulator, cast and repacked: no shared-memory round trip); the softmax
// runs on those registers, a row's reduction the thread's 16 values and two
// quad shuffles; k and v tiles arrive by cp.async into a two-stage ring with
// the 128-byte swizzle, the next tile in flight while this one is computed.
// fp32, and bf16 at a head_dim other than 64, run both dots on CUDA cores
// (8x4 and 8x(kD/16) outputs a thread) in full fp32, in three passes (max,
// sum, P . v; the sum's pass skipped when deferred): any head_dim up to 128,
// taken at run time, in fp32 tiles of the bucket kD (32, 64 or 128 columns)
// that holds it, zero past it. That path is bound by its shared-memory reads
// and is there for reach, not speed: the towers of the config all have
// head_dim 64, which bf16 runs on wgmma.
//
// Entry points launch on the stream they are given, allocate nothing, and
// return cudaGetLastError() (or cudaErrorInvalidValue for arguments they do
// not take, cudaErrorMisalignedAddress for bf16 data not 16-byte aligned) so
// the caller can raise.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace plip;

constexpr int kQT = 64;                       // query rows a block
constexpr int kKT = 64;                       // keys a tile
constexpr int kThreads = 128;                 // 4 warps: one warpgroup

// ---------------------------------------------------------------------------
// bf16: wgmma on one warpgroup, k and v through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kStages = 2;  // ring stages, each a k tile and a v tile

// Shared memory from a 1024-byte boundary: the q tile, then the stages.
struct Bf16Layout {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kStage0 = hopper::kTileBytes;
  static constexpr uint32_t kStage = 2 * hopper::kTileBytes;  // k, then v
  static constexpr size_t kBytes = kStage0 + kStages * kStage + 1024;  // + alignment slack
};

// Eight bf16 values, each times s in fp32 and rounded back.
__device__ __forceinline__ uint4 scale_bf16x8(uint4 v, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    w[i] = hopper::pack_bf16(__low2float(p) * s, __high2float(p) * s);
  }
  return v;
}

// One block: query rows q0..q0+63 of (sequence b, head h). Keys at or past
// n_keys (s_valid, and for causal the tile's last row) are never loaded;
// masked keys get p = 0. Key 0 is never masked, so every row's m is finite.
template <bool kScaleAfter>
__device__ __forceinline__ void mha_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ ctx,
                                         int S, int heads, int causal, int s_valid, int defer,
                                         float scale, unsigned char* smem_raw) {
  using namespace hopper;
  constexpr int kD = 64;
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t s_q = smem_u32(sm) + Bf16Layout::kQ;
  const int W = heads * kD, W3 = 3 * W;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const bf16* base = qkv + (size_t)b * S * W3 + h * kD;

  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kQT);
  const int n_tiles = (n_keys + kKT - 1) / kKT, n_items = 2 * n_tiles;
  // Item it < n_tiles is key tile it of pass 1 (k only); item n_tiles + t is
  // key tile t of pass 2 (k and v). Item it lives in stage it % kStages.
  auto stage = [&](int it) {
    return smem_u32(sm) + Bf16Layout::kStage0 + (it % kStages) * Bf16Layout::kStage;
  };
  auto issue = [&](int it) {
    if (it < n_items) {
      const int j0 = (it < n_tiles ? it : it - n_tiles) * kKT;
      load_tile_async(stage(it), base + W, W3, j0, S);
      if (it >= n_tiles) load_tile_async(stage(it) + kTileBytes, base + 2 * W, W3, j0, S);
    }
    cp_async_commit();  // empty past the last item: the group count stays uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // The q tile, while the first k tiles are in flight: K3, K5 and K12 round
  // q * D^-1/2 to bf16 before the dot; K1's q goes in as it is.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + kThreads * i, r = e >> 3, c = e & 7, row = q0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) v = *reinterpret_cast<const uint4*>(base + (size_t)row * W3 + c * 8);
    if (!kScaleAfter) v = scale_bf16x8(v, scale);
    *reinterpret_cast<uint4*>(sm + Bf16Layout::kQ + sw128(r, c)) = v;
  }

  // This thread's two rows (accumulator halves hh = 0, 1) and first column.
  const int lane = threadIdx.x % 32, c0 = 2 * (lane % 4);
  const int row0 = q0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int rows[2] = {row0, row0 + 8};

  float o[32], m[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int v = 0; v < 32; ++v) o[v] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();  // item it has landed (this thread's copies)
    fence_proxy_async();           // ... and is visible to wgmma
    __syncthreads();               // everyone's copies; the stage refilled next is free
    issue(it + kStages - 1);
    const bool pass2 = it >= n_tiles;
    const int j0 = (pass2 ? it - n_tiles : it) * kKT;
    const uint32_t s_k = stage(it);

    float s[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) s[v] = 0.f;
    wgmma_fence();
    issue_abt(s, s_q, s_k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    // fp32 logits (K1: scaled after the dot), masked to -inf; a tile that no
    // mask reaches (every key below n_keys and, causal, below every row) skips it
    if (j0 + kKT <= n_keys && !(causal && j0 + kKT - 1 > q0)) {
#pragma unroll
      for (int v = 0; v < 32; ++v)
        if (kScaleAfter) s[v] *= scale;
    } else {
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int j = j0 + 8 * (v >> 2) + c0 + (v & 1), i = rows[(v >> 1) & 1];
        const bool ok = j < n_keys && !(causal && j > i);
        s[v] = ok ? (kScaleAfter ? s[v] * scale : s[v]) : -INFINITY;
      }
    }

    if (!pass2) {
      // this thread's running max of its columns, and its share of the sum
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int v = 0; v < 32; ++v) mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], s[v]);
      if (!defer) {
        float ref[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ref[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];  // no valid key yet: rs stays 0
          rs[hh] *= expf(m[hh] - ref[hh]);
        }
#pragma unroll
        for (int v = 0; v < 32; ++v) rs[(v >> 1) & 1] += expf(s[v] - ref[(v >> 1) & 1]);
      }
      m[0] = mx[0];
      m[1] = mx[1];
      if (it == n_tiles - 1) {  // the row's max and sum over the quad
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mq = quad_max(m[hh]);
          rs[hh] = defer ? 0.f : quad_sum(rs[hh] * expf(m[hh] - mq));
          m[hh] = mq;
        }
      }
      continue;
    }

    // pass 2: P from the exact m, cast once, into the A fragments of P . v
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int hh = (v >> 1) & 1;
      const float e = expf(s[v] - m[hh]);  // masked: exp(-inf) = 0
      if (defer) {
        rs[hh] += e;
        s[v] = e;
      } else {
        s[v] = e / rs[hh];
      }
    }
    uint32_t a[4][4];
    to_a_frags(s, a);
    wgmma_fence();
    issue_ab(o, a, s_k + kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
  }

  if (defer) {
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
  }
  bf16* out = ctx + (size_t)b * S * W + h * kD;
#pragma unroll
  for (int v = 0; v < 32; v += 2) {
    const int hh = (v >> 1) & 1, i = rows[hh], col = 8 * (v >> 2) + c0;
    if (i < S) {
      const float x0 = defer ? o[v] / rs[hh] : o[v], x1 = defer ? o[v + 1] / rs[hh] : o[v + 1];
      *reinterpret_cast<uint32_t*>(out + (size_t)i * W + col) = pack_bf16(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores, three passes: fp32, and bf16 at a head_dim other than 64. The
// head's D columns (any D <= kD, the bucket the kernel is built for) load
// into fp32 tiles of kD columns, zero at and past D: zero q and k columns
// add exact zeros to the logits, zero v columns give context columns that
// are never stored. bf16 values load exactly, and P (and K3's, K5's and
// K12's q * D^-1/2) is rounded to bf16 where the plain versions cast them.
// ---------------------------------------------------------------------------

// Row strides: tiles kD + 1, so that 16 threads reading one column of 16
// rows hit 16 banks; logits max(64, kD) + 4.
template <int kD>
struct F32Layout {
  static constexpr int kLdT = kD + 1;                          // Qs, Ks, Vs
  static constexpr int kLdL = (kKT > kD ? kKT : kD) + 4;       // Ls
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(float) * kQT * kLdT;
  static constexpr size_t kV = kK + sizeof(float) * kKT * kLdT;
  static constexpr size_t kL = kV + sizeof(float) * kKT * kLdT;
  static constexpr size_t kM = kL + sizeof(float) * kQT * kLdL;
  static constexpr size_t kS = kM + sizeof(float) * kQT;
  static constexpr size_t kBytes = kS + sizeof(float) * kQT;
};

// The two dots of a tile and the P . v accumulator. Thread t: ty = t / 16
// owns rows 8ty..8ty+7 of Ls and of the accumulator, tx = t % 16 the columns
// tx + 16c.
template <int kD>
struct F32Dots {
  using L = F32Layout<kD>;
  float acc[8][kD / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) acc[i][c] = 0.f;
  }

  // Ls[r][c] = Qs[r] . Ks[c] over the 64 x 64 tile and the D live columns.
  __device__ void qk(const float* Qs, const float* Ks, float* Ls, int D) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float a[8][4] = {};
    for (int d = 0; d < D; ++d) {
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

  // acc += P . Vs, P in Ls.
  __device__ void pv(const float* Ls, const float* Vs) {
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

  // The accumulator into Ls[r][0..kD).
  __device__ void store(float* Ls) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c)
        Ls[(ty * 8 + i) * L::kLdL + tx + 16 * c] = acc[i][c];
  }
};

// Rows j0.. of one head's D columns (src points at row 0, column h*D of the
// q, k or v block) into a 64-row tile of kD fp32 columns, times `scale` and
// rounded back to T (K3's q; 1 for the rest, which loads exactly); rows at
// or past S and columns at or past D are zero.
template <typename T, int kD>
__device__ void load_tile_f32(float* dst, const T* src, int W3, int j0, int S, int D,
                              float scale = 1.f) {
  for (int e = threadIdx.x; e < kKT * kD; e += kThreads) {
    const int r = e / kD, d = e % kD, j = j0 + r;
    dst[r * F32Layout<kD>::kLdT + d] =
        j < S && d < D ? round_to<T>(to_f(src[(size_t)j * W3 + d]) * scale) : 0.f;
  }
}

// The same block as mha_bf16: pass 0 the row max, pass 1 (normalize-first)
// the row sum, pass 2 P and P . v (deferred: the row sum too).
template <typename T, int kD, bool kScaleAfter>
__device__ __forceinline__ void mha_simt(const T* __restrict__ qkv, T* __restrict__ ctx, int S,
                                         int heads, int D, int causal, int s_valid, int defer,
                                         float scale, unsigned char* smem) {
  using L = F32Layout<kD>;
  constexpr int kWarpRows = kQT / (kThreads / 32);  // 16: warp w owns rows 16w..16w+15
  float* Qs = reinterpret_cast<float*>(smem + L::kQ);
  float* Ks = reinterpret_cast<float*>(smem + L::kK);
  float* Vs = reinterpret_cast<float*>(smem + L::kV);
  float* Ls = reinterpret_cast<float*>(smem + L::kL);
  float* row_max = reinterpret_cast<float*>(smem + L::kM);
  float* row_sum = reinterpret_cast<float*>(smem + L::kS);

  const int W = heads * D, W3 = 3 * W;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3 + h * D;

  // q * D^-1/2, cast, as K3 and K5 scale it before the dot; K1's q goes in
  // as it is.
  load_tile_f32<T, kD>(Qs, base, W3, q0, S, D, kScaleAfter ? 1.f : scale);
  if (lane < kWarpRows) {
    row_max[warp * kWarpRows + lane] = -INFINITY;
    row_sum[warp * kWarpRows + lane] = 0.f;
  }
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kQT);
  const int n_tiles = (n_keys + kKT - 1) / kKT;

  // Both mappings give warp w the rows 16w..16w+15 of Ls and of the
  // accumulator, so the softmax of a tile needs no block-wide barrier.
  F32Dots<kD> dots;
  dots.zero();
  for (int pass = 0; pass < 3; ++pass) {
    if (pass == 1 && defer) continue;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kKT;
      __syncthreads();  // every thread is done with the previous tile
      load_tile_f32<T, kD>(Ks, base + W, W3, j0, S, D);
      if (pass == 2) load_tile_f32<T, kD>(Vs, base + 2 * W, W3, j0, S, D);
      __syncthreads();
      dots.qk(Qs, Ks, Ls, D);
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
        for (int u = 0; u < 2; ++u) Ls[r * L::kLdL + lane + 32 * u] = round_to<T>(p[u]);
      }
      __syncwarp();
      if (pass == 2) dots.pv(Ls, Vs);
    }
  }

  __syncwarp();
  dots.store(Ls);
  __syncwarp();
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr, i = q0 + r;
    if (i >= S) break;
    const float s = row_sum[r];
    for (int d = lane; d < D; d += 32) {
      const float a = Ls[r * L::kLdL + d];
      ctx[((size_t)b * S + i) * W + h * D + d] = from_f<T>(defer ? a / s : a);
    }
  }
}

// grid = (q tiles, heads, B). kScaleAfter: K1's placement of D^-1/2 (on the
// fp32 logits) instead of K3's, K5's and K12's (on q, cast). bf16 at head_dim
// 64 on wgmma:
template <bool kScaleAfter>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int S, int heads, int causal,
           int s_valid, int defer, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  mha_bf16<kScaleAfter>(qkv, ctx, S, heads, causal, s_valid, defer, scale, smem);
}

// ... fp32, and bf16 at another head_dim, on CUDA cores:
template <typename T, int kD, bool kScaleAfter>
__global__ void __launch_bounds__(kThreads)
mha_simt_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int S, int heads, int D,
                int causal, int s_valid, int defer, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  mha_simt<T, kD, kScaleAfter>(qkv, ctx, S, heads, D, causal, s_valid, defer, scale, smem);
}

template <bool kScaleAfter>
cudaError_t launch_wgmma(const void* qkv, void* ctx, int B, int S, int heads, int causal,
                         int s_valid, int defer, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(ctx) % 4)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(mha_kernel<kScaleAfter>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Bf16Layout::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQT - 1) / kQT, heads, B);
  mha_kernel<kScaleAfter><<<grid, kThreads, Bf16Layout::kBytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx), S, heads, causal, s_valid, defer,
      (float)(1.0 / sqrt(64.0)));
  return cudaGetLastError();
}

template <typename T, int kD, bool kScaleAfter>
cudaError_t launch_simt(const void* qkv, void* ctx, int B, int S, int heads, int D, int causal,
                        int s_valid, int defer, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mha_simt_kernel<T, kD, kScaleAfter>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F32Layout<kD>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQT - 1) / kQT, heads, B);
  mha_simt_kernel<T, kD, kScaleAfter><<<grid, kThreads, F32Layout<kD>::kBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(ctx), S, heads, D, causal, s_valid, defer,
      (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// The CUDA-core kernel's head_dim buckets: D <= 32, <= 64, <= 128.
template <typename T, bool kScaleAfter>
cudaError_t launch_bucket(const void* qkv, void* ctx, int B, int S, int heads, int D,
                          int causal, int s_valid, int defer, cudaStream_t stream) {
  if (D <= 32)
    return launch_simt<T, 32, kScaleAfter>(qkv, ctx, B, S, heads, D, causal, s_valid, defer,
                                           stream);
  if (D <= 64)
    return launch_simt<T, 64, kScaleAfter>(qkv, ctx, B, S, heads, D, causal, s_valid, defer,
                                           stream);
  return launch_simt<T, 128, kScaleAfter>(qkv, ctx, B, S, heads, D, causal, s_valid, defer,
                                          stream);
}

// The widest head the kernels take (ops/attention.py MAX_HEAD_DIM).
constexpr int kMaxHeadDim = 128;

template <bool kScaleAfter>
int run(const void* qkv, void* ctx, int B, int S, int heads, int head_dim, int causal,
        int s_valid, int defer, int dtype, int device, void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || heads > 65535 || S <= 0 || s_valid < 1 ||
      s_valid > S || head_dim <= 0 || head_dim > kMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_bucket<float, kScaleAfter>(qkv, ctx, B, S, heads, head_dim, causal, s_valid,
                                             defer, s);
  if (dtype == kBF16) {
    if (head_dim == 64)
      return launch_wgmma<kScaleAfter>(qkv, ctx, B, S, heads, causal, s_valid, defer, s);
    return launch_bucket<bf16, kScaleAfter>(qkv, ctx, B, S, heads, head_dim, causal, s_valid,
                                            defer, s);
  }
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
