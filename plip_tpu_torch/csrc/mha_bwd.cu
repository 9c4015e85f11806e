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
//   core_bwd_rows  one block per (sequence, head, 64-row q tile), two passes
//                  over the key tiles, each computing s = q . k^T and
//                  dp = g . v^T:
//                  pass A  the fp32 row max m, and with it the fp32 rs =
//                          rowsum(e) and sigma = rowsum(dp o e), both carried
//                          online: rescaled by exp(m_old - m_new) whenever m
//                          grows. Then dsum = sigma / rs (normalize-first, a
//                          regrouping of rowsum(dp o e / rs)) or dsum_u =
//                          sigma (deferred).
//                  pass B  e = exp(l - m) with the final m; dS (or dS_u and
//                          e_c) as above, summed into dq (and e_c into ctx).
//                  Writes dq, ctx and the per-row fp32 m, rs and dsum.
//   core_bwd_keys  one block per (sequence, head, 64-key tile). Loops over
//                  the q tiles that see its keys, rebuilds P and dS from the
//                  row statistics with the same formulas, sums dv and dk.
//
// The online sums are not the online (flash) softmax: they rescale fp32 sums
// only (a reorder of fp32 arithmetic), and no P or dS is cast before m is
// final. dq, dk and dv sum 64-row tile products over up to 17 tiles: each
// tile's product runs on the tensor cores into a fresh accumulator, and the
// tiles are added with IEEE fp32 adds. Carried across all tiles in one
// tensor-core accumulator (whose fp32 adds are not IEEE-rounded), the sums
// drift further from the exact ones and, past 1,000 tokens, dqkv's share of
// elements differing from the plain version reached its 0.5% bar. In bf16 the keys kernel computes the transposed products (k . q^T,
// v . g^T), whose fp32 sums run in another order than the rows kernel's, so
// its P and dS may differ from the rows kernel's in the last bit; the bars on
// dqkv hold the result. fp32 recomputes both with the same code on the same
// tiles, so there they are bit-identical.
//
// What bounds it on the card. At L/14 (S = 257, D = 64) the backward is 10
// S^2 D FLOPs a (sequence, head) against 14 S D bytes of qkv, g and dqkv in
// bf16: compute-bound on the tensor cores in principle; at D = 64 the
// exponentials (expf, twice a (row, key) pair in the rows kernel and once in
// the keys kernel) and the elementwise fp32 arithmetic weigh about as much.
// bf16 runs on one warpgroup a block (csrc/wgmma.cuh): q . k^T and g . v^T
// (k . q^T and v . g^T in the keys kernel) are wgmma with both tiles in
// shared memory; dS . k, e_c . v, P_c^T . g and dS^T . q take dS, e_c and P_c
// straight from the registers of the products they come from (cast and
// repacked: no shared-memory round trip), so the keys kernel's dk and dv stay
// two register accumulators; tiles arrive by cp.async into a two-stage ring
// with the 128-byte swizzle (the keys kernel's stages also carry the q tile's
// row statistics). fp32, and bf16 at a head_dim other than 64, run on CUDA
// cores (8x4 and 8x(kD/16) outputs a thread) in full fp32, in the rows
// kernel's four passes (three deferred): the max, the sum (and dsum_u),
// normalize-first dsum, then dS; any head_dim up to 128, taken at run time,
// in fp32 tiles of the bucket kD (32, 64 or 128 columns) that holds it.
//
// Entry points launch on the stream they are given, allocate nothing (the
// caller passes the fp32 statistics scratch [3, B, heads, S]), and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments they do not
// take, cudaErrorMisalignedAddress for bf16 data not 16-byte aligned) so the
// caller can raise.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace plip;

constexpr int kT = 64;          // q rows or keys a tile
constexpr int kThreads = 128;   // 4 warps: one warpgroup
constexpr int kNormalizeFirst = 0, kDeferred = 1;

// ---------------------------------------------------------------------------
// bf16: wgmma on one warpgroup, tiles through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kStages = 2;

// core_bwd_rows, from a 1024-byte boundary: the q and g tiles, then the
// stages, each a k tile and a v tile.
struct RowsLayout {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kG = hopper::kTileBytes;
  static constexpr uint32_t kStage0 = 2 * hopper::kTileBytes;
  static constexpr uint32_t kStage = 2 * hopper::kTileBytes;
  static constexpr size_t kBytes = kStage0 + kStages * kStage + 1024;  // + alignment slack
};

// core_bwd_keys: the k and v tiles, the deferred schedule's cast(q / rs) and
// cast(g / rs) of the current q tile, then the stages, each a q tile, a g
// tile and the q tile's fp32 m, rs and dsum (3 x 64, padded to 1024 bytes).
struct KeysLayout {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = hopper::kTileBytes;
  static constexpr uint32_t kQn = 2 * hopper::kTileBytes;
  static constexpr uint32_t kGn = 3 * hopper::kTileBytes;
  static constexpr uint32_t kStage0 = 4 * hopper::kTileBytes;
  static constexpr uint32_t kStats = 2 * hopper::kTileBytes;  // within a stage
  static constexpr uint32_t kStage = 2 * hopper::kTileBytes + 1024;
  static constexpr size_t kBytes = kStage0 + kStages * kStage + 1024;
};

// core_bwd_rows, bf16: query rows q0..q0+63 of (sequence b, head h). Keys at
// or past n_keys (s_valid, and for causal the tile's last row) are never
// loaded; masked keys get e = 0. Key 0 is never masked: every m is finite.
template <int kSched>
__device__ __forceinline__ void rows_bf16(const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ g, bf16* __restrict__ ctx,
                                          bf16* __restrict__ dqkv, float* __restrict__ stats,
                                          int S, int heads, int causal, int s_valid,
                                          float scale, unsigned char* smem_raw) {
  using namespace hopper;
  constexpr int kD = 64;
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const int W = heads * kD, W3 = 3 * W;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const bf16* base = qkv + (size_t)b * S * W3 + h * kD;

  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kT);
  const int n_tiles = (n_keys + kT - 1) / kT, n_items = 2 * n_tiles;
  // Item it: key tile it % n_tiles of pass A (it < n_tiles) or B, in stage
  // it % kStages.
  auto stage = [&](int it) {
    return s0 + RowsLayout::kStage0 + (it % kStages) * RowsLayout::kStage;
  };
  auto issue = [&](int it) {
    if (it < n_items) {
      const int j0 = (it < n_tiles ? it : it - n_tiles) * kT;
      load_tile_async(stage(it), base + W, W3, j0, S);
      load_tile_async(stage(it) + kTileBytes, base + 2 * W, W3, j0, S);
    }
    cp_async_commit();
  };
  load_tile_async(s0 + RowsLayout::kQ, base, W3, q0, S);
  load_tile_async(s0 + RowsLayout::kG, g + (size_t)b * S * W + h * kD, W, q0, S);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);  // the first group holds q and g too

  const int lane = threadIdx.x % 32, c0 = 2 * (lane % 4);
  const int row0 = q0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  // sg: sigma in pass A, then dsum (normalize-first) or dsum_u (deferred)
  float m[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, sg[2] = {0.f, 0.f}, sub[2];
  float dq[32], cx[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) dq[v] = cx[v] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    issue(it + kStages - 1);
    const bool pass_b = it >= n_tiles;
    const int j0 = (pass_b ? it - n_tiles : it) * kT;
    const uint32_t s_k = stage(it), s_v = s_k + kTileBytes;

    float s[32], dp[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) s[v] = dp[v] = 0.f;
    wgmma_fence();
    issue_abt(s, s0 + RowsLayout::kQ, s_k);
    issue_abt(dp, s0 + RowsLayout::kG, s_v);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    if (j0 + kT <= n_keys && !(causal && j0 + kT - 1 > q0)) {  // no mask reaches the tile
#pragma unroll
      for (int v = 0; v < 32; ++v) s[v] *= scale;
    } else {
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int j = j0 + 8 * (v >> 2) + c0 + (v & 1), i = rows[(v >> 1) & 1];
        const bool ok = j < n_keys && !(causal && j > i);
        s[v] = ok ? s[v] * scale : -INFINITY;
      }
    }

    if (!pass_b) {
      float mx[2] = {m[0], m[1]}, ref[2];
#pragma unroll
      for (int v = 0; v < 32; ++v) mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], s[v]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ref[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];  // no valid key yet: the sums stay 0
        const float a = expf(m[hh] - ref[hh]);
        rs[hh] *= a;
        sg[hh] *= a;
        m[hh] = mx[hh];
      }
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int hh = (v >> 1) & 1;
        const float e = expf(s[v] - ref[hh]);  // masked: exp(-inf) = 0
        rs[hh] += e;
        sg[hh] += dp[v] * e;
      }
      if (it == n_tiles - 1) {  // the row's statistics over the quad
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mq = quad_max(m[hh]), a = expf(m[hh] - mq);
          rs[hh] = quad_sum(rs[hh] * a);
          sg[hh] = quad_sum(sg[hh] * a);
          m[hh] = mq;
          if (kSched == kNormalizeFirst) sg[hh] /= rs[hh];
          sub[hh] = kSched == kNormalizeFirst ? sg[hh] : sg[hh] / rs[hh];
        }
      }
      continue;
    }

    // pass B: dS = w o (dp - sub), w = P (normalize-first) or e (deferred);
    // deferred also e_c, in dp's registers once dp is read
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int hh = (v >> 1) & 1;
      const float e = expf(s[v] - m[hh]);
      const float w = kSched == kNormalizeFirst ? e / rs[hh] : e;
      s[v] = w * (dp[v] - sub[hh]);
      dp[v] = e;
    }
    uint32_t ds_a[4][4], e_a[4][4];
    to_a_frags(s, ds_a);
    if (kSched == kDeferred) to_a_frags(dp, e_a);
    float t_dq[32];  // this tile's dS . k, added to dq in IEEE fp32 (header)
#pragma unroll
    for (int v = 0; v < 32; ++v) t_dq[v] = 0.f;
    wgmma_fence();
    issue_ab(t_dq, ds_a, s_k);
    if (kSched == kDeferred) issue_ab(cx, e_a, s_v);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(t_dq);
    if (kSched == kDeferred) fence_acc(cx);
#pragma unroll
    for (int v = 0; v < 32; ++v) dq[v] += t_dq[v];
  }
  cp_async_wait<0>();

  store_acc(dqkv + (size_t)b * S * W3 + h * kD, W3, dq, row0, S, [&](float x, int hh) {
    const float y = x * scale;
    return kSched == kDeferred ? y / rs[hh] : y;
  });
  if (kSched == kDeferred)
    store_acc(ctx + (size_t)b * S * W + h * kD, W, cx, row0, S,
              [&](float x, int hh) { return x / rs[hh]; });
  if (lane % 4 == 0) {
    const size_t bhs = (size_t)gridDim.z * heads * S, o = ((size_t)b * heads + h) * S;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = rows[hh];
      if (i < S) {
        stats[o + i] = m[hh];
        stats[bhs + o + i] = rs[hh];
        stats[2 * bhs + o + i] = sg[hh];
      }
    }
  }
}

// core_bwd_keys, bf16: keys k0..k0+63 of (sequence b, head h), the M rows of
// every product. The q tiles before the key tile see none of its keys when
// causal; a tile of keys at or past s_valid gets dk = dv = 0.
template <int kSched>
__device__ __forceinline__ void keys_bf16(const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ g, bf16* __restrict__ dqkv,
                                          const float* __restrict__ stats, int S, int heads,
                                          int causal, int s_valid, float scale,
                                          unsigned char* smem_raw) {
  using namespace hopper;
  constexpr int kD = 64;
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const int W = heads * kD, W3 = 3 * W;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const bf16* base = qkv + (size_t)b * S * W3 + h * kD;
  const bf16* gbase = g + (size_t)b * S * W + h * kD;
  const size_t bhs = (size_t)gridDim.z * heads * S, so = ((size_t)b * heads + h) * S;

  const int n_keys = min(S, s_valid);
  const int qt0 = causal ? k0 / kT : 0, qt_end = k0 < n_keys ? (S + kT - 1) / kT : 0;
  const int n_items = max(qt_end - qt0, 0);
  auto stage = [&](int it) {
    return KeysLayout::kStage0 + (it % kStages) * KeysLayout::kStage;  // offset from s0
  };
  auto issue = [&](int it) {
    if (it < n_items) {
      const int q0 = (qt0 + it) * kT;
      const uint32_t st = s0 + stage(it);
      load_tile_async(st, base, W3, q0, S);
      load_tile_async(st + kTileBytes, gbase, W, q0, S);
      if (threadIdx.x < kT) {  // m, rs, dsum of the tile's rows; zero past S
        const int i = q0 + threadIdx.x;
        const bool ok = i < S;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          cp_async4(st + KeysLayout::kStats + 4 * (k * kT + threadIdx.x),
                    stats + k * bhs + so + (ok ? i : 0), ok);
      }
    }
    cp_async_commit();
  };
  if (n_items > 0) {
    load_tile_async(s0 + KeysLayout::kK, base + W, W3, k0, S);
    load_tile_async(s0 + KeysLayout::kV, base + 2 * W, W3, k0, S);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const int lane = threadIdx.x % 32, c0 = 2 * (lane % 4);
  const int key0 = k0 + (threadIdx.x / 32) * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  float dk[32], dv[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) dk[v] = dv[v] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    issue(it + kStages - 1);
    const int q0 = (qt0 + it) * kT;
    const uint32_t st = stage(it);
    const float* st_m = reinterpret_cast<const float*>(sm + st + KeysLayout::kStats);
    const float* st_rs = st_m + kT;
    const float* st_ds = st_m + 2 * kT;

    float sT[32], dpT[32];  // s^T = k . q^T and dp^T = v . g^T: keys x q rows
#pragma unroll
    for (int v = 0; v < 32; ++v) sT[v] = dpT[v] = 0.f;
    wgmma_fence();
    issue_abt(sT, s0 + KeysLayout::kK, s0 + st);
    issue_abt(dpT, s0 + KeysLayout::kV, s0 + st + kTileBytes);
    wgmma_commit();
    if (kSched == kDeferred) {  // meanwhile cast(q / rs) and cast(g / rs) of this q tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = threadIdx.x + kThreads * i, r = e >> 3, c = e & 7;
        const float d = q0 + r < S ? st_rs[r] : 1.f;
        const uint32_t off = sw128(r, c);
        *reinterpret_cast<uint4*>(sm + KeysLayout::kQn + off) =
            div_bf16x8(*reinterpret_cast<const uint4*>(sm + st + off), d);
        *reinterpret_cast<uint4*>(sm + KeysLayout::kGn + off) =
            div_bf16x8(*reinterpret_cast<const uint4*>(sm + st + kTileBytes + off), d);
      }
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_acc(sT);
    fence_acc(dpT);
    // P^T (w = P or e) and dS^T = w o (dp - sub), from the q rows' statistics;
    // no mask reaches a tile of valid rows and keys wholly at or below the rows
    const bool interior = q0 + kT <= S && k0 + kT <= n_keys && !(causal && k0 + kT - 1 > q0);
#pragma unroll
    for (int u = 0; u < 16; ++u) {  // this thread's q columns 8 (u / 2) + c0 + u % 2
      const int col = 8 * (u >> 1) + c0 + (u & 1), i = q0 + col;
      const bool row_ok = i < S;
      const float mi = row_ok ? st_m[col] : 0.f, rsi = row_ok ? st_rs[col] : 1.f;
      const float dsi = row_ok ? st_ds[col] : 0.f;
      const float sub = kSched == kNormalizeFirst ? dsi : dsi / rsi;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * (u >> 1) + 2 * hh + (u & 1), j = key0 + 8 * hh;
        const bool ok = interior || (row_ok && j < n_keys && !(causal && j > i));
        const float e = ok ? expf(sT[v] * scale - mi) : 0.f;
        const float w = kSched == kNormalizeFirst ? e / rsi : e;
        sT[v] = w;
        dpT[v] = w * (dpT[v] - sub);
      }
    }
    uint32_t p_a[4][4], ds_a[4][4];
    to_a_frags(sT, p_a);
    to_a_frags(dpT, ds_a);
    if (kSched == kDeferred) __syncthreads();  // everyone's cast(q / rs), cast(g / rs)
    float t_dv[32], t_dk[32];  // this q tile's products, added in IEEE fp32 (header)
#pragma unroll
    for (int v = 0; v < 32; ++v) t_dv[v] = t_dk[v] = 0.f;
    wgmma_fence();
    issue_ab(t_dv, p_a, s0 + (kSched == kDeferred ? KeysLayout::kGn : st + kTileBytes));
    issue_ab(t_dk, ds_a, s0 + (kSched == kDeferred ? KeysLayout::kQn : st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(t_dv);
    fence_acc(t_dk);
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      dv[v] += t_dv[v];
      dk[v] += t_dk[v];
    }
  }
  cp_async_wait<0>();

  bf16* out = dqkv + (size_t)b * S * W3 + h * kD;
  store_acc(out + 2 * W, W3, dv, key0, S, [](float x, int) { return x; });
  store_acc(out + W, W3, dk, key0, S, [&](float x, int) { return x * scale; });
}

// ---------------------------------------------------------------------------
// CUDA cores: fp32, and bf16 at a head_dim other than 64. The head's D
// columns (any D <= kD, the bucket the kernels are built for) load into fp32
// tiles of kD columns, zero at and past D, which add exact zeros to every
// product and are never stored. bf16 values load exactly; P (K4's dv), e_c,
// dS, q / denom and g / denom are rounded to bf16 where the plain versions
// cast them.
// ---------------------------------------------------------------------------

constexpr int kWarpRows = kT / (kThreads / 32);  // 16: warp w owns rows 16w..16w+15

// Row strides. [64][D] tiles of q, g, k, v: kD + 1 (16 threads reading one
// column of 16 rows hit 16 banks). [64][64] logits, dp, P and dS: 64 + 4.
// The outputs go out through the logits and dp regions, read as one
// [64][kD + 4] tile (kLdO).
template <int kD>
struct F32Layout {
  static constexpr int kLdT = kD + 1;
  static constexpr int kLdL = kT + 4;
  static constexpr int kLdP = kT + 4;
  static constexpr int kLdO = kD + 4;
  static constexpr size_t kTile = sizeof(float) * kT * kLdT;
  static constexpr size_t kQ = 0;
  static constexpr size_t kG = kQ + kTile;
  static constexpr size_t kK = kG + kTile;
  static constexpr size_t kV = kK + kTile;
  static constexpr size_t kL = kV + kTile;
  static constexpr size_t kDP = kL + sizeof(float) * kT * kLdL;
  static constexpr size_t kP = kDP + sizeof(float) * kT * kLdL;
  static constexpr size_t kDS = kP + sizeof(float) * kT * kLdP;
  static constexpr size_t kStat = kDS + sizeof(float) * kT * kLdP;  // m, rowsum, dsum [64]
  static constexpr size_t kBytes = kStat + sizeof(float) * 3 * kT;
  static_assert(kT * kLdO <= 2 * kT * kLdL, "the output tile fits the logits and dp");
};

// The tile products. Thread t: ty = t / 16 owns rows 8ty..8ty+7 of the output
// (so warp w rows 16w..16w+15, and the softmax of a tile needs no block-wide
// barrier), tx = t % 16 the columns tx + 16c.
template <int kD>
struct F32Mma {
  using L = F32Layout<kD>;
  float acc[8][kD / 16];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) acc[i][c] = 0.f;
  }

  // out[r][c] = A[r] . B[c] over the D live columns: [64][ldT] x [64][ldT] -> [64][ldL].
  __device__ static void abt(const float* A, const float* B, float* out, int D) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float a[8][4] = {};
    for (int d = 0; d < D; ++d) {
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

  // The accumulator into out[r][0..kD) (ldO).
  __device__ void store(float* out) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kD / 16; ++c) out[(ty * 8 + i) * L::kLdO + tx + 16 * c] = acc[i][c];
  }
};

// Rows r0.. of one head's D columns (src points at row 0 of that head's
// columns, ld elements a row) into a [64][ldT] tile of kD fp32 columns; rows
// at or past S and columns at or past D are zero.
template <typename T, int kD>
__device__ void load_tile_f32(float* dst, const T* src, int ld, int r0, int S, int D) {
  for (int e = threadIdx.x; e < kT * kD; e += kThreads) {
    const int r = e / kD, d = e % kD, i = r0 + r;
    dst[r * F32Layout<kD>::kLdT + d] = i < S && d < D ? to_f(src[(size_t)i * ld + d]) : 0.f;
  }
}

// Rows r0.. of a [64][ldO] output tile into columns 0..D of rows r0.. of an
// [S][ld] head block (dst points at row 0 of that head's columns), times
// `mul` and divided by `div[r]` (null: 1); the tile's rows at or past S are
// not stored. Every warp stores its own 16 rows.
template <typename T, int kD>
__device__ void store_rows(T* dst, int ld, const float* tile, int r0, int S, int D, float mul,
                           const float* div) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr, i = r0 + r;
    if (i >= S) break;
    for (int d = lane; d < D; d += 32) {
      float v = tile[r * F32Layout<kD>::kLdO + d] * mul;
      if (div) v /= div[r];
      dst[(size_t)i * ld + d] = from_f<T>(v);
    }
  }
}

// The shared memory of a block: the same regions for both kernels.
template <int kD>
struct F32Smem {
  using L = F32Layout<kD>;
  float *Q, *G, *K, *V, *P, *DS, *Lg, *DP, *m, *rs, *ds;

  __device__ explicit F32Smem(unsigned char* s)
      : Q(reinterpret_cast<float*>(s + L::kQ)), G(reinterpret_cast<float*>(s + L::kG)),
        K(reinterpret_cast<float*>(s + L::kK)), V(reinterpret_cast<float*>(s + L::kV)),
        P(reinterpret_cast<float*>(s + L::kP)), DS(reinterpret_cast<float*>(s + L::kDS)),
        Lg(reinterpret_cast<float*>(s + L::kL)), DP(reinterpret_cast<float*>(s + L::kDP)),
        m(reinterpret_cast<float*>(s + L::kStat)), rs(m + kT), ds(m + 2 * kT) {}
};

// core_bwd_rows on CUDA cores. Passes over the key tiles: 0 the row max;
// normalize-first: 1 the row sum, 2 dsum, 3 dS and dq; deferred: 1 the row
// sum and dsum_u, 2 dS_u, dq and ctx.
template <typename T, int kD, int kSched>
__device__ __forceinline__ void rows_simt(const T* __restrict__ qkv, const T* __restrict__ g,
                                          T* __restrict__ ctx, T* __restrict__ dqkv,
                                          float* __restrict__ stats, int S, int heads, int D,
                                          int causal, int s_valid, float scale,
                                          unsigned char* smem) {
  using L = F32Layout<kD>;
  F32Smem<kD> sm(smem);
  const int W = heads * D, W3 = 3 * W;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3 + h * D;

  load_tile_f32<T, kD>(sm.Q, base, W3, q0, S, D);
  load_tile_f32<T, kD>(sm.G, g + (size_t)b * S * W + h * D, W, q0, S, D);
  if (lane < kWarpRows) {
    const int r = warp * kWarpRows + lane;
    sm.m[r] = -INFINITY;
    sm.rs[r] = 0.f;
    sm.ds[r] = 0.f;
  }
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kT);
  const int n_tiles = (n_keys + kT - 1) / kT;

  constexpr int kPasses = kSched == kDeferred ? 3 : 4;
  F32Mma<kD> dq, cx;
  dq.zero();
  cx.zero();
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool with_dp = pass >= kPasses - 2, last = pass == kPasses - 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kT;
      __syncthreads();  // every warp is done with the previous tile
      load_tile_f32<T, kD>(sm.K, base + W, W3, j0, S, D);
      if (with_dp) load_tile_f32<T, kD>(sm.V, base + 2 * W, W3, j0, S, D);
      __syncthreads();
      F32Mma<kD>::abt(sm.Q, sm.K, sm.Lg, D);
      if (with_dp) F32Mma<kD>::abt(sm.G, sm.V, sm.DP, D);
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
          sm.DS[r * L::kLdP + c] = round_to<T>(w[u] * (dp[u] - sub));
          if (kSched == kDeferred) sm.P[r * L::kLdP + c] = round_to<T>(e[u]);
        }
      }
      __syncwarp();
      if (last) {
        dq.ab(sm.DS, sm.K);
        if (kSched == kDeferred) cx.ab(sm.P, sm.V);
      }
    }
  }

  // The outputs go out through Lg and DP, which other warps may still read
  // in their last tile's softmax.
  __syncthreads();
  dq.store(sm.Lg);
  __syncwarp();
  T* out = dqkv + (size_t)b * S * W3 + h * D;
  store_rows<T, kD>(out, W3, sm.Lg, q0, S, D, scale, kSched == kDeferred ? sm.rs : nullptr);
  if (kSched == kDeferred) {
    __syncwarp();
    cx.store(sm.Lg);
    __syncwarp();
    store_rows<T, kD>(ctx + (size_t)b * S * W + h * D, W, sm.Lg, q0, S, D, 1.f, sm.rs);
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

// core_bwd_keys on CUDA cores: the same P and dS as rows_simt, bit for bit.
template <typename T, int kD, int kSched>
__device__ __forceinline__ void keys_simt(const T* __restrict__ qkv, const T* __restrict__ g,
                                          T* __restrict__ dqkv, const float* __restrict__ stats,
                                          int S, int heads, int D, int causal, int s_valid,
                                          float scale, unsigned char* smem) {
  using L = F32Layout<kD>;
  F32Smem<kD> sm(smem);
  const int W = heads * D, W3 = 3 * W;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * S * W3 + h * D;
  const T* gbase = g + (size_t)b * S * W + h * D;
  const size_t bhs = (size_t)gridDim.z * heads * S, so = ((size_t)b * heads + h) * S;

  load_tile_f32<T, kD>(sm.K, base + W, W3, k0, S, D);
  load_tile_f32<T, kD>(sm.V, base + 2 * W, W3, k0, S, D);
  const int n_keys = min(S, s_valid);
  const int qt_end = k0 < n_keys ? (S + kT - 1) / kT : 0;
  F32Mma<kD> dk, dv;
  dk.zero();
  dv.zero();
  for (int qt = causal ? k0 / kT : 0; qt < qt_end; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile_f32<T, kD>(sm.Q, base, W3, q0, S, D);
    load_tile_f32<T, kD>(sm.G, gbase, W, q0, S, D);
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      const int i = q0 + r;
      sm.m[r] = i < S ? stats[so + i] : 0.f;
      sm.rs[r] = i < S ? stats[bhs + so + i] : 1.f;
      sm.ds[r] = i < S ? stats[2 * bhs + so + i] : 0.f;
    }
    __syncthreads();
    F32Mma<kD>::abt(sm.Q, sm.K, sm.Lg, D);
    F32Mma<kD>::abt(sm.G, sm.V, sm.DP, D);
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
        sm.P[r * L::kLdP + c] = round_to<T>(w);
        sm.DS[r * L::kLdP + c] = round_to<T>(w * (dp - sub));
      }
    }
    if (kSched == kDeferred) {  // q / denom and g / denom, cast, in place
      __syncwarp();
      for (int rr = 0; rr < kWarpRows; ++rr) {
        const int r = warp * kWarpRows + rr;
        const float rs = sm.rs[r];
        for (int d = lane; d < D; d += 32) {
          sm.Q[r * L::kLdT + d] = round_to<T>(sm.Q[r * L::kLdT + d] / rs);
          sm.G[r * L::kLdT + d] = round_to<T>(sm.G[r * L::kLdT + d] / rs);
        }
      }
    }
    __syncthreads();  // the products below sum over every row of the q tile
    dv.atb(sm.P, sm.G);
    dk.atb(sm.DS, sm.Q);
  }

  // Lg and DP are free: their last readers passed the barrier above.
  T* out = dqkv + (size_t)b * S * W3 + h * D;
  __syncwarp();
  dv.store(sm.Lg);
  __syncwarp();
  store_rows<T, kD>(out + 2 * W, W3, sm.Lg, k0, S, D, 1.f, nullptr);
  __syncwarp();
  dk.store(sm.Lg);
  __syncwarp();
  store_rows<T, kD>(out + W, W3, sm.Lg, k0, S, D, scale, nullptr);
}

// grid = (q tiles, heads, B). bf16 at head_dim 64 on wgmma:
template <int kSched>
__global__ void __launch_bounds__(kThreads)
core_bwd_rows(const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ ctx,
              bf16* __restrict__ dqkv, float* __restrict__ stats, int S, int heads, int causal,
              int s_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  rows_bf16<kSched>(qkv, g, ctx, dqkv, stats, S, heads, causal, s_valid, scale, smem);
}

// grid = (key tiles, heads, B).
template <int kSched>
__global__ void __launch_bounds__(kThreads)
core_bwd_keys(const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
              const float* __restrict__ stats, int S, int heads, int causal, int s_valid,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  keys_bf16<kSched>(qkv, g, dqkv, stats, S, heads, causal, s_valid, scale, smem);
}

// The same two on CUDA cores: fp32, and bf16 at another head_dim.
template <typename T, int kD, int kSched>
__global__ void __launch_bounds__(kThreads)
bwd_rows_simt(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ ctx,
              T* __restrict__ dqkv, float* __restrict__ stats, int S, int heads, int D,
              int causal, int s_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  rows_simt<T, kD, kSched>(qkv, g, ctx, dqkv, stats, S, heads, D, causal, s_valid, scale,
                           smem);
}

template <typename T, int kD, int kSched>
__global__ void __launch_bounds__(kThreads)
bwd_keys_simt(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
              const float* __restrict__ stats, int S, int heads, int D, int causal,
              int s_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  keys_simt<T, kD, kSched>(qkv, g, dqkv, stats, S, heads, D, causal, s_valid, scale, smem);
}

template <int kSched>
cudaError_t launch_wgmma(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats,
                         int B, int S, int heads, int causal, int s_valid,
                         cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(g) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 4 || reinterpret_cast<uintptr_t>(dqkv) % 4)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(core_bwd_rows<kSched>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)RowsLayout::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(core_bwd_keys<kSched>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KeysLayout::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kT - 1) / kT, heads, B);
  const float scale = (float)(1.0 / sqrt(64.0));
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* gr = static_cast<const bf16*>(g);
  bf16* dq = static_cast<bf16*>(dqkv);
  core_bwd_rows<kSched><<<grid, kThreads, RowsLayout::kBytes, stream>>>(
      q, gr, static_cast<bf16*>(ctx), dq, stats, S, heads, causal, s_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  core_bwd_keys<kSched><<<grid, kThreads, KeysLayout::kBytes, stream>>>(
      q, gr, dq, stats, S, heads, causal, s_valid, scale);
  return cudaGetLastError();
}

template <typename T, int kD, int kSched>
cudaError_t launch_simt(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats,
                        int B, int S, int heads, int D, int causal, int s_valid,
                        cudaStream_t stream) {
  constexpr int kSmem = (int)F32Layout<kD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_simt<T, kD, kSched>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_keys_simt<T, kD, kSched>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kT - 1) / kT, heads, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  const T* q = static_cast<const T*>(qkv);
  const T* gr = static_cast<const T*>(g);
  T* dq = static_cast<T*>(dqkv);
  bwd_rows_simt<T, kD, kSched><<<grid, kThreads, kSmem, stream>>>(
      q, gr, static_cast<T*>(ctx), dq, stats, S, heads, D, causal, s_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_keys_simt<T, kD, kSched><<<grid, kThreads, kSmem, stream>>>(
      q, gr, dq, stats, S, heads, D, causal, s_valid, scale);
  return cudaGetLastError();
}

// The CUDA-core kernels' head_dim buckets: D <= 32, <= 64, <= 128.
template <typename T, int kSched>
cudaError_t launch_bucket(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats,
                          int B, int S, int heads, int D, int causal, int s_valid,
                          cudaStream_t s) {
  if (D <= 32)
    return launch_simt<T, 32, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, D, causal,
                                      s_valid, s);
  if (D <= 64)
    return launch_simt<T, 64, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, D, causal,
                                      s_valid, s);
  return launch_simt<T, 128, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, D, causal, s_valid,
                                     s);
}

// The widest head the kernels take (ops/attention.py MAX_HEAD_DIM).
constexpr int kMaxHeadDim = 128;

template <int kSched>
int run(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats, int B, int S,
        int heads, int head_dim, int causal, int s_valid, int dtype, int device,
        void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || heads > 65535 || S <= 0 || s_valid < 1 ||
      s_valid > S || head_dim <= 0 || head_dim > kMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_bucket<float, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, head_dim,
                                        causal, s_valid, s);
  if (dtype == kBF16) {
    if (head_dim == 64)
      return launch_wgmma<kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, causal, s_valid, s);
    return launch_bucket<bf16, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, head_dim, causal,
                                       s_valid, s);
  }
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
