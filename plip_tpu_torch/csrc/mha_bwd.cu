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
// grows with S: two kernels, no atomics (a run is bit-reproducible):
//
//   rows  one block per (sequence, head, tile of query rows), the row
//         statistics over every key: the fp32 row max m, and with it the
//         fp32 rs = rowsum(e) and sigma = rowsum(dp o e), both carried
//         online (rescaled by exp(m_old - m_new) whenever m grows). Then
//         dsum = sigma / rs (normalize-first, a regrouping of rowsum(dp o e /
//         rs)) or dsum_u = sigma (deferred); e = exp(l - m) with the final m;
//         dS (or dS_u and e_c) as above, summed into dq (and e_c into ctx).
//         Writes dq, ctx and the per-row fp32 m, rs and dsum.
//   keys  one block per (sequence, head, 64-key tile). Loops over the query
//         tiles that see its keys, rebuilds P and dS from the row statistics
//         with the same formulas, sums dv and dk.
//
// The online sums are not the online (flash) softmax: they rescale fp32 sums
// only (a reorder of fp32 arithmetic), and no P or dS is cast before m is
// final.
//
// bf16 at head_dim 64 runs on one warpgroup a block, 64-row tiles
// (csrc/wgmma.cuh): the rows kernel walks the key tiles twice (pass A the
// statistics, pass B dS), q . k^T and g . v^T (k . q^T and v . g^T in the
// keys kernel) on wgmma with both tiles in shared memory; dS . k, e_c . v,
// P_c^T . g and dS^T . q take dS, e_c and P_c straight from the registers of
// the products they come from (cast and repacked: no shared-memory round
// trip), so the keys kernel's dk and dv stay two register accumulators;
// tiles arrive by cp.async into a two-stage ring with the 128-byte swizzle
// (the keys kernel's stages also carry the q tile's row statistics). dq,
// dk and dv sum 64-row tile products over up to 17 tiles: each tile's
// product runs on the tensor cores into a fresh accumulator, and the tiles
// are added with IEEE fp32 adds. Carried across all tiles in one
// tensor-core accumulator (whose fp32 adds are not IEEE-rounded), the sums
// drift further from the exact ones and, past 1,000 tokens, dqkv's share of
// elements differing from the plain version reached its 0.5% bar. The keys
// kernel computes the transposed products (k . q^T, v . g^T), whose fp32
// sums run in another order than the rows kernel's, so its P and dS may
// differ from the rows kernel's in the last bit; the bars on dqkv hold the
// result.
//
// What bounds it on the card. At L/14 (S = 257, D = 64) the backward is 10
// S^2 D FLOPs a (sequence, head) against 14 S D bytes of qkv, g and dqkv in
// bf16: compute-bound. fp32 (the default dtype: every fp32 training step of
// ViT-B/16, L/14 and @336 runs this past 128 tokens) and bf16 at any other
// head_dim run on the tensor cores' TF32 products of csrc/tf32_attn.cuh
// (fp32 as three products, bf16 as one exact product), 8 warps a block.
// The rows kernel (tiled_bwd_rows_kernel, 64 query rows a block, two warps a
// row group splitting the keys; 128 rows, one, where @336's strips would not
// fit) computes s and dp once each, into two strips of shared memory over
// all its keys; the statistics, dS and e_c come from the strips, and dS . k
// and e_c . v read them. The keys kernel (tiled_bwd_keys_kernel, 64 keys a
// block, query tiles of 32 rows, 4 warps for each 64 columns) rebuilds s
// and dp once a query tile and keeps dk and dv in registers. Both rebuild
// every logit and dp with the same products (ascending head column, the
// same TF32 splits) and the same rounding (__fmul_rn for the scale, never
// contracted), so in fp32 their P and dS are the same bits
// (tests/test_torch_cuda.py::test_tiled_rows_and_keys_kernels_agree_bit_for_bit).
// Tails, windows and heads wider than 128 as in csrc/mha.cu: dead rows skip a
// warp at a time, dead keys 8 at a time; where the strips of every key
// would pass the shared memory (ops/attention.py tiled_plan) the keys go in
// windows and s and dp are computed again for dS; a wider head goes in
// 128-column chunks (q, g, k and v chunks streamed), dq, dk and dv 64 (or
// 128) columns at a time.
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
#include "tf32_attn.cuh"
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
// fp32, and bf16 at a head_dim other than 64, on the TF32 products of
// csrc/tf32_attn.cuh. bf16 values load exactly; P (K4's dv), e_c, dS,
// q / denom and g / denom are rounded to bf16 where the plain versions cast
// them.
//
// tiled_bwd_rows_kernel: a block of 64 query rows (16 a warp) computes s =
// q . k^T and dp = g . v^T once each, into two strips of shared memory over
// its keys; the row statistics (m, rs, sigma), dS (and e_c) come from the
// strips, and dS . k (and e_c . v) read them. Where the strips of every key
// would pass the shared memory (ops/attention.py tiled_plan), the keys go in
// windows, the statistics carried online over them and the strips recomputed
// for dS.
// tiled_bwd_keys_kernel: a block of 64 keys walks the query tiles that see
// them in tiles of 32 rows, rebuilds P and dS from the row statistics with
// the rows kernel's arithmetic (the same products, the scale rounded once:
// __fmul_rn, never contracted), and sums dk and dv in registers.
// ---------------------------------------------------------------------------

constexpr int kQK = 32;  // query rows a tile of the keys kernel
constexpr int kLdP = tc::kKT + 8;  // P and dS rows in the keys kernel: k-major A fragments

// The rows kernel's shared memory for blocks of `rows` query rows (64 or
// 128), in floats from the start: the strips of s (then dS) and dp (then
// e_c) [rows][ld_s] (strip_keys(win_tiles, S) keys a row), the q and g tiles
// [rows][ld_t] (resident when the head is one chunk), the key spans'
// partial row statistics [3][2][64], the ring's two stages (a key tile of k or v [64][ld_t], and q's or g's chunk when the
// head is wider than one chunk).
struct RowsSmem {
  int ld_t, ld_s, sd, q, g, x, stage0, stage, floats;
  __host__ __device__ RowsSmem(int rows, int dc, int win_tiles, bool streamed, int S)
      : ld_t(tc::ld_tile(dc)), ld_s(tc::ld_strip(tc::strip_keys(win_tiles, S))) {
    sd = rows * ld_s;
    q = 2 * rows * ld_s;
    g = q + (streamed ? 0 : rows * ld_t);
    x = g + (streamed ? 0 : rows * ld_t);
    stage0 = x + 3 * 2 * 64;  // the key spans' statistics (two spans of 64 rows)
    stage = tc::kKT * ld_t + (streamed ? rows * ld_t : 0);
    floats = stage0 + 2 * stage;
  }
};

// The keys kernel's: the k and v tiles [64][ld_t] (resident when the head is
// one chunk), P and dS [32][kLdP], the statistics of two query tiles
// [2][3 x 32], then the ring's two stages: the q and g tiles [32][ld_t]
// each, or when the head is wider than one chunk a chunk of k or v with q's
// or g's.
struct KeysSmem {
  int ld_t, v, p, ds, st, stage0, stage, floats;
  __host__ __device__ KeysSmem(int dc, bool streamed) : ld_t(tc::ld_tile(dc)) {
    v = streamed ? 0 : tc::kKT * ld_t;
    p = streamed ? 0 : 2 * tc::kKT * ld_t;
    ds = p + kQK * kLdP;
    st = ds + kQK * kLdP;
    stage0 = st + 2 * 3 * kQK;
    stage = streamed ? (tc::kKT + kQK) * ld_t : 2 * kQK * ld_t;
    floats = stage0 + 2 * stage;
  }
};

// The rows kernel's items, in order: for every key tile t (window by window)
// and chunk c, s over c (kind 0: k's chunk, with q's when streamed) and dp
// over c (1: v's, with g's); then for each 64-column chunk co of dq (and
// ctx): for each window, its s and dp again (only with several windows),
// then per key tile dS . k (2) and, deferred, e_c . v (3) over those
// columns.
struct RowsItem {
  int kind, t, c, co;
  bool first_walk;
};

// A block of kQR query rows, 8 warps: warp w holds the rows 16 (w % kWR) ..
// + 15 (kWR = kQR / 16 row groups) and, at 64 rows, one half of the keys of
// every tile (kKS = 2 key spans: the 4 warps of each half-block share their
// rows' statistics through shared memory, and split dq's and ctx's
// columns). A thread holds its rows' m, rs and sigma in registers (the same
// bits in every lane that shares them), and touches only the strip elements
// it wrote.
template <typename T, int kQR, int kDc, int kSched>
__global__ void __launch_bounds__(256)
tiled_bwd_rows_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ ctx,
                      T* __restrict__ dqkv, float* __restrict__ stats, int S, int heads, int D,
                      int causal, int s_valid, float scale, int win_tiles, int vec) {
  using namespace tc;
  extern __shared__ __align__(16) float sm[];
  constexpr bool kSplit = std::is_same<T, float>::value;  // fp32: three TF32 products
  constexpr bool kDef = kSched == kDeferred;
  constexpr int kNT = 256;          // threads
  constexpr int kWR = kQR / 16;     // row groups
  constexpr int kKS = 8 / kWR;      // key spans (warps a row group)
  constexpr int kSpan = kKT / kKS;  // keys of a tile a warp takes
  constexpr int kN = kSpan / 8;     // their column tiles (and dq's and ctx's)
  const int nc = (D + kDc - 1) / kDc, no = (D + kDo - 1) / kDo;
  const bool streamed = nc > 1;
  const RowsSmem L(kQR, kDc, win_tiles, streamed, S);
  float* strip_s = sm;
  float* strip_d = sm + L.sd;
  float* xs = sm + L.x;  // the key spans' partial statistics [3][kKS][kQR]
  const int W = heads * D, W3 = 3 * W;
  const int q0 = blockIdx.x * kQR, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (size_t)b * S * W3 + (size_t)h * D;
  const T* gbase = g + (size_t)b * S * W + (size_t)h * D;
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kQR);
  const int live_rows = min(kQR, S - q0);
  const int n_tiles = (n_keys + kKT - 1) / kKT;
  const int n_win = (n_tiles + win_tiles - 1) / win_tiles;
  const int n_out = kDef ? 2 : 1;  // items a key tile in the output walk
  const int n_first = 2 * nc * n_tiles;
  const int per_chunk = (n_win > 1 ? n_first : 0) + n_out * n_tiles;
  const int n_items = n_first + no * per_chunk;

  // one chunk (every tower's shape): no integer division in the first walk
  auto decode = [&](int it) {
    RowsItem x;
    if (it < n_first) {
      x.first_walk = true;
      x.t = nc == 1 ? it >> 1 : it / (2 * nc);
      x.c = nc == 1 ? 0 : (it % (2 * nc)) / 2;
      x.kind = it & 1;
      x.co = 0;
      return x;
    }
    const int r = it - n_first;
    x.first_walk = false;
    x.co = no == 1 ? 0 : r / per_chunk;
    int y = r - x.co * per_chunk;
    int t0 = 0;  // the window's first tile
    if (n_win > 1) {
      const int full = win_tiles * (2 * nc + n_out);
      const int w = y / full;
      y -= w * full;
      t0 = w * win_tiles;
      const int wt = min(win_tiles, n_tiles - t0);
      if (y < 2 * nc * wt) {
        x.t = t0 + y / (2 * nc);
        x.c = (y % (2 * nc)) / 2;
        x.kind = y % 2;
        return x;
      }
      y -= 2 * nc * wt;
    }
    x.t = t0 + (n_out == 1 ? y : y >> 1);
    x.kind = 2 + (n_out == 1 ? 0 : y & 1);
    x.c = 0;
    return x;
  };
  auto issue = [&](int it) {
    if (it < n_items) {
      const RowsItem x = decode(it);
      float* st = sm + L.stage0 + (it & 1) * L.stage;
      const T* kv = base + ((x.kind == 0 || x.kind == 2) ? W : 2 * W);  // k's tile, else v's
      if (x.kind < 2) {
        load_tile<T, kKT, kDc, kNT>(st, L.ld_t, kv, W3, x.t * kKT, S, x.c * kDc, D, vec);
        if (streamed)
          load_tile<T, kQR, kDc, kNT>(st + kKT * L.ld_t, L.ld_t, x.kind == 0 ? base : gbase,
                                      x.kind == 0 ? W3 : W, q0, S, x.c * kDc, D, vec);
      } else {
        load_tile<T, kKT, kDo, kNT>(st, L.ld_t, kv, W3, x.t * kKT, S, x.co * kDo, D, vec);
      }
    }
    hopper::cp_async_commit();
  };

  const Frag f;
  const int row0 = 16 * (f.w % kWR), ks = f.w / kWR, koff = ks * kSpan;
  auto keep = [&](int j0, int n, int e) {
    const int key = j0 + koff + f.col(n, e);
    return key < n_keys && !(causal && key > q0 + row0 + f.row(0, e));
  };
  // the live column tiles of this warp's keys of tile t
  auto live_n = [&](int t) {
    return max(0, min(kN, (min(kKT, n_keys - t * kKT) - koff + 7) / 8));
  };
  // fn(e, j0, n, s element, dp element) over the thread's strip elements of
  // window w.
  auto own = [&](int w, auto&& fn) {
    for (int t = w * win_tiles; t < min((w + 1) * win_tiles, n_tiles); ++t) {
      const int nl = live_n(t);
      const int off = row0 * L.ld_s + (t - w * win_tiles) * kKT + koff;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n < nl) {
            const int o = off + f.row(0, e) * L.ld_s + f.col(n, e);
            fn(e, t * kKT, n, strip_s[o], strip_d[o]);
          }
    }
  };
  // v (one value a row half, the same in the quad) summed, or maxed, over
  // the key spans through xs[slot]: the same bits in every span.
  auto across = [&](float (&v)[2], int slot, bool is_max) {
    if (kKS == 1) return;
    float* x = xs + slot * kKS * kQR;
    if (f.t == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) x[ks * kQR + row0 + f.g + 8 * u] = v[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = row0 + f.g + 8 * u;
      float y = x[r];
#pragma unroll
      for (int k = 1; k < kKS; ++k) y = is_max ? fmaxf(y, x[k * kQR + r]) : y + x[k * kQR + r];
      v[u] = y;
    }
  };
  // Rows g (half 0) and g + 8 (half 1): m, rs = rowsum(e) and sigma =
  // rowsum(dp o e), online over the windows (rescaled by exp(m_old -
  // m_new)); after the last window normalize-first keeps dsum = sigma / rs.
  // Key 0 is never masked: m is finite.
  float m[2], rs[2], sg[2], wmax[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    m[u] = wmax[u] = -INFINITY;
    rs[u] = sg[u] = 0.f;
  }
  auto stats_sweep = [&](int w) {
    float m_new[2], pe[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) m_new[u] = max4(wmax[u]);
    across(m_new, 0, true);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      m_new[u] = fmaxf(m[u], m_new[u]);
      wmax[u] = -INFINITY;
    }
    own(w, [&](int e, int j0, int n, float& sv, float& dv) {
      if (keep(j0, n, e)) {
        const float x = expf(__fmul_rn(sv, scale) - m_new[e >> 1]);
        pe[e >> 1] += x;
        pd[e >> 1] += dv * x;
      }
    });
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      pe[u] = sum4(pe[u]);
      pd[u] = sum4(pd[u]);
    }
    across(pe, 1, false);
    across(pd, 2, false);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float a = expf(m[u] - m_new[u]);
      rs[u] = rs[u] * a + pe[u];
      sg[u] = sg[u] * a + pd[u];
      m[u] = m_new[u];
      if (kSched == kNormalizeFirst && w == n_win - 1) sg[u] /= rs[u];
    }
  };
  // dS = cast(w o (dp - sub)) over window w in place of s, w = P
  // (normalize-first) or e (deferred; e_c = cast(e) in place of dp), zero
  // where masked.
  auto ds_sweep = [&](int w) {
    own(w, [&](int e, int j0, int n, float& sv, float& dv) {
      float ds = 0.f, ec = 0.f;
      if (keep(j0, n, e)) {
        const int u = e >> 1;
        const float x = expf(__fmul_rn(sv, scale) - m[u]);
        const float wgt = kSched == kNormalizeFirst ? x / rs[u] : x;
        const float sub = kSched == kNormalizeFirst ? sg[u] : sg[u] / rs[u];
        ds = round_to<T>(wgt * (dv - sub));
        ec = round_to<T>(x);
      }
      sv = ds;
      if (kDef) dv = ec;
    });
  };

  if (!streamed) {  // with the first item's copies
    load_tile<T, kQR, kDc, kNT>(sm + L.q, L.ld_t, base, W3, q0, S, 0, D, vec);
    load_tile<T, kQR, kDc, kNT>(sm + L.g, L.ld_t, gbase, W, q0, S, 0, D, vec);
  }
  issue(0);

  const bool live = row0 < live_rows;
  float acc_s[1][kN][4], acc_d[1][kN][4], acc_q[1][kN][4], acc_c[1][kN][4], acc_t[1][kN][4];
  for (int it = 0; it < n_items; ++it) {
    hopper::cp_async_wait<0>();
    __syncthreads();
    issue(it + 1);
    const RowsItem x = decode(it);
    const float* st = sm + L.stage0 + (it & 1) * L.stage;
    const int w = n_win == 1 ? 0 : x.t / win_tiles, toff = (x.t - w * win_tiles) * kKT;
    const int live_keys = min(kKT, n_keys - x.t * kKT);
    const int nl = live_n(x.t);
    if (x.kind < 2) {
      const float* a = (streamed ? st + kKT * L.ld_t : sm + (x.kind == 0 ? L.q : L.g)) +
                       row0 * L.ld_t;
      const float* bk = st + koff * L.ld_t;  // this warp's keys
      if (x.kind == 0) {
        if (x.c == 0) zero(acc_s);
        if (live && nl)
          warp_mma_nt<1, kN, kSplit>(acc_s, a, L.ld_t, bk, L.ld_t, chunk_k(D, x.c, kDc), nl);
        continue;
      }
      if (x.c == 0) zero(acc_d);
      if (live && nl)
        warp_mma_nt<1, kN, kSplit>(acc_d, a, L.ld_t, bk, L.ld_t, chunk_k(D, x.c, kDc), nl);
      if (x.c < nc - 1) continue;
      const int off = row0 * L.ld_s + toff + koff;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n < nl) {
            const int o = off + f.row(0, e) * L.ld_s + f.col(n, e);
            strip_s[o] = acc_s[0][n][e];
            strip_d[o] = acc_d[0][n][e];
            if (x.first_walk && keep(x.t * kKT, n, e))
              wmax[e >> 1] = fmaxf(wmax[e >> 1], __fmul_rn(acc_s[0][n][e], scale));
          }
      if (x.t != min((w + 1) * win_tiles, n_tiles) - 1) continue;
      if (x.first_walk) {
        stats_sweep(w);
        if (n_win > 1) continue;
      }
      ds_sweep(w);
      continue;
    }
    // this tile's dS . k (or e_c . v) over this warp's columns koff .. of
    // the chunk, into a fresh accumulator, added in IEEE fp32
    zero(acc_t);
    const float* a = (x.kind == 2 ? strip_s : strip_d) + row0 * L.ld_s + toff;
    if (live)
      warp_mma<false, false, 1, kN, kSplit>(acc_t, a, L.ld_s, st + koff, L.ld_t,
                                            (live_keys + 7) & ~7, kN);
    if (x.kind == 2) {
      if (x.t == 0) zero(acc_q);
      add(acc_q, acc_t);
    } else {
      if (x.t == 0) zero(acc_c);
      add(acc_c, acc_t);
    }
    if (x.t != n_tiles - 1 || x.kind != 1 + n_out) continue;
    // columns co * 64 + koff .. of dq = dS . k * scale (deferred / rs) and
    // ctx = (e_c . v) / rs
    const size_t r0 = (size_t)b * S + q0 + row0;
    const int c0 = x.co * kDo + koff;
    T* dq = dqkv + r0 * W3 + (size_t)h * D + c0;
    T* cx = kDef ? ctx + r0 * W + (size_t)h * D + c0 : nullptr;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(0, e), c = f.col(n, e), u = e >> 1;
        if (row0 + r >= live_rows || c0 + c >= D) continue;
        const float y = acc_q[0][n][e] * scale;
        dq[(size_t)r * W3 + c] = from_f<T>(kDef ? y / rs[u] : y);
        if (kDef) cx[(size_t)r * W + c] = from_f<T>(acc_c[0][n][e] / rs[u]);
      }
  }
  hopper::cp_async_wait<0>();
  if (f.t == 0 && ks == 0) {  // one lane of each quad of the first span: its rows' statistics
    const size_t bhs = (size_t)gridDim.z * heads * S;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = row0 + f.g + 8 * u;
      if (r >= live_rows) continue;
      const size_t o = ((size_t)b * heads + h) * S + q0 + r;
      stats[o] = m[u];
      stats[bhs + o] = rs[u];
      stats[2 * bhs + o] = sg[u];
    }
  }
}

// The keys kernel's items: one a query tile (q, g and the tile's statistics)
// when the head is one chunk; otherwise for each chunk co of dk and dv, for
// each query tile: s over each chunk c (kind 0: k's and q's chunk c), dp over
// each (1: v's and g's), then the products (2: q's and g's chunk co).
struct KeysItem {
  int kind, qt, c, co, group;
};

// Keys k0 .. k0 + 63 of (sequence b, head h), the rows of dk and dv; 4 warps
// for each 64 columns of the chunk (kDc / 16 warps): warp w holds the keys
// 16 (w % 4) .. and the columns 64 (w / 4) .. of dk and dv, and a share of
// the query tile's s and dp (rows 16 (w % 2) .., the keys (w / 2) * span ..).
// The query tiles before the key tile see none of its keys when causal; keys
// at or past s_valid get dk = dv = 0.
template <typename T, int kDc, int kSched>
__global__ void __launch_bounds__(kDc * 2)
tiled_bwd_keys_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                      const float* __restrict__ stats, int S, int heads, int D, int causal,
                      int s_valid, float scale, int vec) {
  using namespace tc;
  extern __shared__ __align__(16) float sm[];
  constexpr int kNT = kDc * 2;                  // threads: 4 warps for each 64 columns
  constexpr int kNW = kNT / 32;                 // warps
  constexpr int kSpan = kKT / (kNW / 2);        // keys of s and dp a warp
  constexpr int kSN = kSpan / 8;                // their column tiles
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr bool kDef = kSched == kDeferred;
  const int nc = (D + kDc - 1) / kDc;
  const bool streamed = nc > 1;
  const KeysSmem L(kDc, streamed);
  const int W = heads * D, W3 = 3 * W;
  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (size_t)b * S * W3 + (size_t)h * D;
  const T* gbase = g + (size_t)b * S * W + (size_t)h * D;
  const size_t bhs = (size_t)gridDim.z * heads * S, so = ((size_t)b * heads + h) * S;
  const int n_keys = min(S, s_valid);
  const int live_keys = min(kKT, S - k0);
  const int qt0 = causal ? k0 / kQK : 0;
  const int n_qt = k0 < n_keys ? (S + kQK - 1) / kQK - qt0 : 0;
  const int per_qt = streamed ? 2 * nc + 1 : 1;
  const int n_items = n_qt * per_qt * nc;  // nc = 1 when not streamed

  auto decode = [&](int it) {
    KeysItem x;
    if (!streamed) {  // one item a query tile: no integer division
      x.group = it;
      x.co = x.c = 0;
      x.qt = qt0 + it;
      x.kind = 2;
      return x;
    }
    x.group = it / per_qt;  // (co, query tile)
    x.co = x.group / max(n_qt, 1);
    x.qt = qt0 + x.group % max(n_qt, 1);
    const int y = it % per_qt;
    if (!streamed || y == 2 * nc) {
      x.kind = 2;
      x.c = x.co;
    } else {
      x.kind = y / nc;
      x.c = y % nc;
    }
    return x;
  };
  auto issue = [&](int it) {
    if (it < n_items) {
      const KeysItem x = decode(it);
      float* st = sm + L.stage0 + (it & 1) * L.stage;
      const int q0 = x.qt * kQK;
      if (x.kind == 2) {  // q and g
        load_tile<T, kQK, kDc, kNT>(st, L.ld_t, base, W3, q0, S, x.c * kDc, D, vec);
        load_tile<T, kQK, kDc, kNT>(st + kQK * L.ld_t, L.ld_t, gbase, W, q0, S, x.c * kDc, D,
                                    vec);
      } else {  // k (with q) or v (with g)
        load_tile<T, kKT, kDc, kNT>(st, L.ld_t, base + (x.kind == 0 ? W : 2 * W), W3, k0, S,
                                    x.c * kDc, D, vec);
        load_tile<T, kQK, kDc, kNT>(st + kKT * L.ld_t, L.ld_t, x.kind == 0 ? base : gbase,
                                    x.kind == 0 ? W3 : W, q0, S, x.c * kDc, D, vec);
      }
      if ((!streamed || it % per_qt == 0) && threadIdx.x < 3 * kQK) {  // the tile's m, rs, sigma (or dsum)
        const int k = threadIdx.x / kQK, r = threadIdx.x % kQK, i = q0 + r;
        const bool ok = i < S;
        hopper::cp_async4(hopper::smem_u32(sm + L.st + (x.group & 1) * 3 * kQK + threadIdx.x),
                          stats + k * bhs + so + (ok ? i : 0), ok);
      }
    }
    hopper::cp_async_commit();
  };

  if (!streamed && n_items > 0) {
    load_tile<T, kKT, kDc, kNT>(sm, L.ld_t, base + W, W3, k0, S, 0, D, vec);
    load_tile<T, kKT, kDc, kNT>(sm + L.v, L.ld_t, base + 2 * W, W3, k0, S, 0, D, vec);
  }
  issue(0);

  const Frag f;
  const int srow = 16 * (f.w & 1), skey = (f.w >> 1) * kSpan;  // this warp's share of s, dp
  const int krow = 16 * (f.w & 3), kcol = 64 * (f.w >> 2);     // ... and of dk, dv
  // s and dp's live column tiles in this warp's keys
  const int snl = max(0, min(kSN, (min(kKT, n_keys - k0) - skey + 7) / 8));
  float* P = sm + L.p;
  float* DS = sm + L.ds;
  float acc_s[1][kSN][4], acc_d[1][kSN][4], acc_k[1][8][4], acc_v[1][8][4], acc_t[1][8][4];
  zero(acc_k);
  zero(acc_v);
  for (int it = 0; it < n_items; ++it) {
    hopper::cp_async_wait<0>();
    __syncthreads();
    issue(it + 1);
    const KeysItem x = decode(it);
    float* st = sm + L.stage0 + (it & 1) * L.stage;
    const int q0 = x.qt * kQK, live_q = min(kQK, S - q0);
    const float* stt = sm + L.st + (x.group & 1) * 3 * kQK;  // m, rs, sigma
    const bool slive = srow < live_q;
    if (!streamed) {  // s and dp of the query tile
      zero(acc_s);
      zero(acc_d);
      if (slive) {
        const int nk = chunk_k(D, 0, kDc);
        warp_mma_nt<1, kSN, kSplit>(acc_s, st + srow * L.ld_t, L.ld_t,
                                              sm + skey * L.ld_t, L.ld_t, nk, snl);
        warp_mma_nt<1, kSN, kSplit>(acc_d, st + (kQK + srow) * L.ld_t, L.ld_t,
                                              sm + L.v + skey * L.ld_t, L.ld_t, nk, snl);
      }
    } else if (x.kind < 2) {
      if (x.c == 0) {
        if (x.kind == 0) zero(acc_s);
        else zero(acc_d);
      }
      if (slive) {
        const int nk = chunk_k(D, x.c, kDc);
        const float* a = st + (kKT + srow) * L.ld_t;
        if (x.kind == 0)
          warp_mma_nt<1, kSN, kSplit>(acc_s, a, L.ld_t, st + skey * L.ld_t, L.ld_t,
                                                nk, snl);
        else
          warp_mma_nt<1, kSN, kSplit>(acc_d, a, L.ld_t, st + skey * L.ld_t, L.ld_t,
                                                nk, snl);
      }
      if (x.kind == 0 || x.c < nc - 1) continue;
    }
    if (!streamed || x.kind == 1) {
      // P^T's and dS^T's rows: w = P (normalize-first) or e (deferred), dS =
      // w o (dp - sub), from the query rows' statistics as the rows kernel
      // took them; every element of the warp's share, zero where masked
#pragma unroll
      for (int n = 0; n < kSN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = srow + f.row(0, e), c = skey + f.col(n, e);
          const int qi = q0 + r, kj = k0 + c;
          float p = 0.f, ds = 0.f;
          if (qi < S && kj < n_keys && !(causal && kj > qi)) {
            const float mi = stt[r], rsi = stt[kQK + r], sgi = stt[2 * kQK + r];
            const float x = expf(__fmul_rn(acc_s[0][n][e], scale) - mi);
            const float wgt = kSched == kNormalizeFirst ? x / rsi : x;
            const float sub = kSched == kNormalizeFirst ? sgi : sgi / rsi;
            p = round_to<T>(wgt);
            ds = round_to<T>(wgt * (acc_d[0][n][e] - sub));
          }
          P[r * kLdP + c] = p;
          DS[r * kLdP + c] = ds;
        }
      if (streamed) continue;  // the products come with the next item
    }
    // dv += P^T . g (deferred: cast(g / rs)), dk += dS^T . q (cast(q / rs)),
    // each query tile's product in a fresh accumulator, added in IEEE fp32
    float* qn = st;
    float* gn = st + kQK * L.ld_t;
    if (kDef) {
      __syncthreads();  // every thread's reads of q and g above are done
      for (int i = threadIdx.x; i < kQK * kDc; i += kNT) {
        const int r = i / kDc, c = i % kDc;
        const float d = r < live_q ? stt[kQK + r] : 1.f;
        qn[r * L.ld_t + c] = r < live_q ? round_to<T>(qn[r * L.ld_t + c] / d) : 0.f;
        gn[r * L.ld_t + c] = r < live_q ? round_to<T>(gn[r * L.ld_t + c] / d) : 0.f;
      }
    }
    __syncthreads();  // P, dS (and q / rs, g / rs) are in
    if (krow < live_keys && kcol < D - x.co * kDc) {
      const int nk = (live_q + 7) & ~7;
      zero(acc_t);
      warp_mma<true, false, 1, 8, kSplit>(acc_t, P + krow, kLdP, gn + kcol, L.ld_t, nk, 8);
      add(acc_v, acc_t);
      zero(acc_t);
      warp_mma<true, false, 1, 8, kSplit>(acc_t, DS + krow, kLdP, qn + kcol, L.ld_t, nk, 8);
      add(acc_k, acc_t);
    }
    if (x.qt - qt0 != n_qt - 1) continue;
    // the last query tile of chunk co: store it
    T* out = dqkv + ((size_t)b * S + k0 + krow) * W3 + (size_t)h * D + x.co * kDc + kcol;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(0, e), c = f.col(n, e);
        if (krow + r >= live_keys || x.co * kDc + kcol + c >= D) continue;
        out[(size_t)r * W3 + W + c] = from_f<T>(acc_k[0][n][e] * scale);
        out[(size_t)r * W3 + 2 * W + c] = from_f<T>(acc_v[0][n][e]);
      }
    zero(acc_k);
    zero(acc_v);
  }
  hopper::cp_async_wait<0>();
  if (n_items == 0) {  // keys no query row sees (past s_valid): dk = dv = 0
    T* out = dqkv + ((size_t)b * S + k0) * W3 + (size_t)h * D;
    for (int i = threadIdx.x; i < live_keys * D; i += kNT) {
      const int r = i / D, c = i % D;
      out[(size_t)r * W3 + W + c] = from_f<T>(0.f);
      out[(size_t)r * W3 + 2 * W + c] = from_f<T>(0.f);
    }
  }
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

template <int kSched>
cudaError_t launch_wgmma(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats,
                         int B, int S, int heads, int causal, int s_valid,
                         cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(g) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 4 || reinterpret_cast<uintptr_t>(dqkv) % 4)
    return cudaErrorMisalignedAddress;
  static int rows_ready[tc::kMaxDevices], keys_ready[tc::kMaxDevices];
  cudaError_t err = tc::allow_smem(core_bwd_rows<kSched>, rows_ready);
  if (err != cudaSuccess) return err;
  err = tc::allow_smem(core_bwd_keys<kSched>, keys_ready);
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

// fp32, and bf16 at another head_dim, on the TF32 products: kQR and
// win_tiles are the caller's plan for the rows kernel.
template <typename T, int kQR, int kDc, int kSched>
cudaError_t launch_tiled(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats,
                         int B, int S, int heads, int D, int causal, int s_valid, int win_tiles,
                         cudaStream_t stream) {
  static int rows_ready[tc::kMaxDevices], keys_ready[tc::kMaxDevices];
  cudaError_t err = tc::allow_smem(tiled_bwd_rows_kernel<T, kQR, kDc, kSched>, rows_ready);
  if (err != cudaSuccess) return err;
  err = tc::allow_smem(tiled_bwd_keys_kernel<T, kDc, kSched>, keys_ready);
  if (err != cudaSuccess) return err;
  const bool streamed = D > kDc;
  const size_t rows_bytes = sizeof(float) * RowsSmem(kQR, kDc, win_tiles, streamed, S).floats;
  const size_t keys_bytes = sizeof(float) * KeysSmem(kDc, streamed).floats;
  if (rows_bytes > (size_t)tc::kMaxSmem || keys_bytes > (size_t)tc::kMaxSmem)
    return cudaErrorInvalidValue;
  // 16-byte copies: D (hence W, 3W and each head's first column) a multiple
  // of 4, and both operands 16-byte aligned
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  const T* q = static_cast<const T*>(qkv);
  const T* gr = static_cast<const T*>(g);
  T* dq = static_cast<T*>(dqkv);
  tiled_bwd_rows_kernel<T, kQR, kDc, kSched>
      <<<dim3((S + kQR - 1) / kQR, heads, B), 256, rows_bytes, stream>>>(
          q, gr, static_cast<T*>(ctx), dq, stats, S, heads, D, causal, s_valid, scale,
          win_tiles, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_bwd_keys_kernel<T, kDc, kSched>
      <<<dim3((S + tc::kKT - 1) / tc::kKT, heads, B), kDc * 2, keys_bytes, stream>>>(
          q, gr, dq, stats, S, heads, D, causal, s_valid, scale, vec);
  return cudaGetLastError();
}

template <typename T, int kSched>
cudaError_t launch_plan(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats,
                        int B, int S, int heads, int D, int causal, int s_valid, int rows,
                        int win_tiles, cudaStream_t s) {
#define PLIP_TILED(R, DC)                                                                  \
  launch_tiled<T, R, DC, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, D, causal, s_valid, \
                                 win_tiles, s)
  // the chunk: 64 columns up to head_dim 64, 128 above (wider heads in chunks)
  if (rows == 128) return D <= 64 ? PLIP_TILED(128, 64) : PLIP_TILED(128, 128);
  if (rows == 64) return D <= 64 ? PLIP_TILED(64, 64) : PLIP_TILED(64, 128);
#undef PLIP_TILED
  return cudaErrorInvalidValue;
}

template <int kSched>
int run(const void* qkv, const void* g, void* ctx, void* dqkv, float* stats, int B, int S,
        int heads, int head_dim, int causal, int s_valid, int rows, int win_tiles, int dtype,
        int device, void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || heads > 65535 || S <= 0 || s_valid < 1 ||
      s_valid > S || head_dim <= 0 || win_tiles < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_plan<float, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, head_dim, causal,
                                      s_valid, rows, win_tiles, s);
  if (dtype == kBF16) {
    if (head_dim == 64)
      return launch_wgmma<kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, causal, s_valid, s);
    return launch_plan<bf16, kSched>(qkv, g, ctx, dqkv, stats, B, S, heads, head_dim, causal,
                                     s_valid, rows, win_tiles, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry point takes the plan of the TF32 rows kernel (ops/attention.py
// tiled_plan): the query rows of a block (64 or 128) and the key tiles of a
// window; bf16 at head_dim 64 (wgmma) ignores both. Each instantiates every
// kernel above in its own schedule, so the two are compiled as two
// translation units, in parallel: this file, and csrc/attn_core_bwd_tiled.cu,
// which includes it with PLIP_MHA_BWD_DEFERRED defined.

extern "C" {

#ifndef PLIP_MHA_BWD_DEFERRED
// K4: dqkv of mha_core, normalize-first, S <= 512. stats: fp32 scratch
// [3, B, heads, S].
int plip_mha_core_bwd(const void* qkv, const void* g, void* dqkv, float* stats, int B,
                      int S, int heads, int head_dim, int causal, int s_valid, int rows,
                      int win_tiles, int dtype, int device, void* stream) {
  if (S > 512) return cudaErrorInvalidValue;
  return run<kNormalizeFirst>(qkv, g, nullptr, dqkv, stats, B, S, heads, head_dim, causal,
                              s_valid, rows, win_tiles, dtype, device, stream);
}
#else
// K2's core past S = 128: the recomputed ctx and dqkv, deferred divide.
int plip_attn_core_bwd_tiled(const void* qkv, const void* dctx, void* ctx, void* dqkv,
                             float* stats, int B, int S, int heads, int head_dim,
                             int causal, int s_valid, int rows, int win_tiles, int dtype,
                             int device, void* stream) {
  return run<kDeferred>(qkv, dctx, ctx, dqkv, stats, B, S, heads, head_dim, causal, s_valid,
                        rows, win_tiles, dtype, device, stream);
}
#endif

}  // extern "C"
