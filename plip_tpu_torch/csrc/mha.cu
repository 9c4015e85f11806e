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
// a block holds one (sequence, head, tile of query rows), grid (q tiles,
// heads, B), and streams k and v through shared memory in 64-key tiles. P
// is rounded exactly where the TPU kernels round it, against the exact row
// max m, so kernel and plain version agree to about one ulp.
//
// bf16 at head_dim 64 runs on one warpgroup, 64 query rows a block, two
// passes over the key tiles, each recomputing s = q . k^T:
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
// (sequence, head) against 8 S D bytes of qkv: compute-bound. bf16 runs both
// dots on wgmma m64n64k16 (csrc/wgmma.cuh), q . k^T with both tiles in shared
// memory, P . v with P straight from the logits' registers (cast and
// repacked: no shared-memory round trip); the softmax runs on those
// registers, a row's reduction the thread's 16 values and two quad shuffles;
// k and v tiles arrive by cp.async into a two-stage ring with the 128-byte
// swizzle, the next tile in flight while this one is computed. At D = 64 the
// exponentials (one or two a logit, expf, on the 16 a clock of the SM's
// special-function units) weigh as much as the dots there.
//
// fp32 (the dtype PLIP and CLIPTuner take by default: ViT-L/14 serving and
// every fp32 wide-tower training step run this) and bf16 at any other
// head_dim run tiled_fwd_kernel, on the tensor cores' TF32 products of
// csrc/tf32_attn.cuh (mma.sync m16n8k8; fp32 as three products, the split
// PyTorch's fp32 SDPA takes, bf16 as one exact product). A block of 64
// query rows, 8 warps (two to a row group, each half the keys of a tile),
// computes its logits once into a strip of shared memory over its keys (64
// x 292 floats at S = 257); the exact max, the sum and P come from the
// strip (each thread its own elements, a row's statistics over a quad and
// the two warps that split its keys), and P . v reads P from it. k and v come through a
// two-stage cp.async ring. The last query tile and key tile skip their
// dead rows a warp at a time and their dead keys 8 at a time, so the
// one-row tails of S = 257 and 577 cost about their live work. The plan
// (rows, key tiles a window) is the caller's, ops/attention.py tiled_plan:
// where every key's strip would pass the shared memory (past about 900
// tokens at head_dim 64; K5 and K12 take any S) the keys go in windows and the logits are computed
// twice, once for the row max (and sum) and once for P. A head wider than
// 128 goes in 128-column chunks: the logits sum over the chunks (q's chunk
// streamed with k's), the context goes out 64 columns at a time. No size
// has an upper limit. What bounds it: 4 S^2 D FLOPs against 16 S D bytes
// (fp32), the FLOPs; at D = 64 the exponentials and the fp32 TF32 splits
// (three instructions an operand value) weigh about as much as the
// products, and a block of 8 warps, one an SM at these strips, hides the
// products' latency behind its other warps only.
//
// Entry points launch on the stream they are given, allocate nothing, and
// return cudaGetLastError() (or cudaErrorInvalidValue for arguments they do
// not take, cudaErrorMisalignedAddress for bf16 data not 16-byte aligned) so
// the caller can raise.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tf32_attn.cuh"
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
// fp32, and bf16 at a head_dim other than 64, on the TF32 products of
// csrc/tf32_attn.cuh. The logits of the block's 64 query rows over its keys
// are computed once, into a strip of shared memory: the exact row max, the
// row sum and P are taken from the strip, and P . v reads P from it. Where
// the strip of every key would pass the shared memory (the caller's plan:
// ops/attention.py tiled_plan), the keys go in windows of win_tiles key
// tiles: a first walk takes each window's logits for the max (and
// normalize-first the sum, carried online), a second recomputes each
// window's logits for P and P . v. bf16 values load exactly, and P (and
// K3's, K5's and K12's q * D^-1/2) is rounded to bf16 where the plain
// versions cast them.
// ---------------------------------------------------------------------------

// Shared memory of a block of `rows` query rows, in floats from the start: the strip [rows][ld_s] (strip_keys(win_tiles, S) keys a row),
// the q tile [rows][ld_t] (resident when the head is one chunk), the key
// spans' partial row statistics [2][2][64], the ring's two stages (a key tile of k or v [64][ld_t], and q's
// chunk when the head is wider than one chunk).
struct FwdSmem {
  int ld_t, ld_s, q, x, stage0, stage, floats;
  __host__ __device__ FwdSmem(int rows, int dc, int win_tiles, bool streamed, int S)
      : ld_t(tc::ld_tile(dc)), ld_s(tc::ld_strip(tc::strip_keys(win_tiles, S))) {
    q = rows * ld_s;
    x = q + (streamed ? 0 : rows * ld_t);
    stage0 = x + 2 * 2 * 64;  // the key spans' statistics (two spans of 64 rows)
    stage = tc::kKT * ld_t + (streamed ? rows * ld_t : 0);
    floats = stage0 + 2 * stage;
  }
};

// The ring's items, in order: for every key tile t (window by window) and
// chunk c, the logits of t over c (k's chunk, with q's when streamed); then
// for each 64-column chunk co of the context: for each window, its logits
// again (only with several windows), then P . v over its tiles (those
// columns of v).
struct FwdItem {
  bool logit, first_walk;
  int t, c, co;
};

// One block: query rows q0 .. q0 + 63 of (sequence b, head h), 8 warps:
// warp w holds the rows 16 (w % 4) .. + 15 and one half of the keys of
// every tile (two key spans, which share their rows' statistics through
// shared memory and split the context's columns). A thread holds its rows'
// max and sum in registers (the same bits in every lane that shares them)
// and touches only the strip elements it wrote.
constexpr int kFwdRows = 64;  // query rows a block of tiled_fwd_kernel

template <typename T, int kDc, bool kScaleAfter>
__global__ void __launch_bounds__(256)
tiled_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int S, int heads, int D,
                 int causal, int s_valid, int defer, float scale, int win_tiles, int vec) {
  using namespace tc;
  extern __shared__ __align__(16) float sm[];
  constexpr bool kSplit = std::is_same<T, float>::value;  // fp32: three TF32 products
  constexpr int kNT = 256;          // threads
  constexpr int kRows = kFwdRows;
  constexpr int kWR = kRows / 16;   // row groups
  constexpr int kKS = 8 / kWR;      // key spans (warps a row group)
  constexpr int kSpan = kKT / kKS;  // keys of a tile (and context columns) a warp takes
  constexpr int kN = kSpan / 8;     // their column tiles
  const int nc = (D + kDc - 1) / kDc, no = (D + kDo - 1) / kDo;
  const bool streamed = nc > 1;
  const FwdSmem L(kRows, kDc, win_tiles, streamed, S);
  float* strip = sm;
  float* xs = sm + L.x;  // the key spans' partial statistics [2][kKS][kRows]
  const int W = heads * D, W3 = 3 * W;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (size_t)b * S * W3 + (size_t)h * D;
  int n_keys = min(S, s_valid);
  if (causal) n_keys = min(n_keys, q0 + kRows);
  const int live_rows = min(kRows, S - q0);
  const int n_tiles = (n_keys + kKT - 1) / kKT;
  const int n_win = (n_tiles + win_tiles - 1) / win_tiles;
  const int n_first = n_tiles * nc;
  const int per_chunk = (n_win > 1 ? n_tiles * nc : 0) + n_tiles;
  const int n_items = n_first + no * per_chunk;
  const float qmul = kScaleAfter ? 1.f : scale;

  // one chunk and one window (every tower's shape): no integer division
  const bool plain_items = nc == 1 && n_win == 1;
  auto decode = [&](int it) {
    FwdItem x;
    if (it < n_first) {
      x.logit = x.first_walk = true;
      x.t = plain_items ? it : it / nc;
      x.c = plain_items ? 0 : it % nc;
      x.co = 0;
      return x;
    }
    const int r = it - n_first;
    x.first_walk = false;
    x.co = no == 1 ? 0 : r / per_chunk;
    int y = r - x.co * per_chunk;
    if (n_win == 1) {
      x.logit = false;
      x.t = y;
      x.c = 0;
      return x;
    }
    const int w = y / (win_tiles * (nc + 1));
    y -= w * win_tiles * (nc + 1);
    const int wt = min(win_tiles, n_tiles - w * win_tiles);
    x.logit = y < wt * nc;
    x.t = w * win_tiles + (x.logit ? y / nc : y - wt * nc);
    x.c = x.logit ? y % nc : 0;
    return x;
  };
  auto issue = [&](int it) {
    if (it < n_items) {
      const FwdItem x = decode(it);
      float* st = sm + L.stage0 + (it & 1) * L.stage;
      if (x.logit) {
        load_tile<T, kKT, kDc, kNT>(st, L.ld_t, base + W, W3, x.t * kKT, S, x.c * kDc, D, vec);
        if (streamed)
          load_tile_scaled<T, kRows, kDc, kNT>(st + kKT * L.ld_t, L.ld_t, base, W3, q0, S,
                                               x.c * kDc, D, qmul);
      } else {
        load_tile<T, kKT, kDo, kNT>(st, L.ld_t, base + 2 * W, W3, x.t * kKT, S, x.co * kDo, D,
                                    vec);
      }
    }
    hopper::cp_async_commit();  // empty past the last item: the count stays uniform
  };
  auto logit = [&](float x) { return kScaleAfter ? __fmul_rn(x, scale) : x; };

  const Frag f;
  const int row0 = 16 * (f.w % kWR), ks = f.w / kWR, koff = ks * kSpan;
  // Whether element e of column tile n (of this warp's keys of the tile at
  // key j0) is a live key of its row.
  auto keep = [&](int j0, int n, int e) {
    const int key = j0 + koff + f.col(n, e);
    return key < n_keys && !(causal && key > q0 + row0 + f.row(0, e));
  };
  // the live column tiles of this warp's keys of tile t
  auto live_n = [&](int t) {
    return max(0, min(kN, (min(kKT, n_keys - t * kKT) - koff + 7) / 8));
  };
  // fn(e, j0, n, element) over the thread's strip elements of window w.
  auto own = [&](int w, auto&& fn) {
    for (int t = w * win_tiles; t < min((w + 1) * win_tiles, n_tiles); ++t) {
      const int nl = live_n(t);
      float* col = strip + row0 * L.ld_s + (t - w * win_tiles) * kKT + koff;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n < nl) fn(e, t * kKT, n, col[f.row(0, e) * L.ld_s + f.col(n, e)]);
    }
  };
  // v (one value a row half, the same in the quad) summed, or maxed, over
  // the key spans through xs[slot]: the same bits in every span.
  auto across = [&](float (&v)[2], int slot, bool is_max) {
    if (kKS == 1) return;
    float* x = xs + slot * kKS * kRows;
    if (f.t == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) x[ks * kRows + row0 + f.g + 8 * u] = v[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = row0 + f.g + 8 * u;
      float y = x[r];
#pragma unroll
      for (int k = 1; k < kKS; ++k) y = is_max ? fmaxf(y, x[k * kRows + r]) : y + x[k * kRows + r];
      v[u] = y;
    }
  };
  // Rows g (half 0) and g + 8 (half 1): max m (over the first walk's
  // windows), sum rs (normalize-first: online over the windows, rescaled by
  // exp(m_old - m_new); deferred: of the uncast e in the context's first
  // chunk), the window max.
  float m[2], rs[2], wmax[2], part[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    m[u] = wmax[u] = -INFINITY;
    rs[u] = part[u] = 0.f;
  }
  // The first walk's statistics of window w; key 0 is never masked, so m is
  // finite from the first window on.
  auto stats = [&](int w) {
    float m_new[2], s[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) m_new[u] = max4(wmax[u]);
    across(m_new, 0, true);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      m_new[u] = fmaxf(m[u], m_new[u]);
      wmax[u] = -INFINITY;
    }
    if (!defer) {
      own(w, [&](int e, int j0, int n, float& v) {
        if (keep(j0, n, e)) s[e >> 1] += expf(logit(v) - m_new[e >> 1]);
      });
#pragma unroll
      for (int u = 0; u < 2; ++u) s[u] = sum4(s[u]);
      across(s, 1, false);
#pragma unroll
      for (int u = 0; u < 2; ++u) rs[u] = rs[u] * expf(m[u] - m_new[u]) + s[u];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) m[u] = m_new[u];
  };
  // P over window w in place of its logits, zero where masked: cast(e / rs)
  // normalize-first, cast(e) deferred (the uncast e summed when `sum`).
  auto p_sweep = [&](int w, bool sum) {
    own(w, [&](int e, int j0, int n, float& v) {
      float p = 0.f;
      if (keep(j0, n, e)) {
        const float x = expf(logit(v) - m[e >> 1]);
        if (sum) part[e >> 1] += x;
        p = round_to<T>(defer ? x : x / rs[e >> 1]);
      }
      v = p;
    });
    if (defer && sum && w == n_win - 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) rs[u] = sum4(part[u]);
      across(rs, 1, false);
    }
  };

  if (!streamed)
    load_tile_scaled<T, kRows, kDc, kNT>(sm + L.q, L.ld_t, base, W3, q0, S, 0, D, qmul);
  issue(0);

  const bool live = row0 < live_rows;  // the warp holds live rows
  float acc_s[1][kN][4], acc_o[1][kN][4], acc_t[1][kN][4];
  for (int it = 0; it < n_items; ++it) {
    hopper::cp_async_wait<0>();  // item it has landed (this thread's copies)
    __syncthreads();             // everyone's; the stage of item it - 1 is free
    issue(it + 1);
    const FwdItem x = decode(it);
    const float* st = sm + L.stage0 + (it & 1) * L.stage;
    const int w = n_win == 1 ? 0 : x.t / win_tiles, toff = (x.t - w * win_tiles) * kKT;
    const int live_keys = min(kKT, n_keys - x.t * kKT);
    const int nl = live_n(x.t);
    if (x.logit) {
      if (x.c == 0) zero(acc_s);
      const float* q = (streamed ? st + kKT * L.ld_t : sm + L.q) + row0 * L.ld_t;
      if (live && nl)
        warp_mma_nt<1, kN, kSplit>(acc_s, q, L.ld_t, st + koff * L.ld_t, L.ld_t,
                                   chunk_k(D, x.c, kDc), nl);
      if (x.c < nc - 1) continue;
      float* out = strip + row0 * L.ld_s + toff + koff;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n < nl) {
            out[f.row(0, e) * L.ld_s + f.col(n, e)] = acc_s[0][n][e];
            if (x.first_walk && keep(x.t * kKT, n, e))
              wmax[e >> 1] = fmaxf(wmax[e >> 1], logit(acc_s[0][n][e]));
          }
      if (x.t != min((w + 1) * win_tiles, n_tiles) - 1) continue;
      if (x.first_walk) {
        stats(w);
        if (n_win > 1) continue;
      }
      p_sweep(w, x.first_walk || x.co == 0);
      continue;
    }
    // this tile's P . v over this warp's columns koff .. of the chunk, into a
    // fresh accumulator, added in IEEE fp32
    zero(acc_t);
    if (live)
      warp_mma<false, false, 1, kN, kSplit>(acc_t, strip + row0 * L.ld_s + toff, L.ld_s,
                                            st + koff, L.ld_t, (live_keys + 7) & ~7, kN);
    if (x.t == 0) zero(acc_o);
    add(acc_o, acc_t);
    if (x.t != n_tiles - 1) continue;
    // the context's columns co * 64 + koff .. (deferred: over the row sum, final by now)
    const int c0 = x.co * kDo + koff;
    T* out = ctx + ((size_t)b * S + q0 + row0) * W + (size_t)h * D + c0;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(0, e), c = f.col(n, e);
        if (row0 + r < live_rows && c0 + c < D)
          out[(size_t)r * W + c] = from_f<T>(defer ? acc_o[0][n][e] / rs[e >> 1] : acc_o[0][n][e]);
      }
  }
  hopper::cp_async_wait<0>();
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

template <bool kScaleAfter>
cudaError_t launch_wgmma(const void* qkv, void* ctx, int B, int S, int heads, int causal,
                         int s_valid, int defer, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(ctx) % 4)
    return cudaErrorMisalignedAddress;
  static int ready[tc::kMaxDevices];
  cudaError_t err = tc::allow_smem(mha_kernel<kScaleAfter>, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQT - 1) / kQT, heads, B);
  mha_kernel<kScaleAfter><<<grid, kThreads, Bf16Layout::kBytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx), S, heads, causal, s_valid, defer,
      (float)(1.0 / sqrt(64.0)));
  return cudaGetLastError();
}

// fp32, and bf16 at another head_dim, on the TF32 products: win_tiles is
// the caller's plan.
template <typename T, int kDc, bool kScaleAfter>
cudaError_t launch_tiled(const void* qkv, void* ctx, int B, int S, int heads, int D, int causal,
                         int s_valid, int defer, int win_tiles, cudaStream_t stream) {
  static int ready[tc::kMaxDevices];
  cudaError_t err = tc::allow_smem(tiled_fwd_kernel<T, kDc, kScaleAfter>, ready);
  if (err != cudaSuccess) return err;
  const size_t bytes = sizeof(float) * FwdSmem(kFwdRows, kDc, win_tiles, D > kDc, S).floats;
  if (bytes > (size_t)tc::kMaxSmem) return cudaErrorInvalidValue;
  // 16-byte copies: D (hence 3W and each head's first column) a multiple of 4
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  const dim3 grid((S + kFwdRows - 1) / kFwdRows, heads, B);
  tiled_fwd_kernel<T, kDc, kScaleAfter><<<grid, 256, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(ctx), S, heads, D, causal, s_valid, defer,
      (float)(1.0 / sqrt((double)D)), win_tiles, vec);
  return cudaGetLastError();
}

// The chunk: 64 columns up to head_dim 64, 128 above (wider heads in chunks).
template <typename T, bool kScaleAfter>
cudaError_t launch_plan(const void* qkv, void* ctx, int B, int S, int heads, int D, int causal,
                        int s_valid, int defer, int win_tiles, cudaStream_t s) {
  return D <= 64 ? launch_tiled<T, 64, kScaleAfter>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                    defer, win_tiles, s)
                 : launch_tiled<T, 128, kScaleAfter>(qkv, ctx, B, S, heads, D, causal, s_valid,
                                                     defer, win_tiles, s);
}

template <bool kScaleAfter>
int run(const void* qkv, void* ctx, int B, int S, int heads, int head_dim, int causal,
        int s_valid, int defer, int win_tiles, int dtype, int device, void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || heads > 65535 || S <= 0 || s_valid < 1 ||
      s_valid > S || head_dim <= 0 || win_tiles < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_plan<float, kScaleAfter>(qkv, ctx, B, S, heads, head_dim, causal, s_valid,
                                           defer, win_tiles, s);
  if (dtype == kBF16) {
    if (head_dim == 64)
      return launch_wgmma<kScaleAfter>(qkv, ctx, B, S, heads, causal, s_valid, defer, s);
    return launch_plan<bf16, kScaleAfter>(qkv, ctx, B, S, heads, head_dim, causal, s_valid,
                                          defer, win_tiles, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each takes the plan of the TF32 kernel (ops/attention.py tiled_plan): the
// key tiles of a window; bf16 at head_dim 64 (wgmma) ignores it.

// K3: S <= 512; normalize-first at S <= 128, deferred divide above.
int plip_mha_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                  int causal, int s_valid, int win_tiles, int dtype, int device, void* stream) {
  if (S > 512) return cudaErrorInvalidValue;
  return run<false>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, S > 128, win_tiles,
                    dtype, device, stream);
}

// K5: any S, deferred divide, no pad columns.
int plip_flash_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                    int causal, int win_tiles, int dtype, int device, void* stream) {
  return run<false>(qkv, ctx, B, S, heads, head_dim, causal, S, 1, win_tiles, dtype, device,
                    stream);
}

// K12: any S, normalize-first, no pad columns.
int plip_headgrid_core(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                       int causal, int win_tiles, int dtype, int device, void* stream) {
  return run<false>(qkv, ctx, B, S, heads, head_dim, causal, S, 0, win_tiles, dtype, device,
                    stream);
}

// K1's core at any S: logits scaled after the dot, masks; the divide
// deferred (defer = 1, K1's forward) or normalize-first (0, K7's recompute).
int plip_attn_core_tiled(const void* qkv, void* ctx, int B, int S, int heads, int head_dim,
                         int causal, int s_valid, int defer, int win_tiles, int dtype,
                         int device, void* stream) {
  return run<true>(qkv, ctx, B, S, heads, head_dim, causal, s_valid, defer ? 1 : 0, win_tiles,
                   dtype, device, stream);
}

}  // extern "C"
