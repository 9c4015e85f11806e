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
//                  slices planned by the caller to fill the card. fp32 (the
//                  dtype CLIPTuner trains in by default): the CUDA-core
//                  main loop of csrc/simt_gemm.cuh, full fp32, no TF32, NT
//                  cut into K slices as TN is.
//   attn_core_bwd  one block per (sequence, head), S <= 128: recomputes the
//                  logits and returns the context (for dWout) and dqkv.
//                  bf16 (head_dim 64): the head on chip as 64-row tiles,
//                  every product on wgmma, one launch. fp32, and bf16 at
//                  another head_dim: CUDA cores, k and v resident, the
//                  query rows walked in tiles, every product register-tiled.
//   ln_bwd_rows    LN1 backward in fp32 plus the residual: dx = g + dx_ln,
//                  and each block's partial sums of dgamma and dbeta; a
//                  row in a warp's registers (layer_norm.cuh), the blocks'
//                  rows planned by the caller. Also the backward of every
//                  other LayerNorm of the towers (no residual).
//   col_sum        fp32 column sums: dbqkv, dbout, dgamma/dbeta from the
//                  partials, and the K slices of the TN products; 16-byte
//                  loads, a grid of column strips and row splits planned to
//                  fill the card, the splits added in a fixed order.
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
// the next step. col_sum is bound by bytes (one add a value read): its
// first design, one block per 32 columns and one 2-byte load a lane a row,
// put 24-96 blocks on the 132 SMs and ran at a tenth of the memory rate;
// now each thread keeps four 16-byte loads in flight and row splits bring
// every shape to several blocks an SM. attn_core_bwd at S <= 128 is bound
// by bytes too (14 S D bytes against 12 S^2 D FLOPs a (sequence, head));
// its bf16 kernel runs the six products on wgmma from 128-byte-swizzled
// tiles with e_c and ds_u kept on chip (its first design ran them as scalar
// fmaf loops, at 4.5% of its bound), and what is left is latency: one block
// an SM at S > 64 (the logits and dp of two key tiles take 173 registers a
// thread), phases that wait on each other within the block.
// In fp32, CLIPTuner's default dtype, both run on CUDA cores: grad_gemm is
// bound by the FFMA rate (67 TFLOP/s), and its main loop, shared with the
// fp32 epilogue GEMMs, reaches 51-61% of it at ViT-B/32 batch 128 once the
// K slices fill the card's waves (the four products took 300, 36 and 108
// tiles of 128 x 128 where a wave holds 264: NVIDIA H100 80GB HBM3, 700 W,
// PERF.md section 6). The fp32 core backward, 20-27% of its bytes bound
// there, is bound by latency: sixteen warps an SM, each block's phases
// waiting on its loads and on each other; a third of its time went to the
// loads before the first dot and to IEEE divides, which the copy groups and
// the reciprocals below cut.
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take) so the caller can raise.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "layer_norm.cuh"
#include "simt_gemm.cuh"
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

// fp32 on CUDA cores: the main loop of csrc/simt_gemm.cuh (the fp32 epilogue
// GEMMs' own: 8 x 8 register micro-tiles, k-major tiles, a two-stage ring
// of 8-deep K steps, full fp32) on 128 x 128 tiles, both layouts cut into
// the K slices the caller plans (ops/attention_bwd.py tn_slice_rows: as
// many as fill the card's waves at two blocks an SM; the four products of
// ViT-B/32 at batch 128 make 300, 36 and 108 tiles, a wave is 264 blocks).
// Slice z's sums go to C + z M N.
struct SliceOut {
  float* C;
  int M, N;
  template <int kW>
  __device__ __forceinline__ void operator()(int m, int n, const float (&x)[kW]) const {
    hopper::store_vec<kW>(C + (size_t)blockIdx.z * M * N + (size_t)m * N + n, x);
  }
};

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
  if (splits > 1 && !out_f32) return cudaErrorInvalidValue;
  if (dtype == kF32) {  // 16-byte accesses where every operand's rows allow them
    const bool vec = (kTA ? M : K) % 4 == 0 && N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    return simt::launch_tile<8, 8, kTA, kTB, true>(static_cast<const float*>(a),
                                                   static_cast<const float*>(b), M, N, K, kslice,
                                                   vec, SliceOut{static_cast<float*>(out), M, N},
                                                   s);
  }
  if (dtype != kBF16) return cudaErrorInvalidValue;
  // the contiguous dimension of each operand holds whole 8-element chunks, a
  // slice whole K steps; NT runs K as one slice
  if ((kTA ? M : K) % 8 || (kTB ? K : N) % 8 || (splits > 1 && kslice % hopper::kGemmBK) ||
      (!kTN && splits > 1) ||
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
// (sequence, head), S <= 128.
//
// On CUDA cores, register-tiled: fp32 (the dtype CLIPTuner trains in by
// default), and bf16 at a head_dim other than 64 (the wgmma kernel below is
// built for 64). 256 threads, tx = t % 16, ty = t / 16. Every operand is
// held in shared memory as fp32 rows of Dp = D rounded up to 4 columns
// (zero past D), k, v, q and g rows padded to an odd count of 16-byte units
// (ldk), so that 16 threads reading one 16-byte column group of 16 rows hit
// distinct banks; bf16 values load exactly.
//   0. k and v of the head stay resident: nk = S rounded up to 16 rows,
//      zero from S, copied with the first query tile (k with q, then v
//      with g: two cp.async groups).
//   The block walks the query rows in tiles of kQT (64, or 32 where two key
//   tiles or a head wider than 64 would not leave room):
//   1. The tile's q and g rows in. Thread (tx, ty) holds rows kRT ty ..
//      kRT ty + kRT - 1 (kRT = kQT / 16) against keys 64 c + tx + 16 jj:
//      the logits q . k^T and dp = g . v^T, both as 16-byte loads of q, g,
//      k and v per 4 d, key groups no row of the tile may see skipped (with
//      one key tile the logits' dot runs while v and g are still landing).
//      The logits scaled by D^-1/2 after the dot and masked (causal,
//      s_valid); the exact row max, e = exp(l - m), denom = rowsum(e) and
//      dsum_u = rowsum(dp e) in fp32 from registers (the thread's values,
//      then shuffles among the row's 16 threads); ds_u = e (dp - dsum_u /
//      denom). e_c and ds_u, cast to T, into [kQT][nk + 4] tiles.
//   2. ctx = (e_c . v) / denom and dq = (ds_u . k) D^-1/2 / denom: the same
//      rows, columns 4 (tx + 16 gg), 16-byte loads of e_c, ds_u, v and k
//      per 4 keys up to the rows' last live key; one cast each. Then
//      cast(q / denom) and cast(g / denom) over the row's q and g. Each
//      divide is a multiply by the row's fp32 1 / denom (an IEEE divide an
//      element took a tenth of the kernel's time): one rounding more than
//      the plain version's, within an ulp of it in fp32. The rows a
//      half-warp wrote in step 1 are the ones it reads here: no barrier.
//   3. After one barrier dv += e_c^T . gn and dk += ds_u^T . qn: thread
//      (tx, ty) holds keys 64 c + 4 ty .. + 3 against columns 4 (tx + 16
//      gg), in registers across the query tiles (no atomics), 16-byte loads
//      of e_c, ds_u, qn and gn per row.
//   dk (times D^-1/2) and dv go out after the last tile.
// Every sum runs in a fixed order (d, then the keys, then the rows, each
// ascending; the row statistics the thread's keys in order, then the
// 16-lane butterfly), so a rerun gives the same bits. Rows past S and keys
// no row may see get e = ds_u = 0 (denom 1), so they add nothing.
// ---------------------------------------------------------------------------

constexpr int kCoreThreads = 256;
constexpr int kMaxSeq = 128;  // two key tiles of 64

// Columns of the fp32 rows (D rounded up to 4) and their padded stride (an
// odd count of 16-byte units).
__host__ __device__ __forceinline__ int core_dp(int D) { return (D + 3) & ~3; }
__host__ __device__ __forceinline__ int core_ldk(int D) {
  return (core_dp(D) / 4) % 2 ? core_dp(D) : core_dp(D) + 4;
}

// The query rows a tile: 64 where one key tile and a head of at most 64
// columns leave room, else 32.
__host__ __device__ constexpr int core_qt(int key_tiles, int col_groups) {
  return key_tiles == 1 && col_groups == 1 ? 64 : 32;
}

// Shared memory of a block (ops/attention_bwd.py _core_bwd_smem_bytes), in
// fp32: k and v [nk][ldk], q and g [kQT][ldk], e_c and ds_u [kQT][nk + 4],
// the row denominators [kQT].
size_t core_bwd_smem_bytes(int S, int D) {
  const int nk = (S + 15) & ~15, qt = core_qt((S + 63) / 64, (core_dp(D) + 63) / 64);
  return sizeof(float) * ((size_t)2 * nk * core_ldk(D) + (size_t)2 * qt * core_ldk(D) +
                          (size_t)2 * qt * (nk + 4) + qt);
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows r0 .. r0 + rows - 1 of a head's D columns (src: row 0 of the head's
// columns, ld elements a row) into [rows][ldk] fp32, columns 0 .. Dp - 1,
// zero at and past (S, D). vec: D % 4 == 0 and the rows 4-element aligned
// (a 16-byte cp.async in fp32, an 8-byte load in bf16).
__device__ __forceinline__ void load_rows(float* dst, int ldk, const float* src, int ld, int r0,
                                          int rows, int S, int D, bool vec) {
  const int dp = core_dp(D), groups = dp / 4;
  for (int e = threadIdx.x; e < rows * groups; e += kCoreThreads) {
    const int r = e / groups, c = 4 * (e % groups), i = r0 + r;
    float* d = dst + r * ldk + c;
    const float* sp = src + (size_t)(i < S ? i : 0) * ld + c;
    if (vec) {
      hopper::cp_async16(hopper::smem_u32(d), sp, i < S);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) d[u] = i < S && c + u < D ? sp[u] : 0.f;
    }
  }
}
__device__ __forceinline__ void load_rows(float* dst, int ldk, const bf16* src, int ld, int r0,
                                          int rows, int S, int D, bool vec) {
  const int dp = core_dp(D), groups = dp / 4;
  for (int e = threadIdx.x; e < rows * groups; e += kCoreThreads) {
    const int r = e / groups, c = 4 * (e % groups), i = r0 + r;
    const bf16* sp = src + (size_t)(i < S ? i : 0) * ld + c;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < S) {
      if (vec) {
        const uint2 raw = *reinterpret_cast<const uint2*>(sp);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        x = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        x.x = c < D ? to_f(sp[0]) : 0.f;
        x.y = c + 1 < D ? to_f(sp[1]) : 0.f;
        x.z = c + 2 < D ? to_f(sp[2]) : 0.f;
        x.w = c + 3 < D ? to_f(sp[3]) : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * ldk + c) = x;
  }
}

// Four values of columns c .. c + 3 of a row of T at p (columns at or past
// D dropped; vec: one access).
template <typename T>
__device__ __forceinline__ void store4(T* p, int c, int D, const float (&x)[4], bool vec) {
  if (vec) {
    hopper::store_vec<4>(p, x);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u < D) p[u] = from_f<T>(x[u]);
  }
}

// kKT: key tiles of 64 (S <= 64 kKT); kG: groups of 64 columns (Dp <= 64 kG).
template <typename T, int kKT, int kG>
__global__ void __launch_bounds__(kCoreThreads, kKT * kG == 4 ? 1 : 2)
attn_core_bwd_simt_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                          T* __restrict__ ctx, T* __restrict__ dqkv, int S, int heads, int D,
                          int causal, int s_valid, int vec, float scale) {
  constexpr int kQT = core_qt(kKT, kG), kRT = kQT / 16;
  // one key tile: the logits' dot runs while v and g are still arriving
  // (two dots in turn); two key tiles hold more registers and take both in
  // one pass
  constexpr bool kSplit = kKT == 1;
  extern __shared__ __align__(16) float core_smem[];
  const int ldk = core_ldk(D), dp4 = core_dp(D), nk = (S + 15) & ~15, ldp = nk + 4;
  float* Ks = core_smem;            // [nk][ldk]
  float* Vs = Ks + nk * ldk;        // [nk][ldk]
  float* Qs = Vs + nk * ldk;        // [kQT][ldk]; then cast(q / denom)
  float* Gs = Qs + kQT * ldk;       // [kQT][ldk]; then cast(g / denom)
  float* Es = Gs + kQT * ldk;       // [kQT][ldp] e_c
  float* DSs = Es + kQT * ldp;      // [kQT][ldp] ds_u
  float* den = DSs + kQT * ldp;     // [kQT]
  const int W = heads * D, W3 = 3 * W;
  const int h = blockIdx.x % heads, b = blockIdx.x / heads;
  const T* base = qkv + (size_t)b * S * W3 + h * D;
  const T* gbase = dctx + (size_t)b * S * W + h * D;
  const int n_keys = min(S, s_valid);  // no row sees a key at or past it
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float dk[kKT][4][4 * kG], dv[kKT][4][4 * kG];  // keys 64 c + 4 ty + ii, columns 4 (tx + 16 gg)
#pragma unroll
  for (int c = 0; c < kKT; ++c)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int n = 0; n < 4 * kG; ++n) dk[c][ii][n] = dv[c][ii][n] = 0.f;

  for (int r0 = 0; r0 < S; r0 += kQT) {
    if (r0) __syncthreads();  // every thread is done with the last tile's q, g, e_c, ds_u
    // two copy groups: k (the first tile) and q, then v and g
    if (r0 == 0) load_rows(Ks, ldk, base + W, W3, 0, nk, S, D, vec);
    load_rows(Qs, ldk, base, W3, r0, kQT, S, D, vec);
    hopper::cp_async_commit();
    if (r0 == 0) load_rows(Vs, ldk, base + 2 * W, W3, 0, nk, S, D, vec);
    load_rows(Gs, ldk, gbase, W, r0, kQT, S, D, vec);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kSplit ? 1 : 0>();
    __syncthreads();

    // 1. logits and dp of rows kRT ty + i against the keys those rows may see
    // (none for a half-warp whose rows all lie past S)
    const int row0 = r0 + kRT * ty;
    const int hw_keys = row0 >= S ? 0 : causal ? min(n_keys, row0 + kRT) : n_keys;
    const int kend = (hw_keys + 15) & ~15;
    float l[kKT][kRT][4], p[kKT][kRT][4];
#pragma unroll
    for (int c = 0; c < kKT; ++c)
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) l[c][i][jj] = p[c][i][jj] = 0.f;
    // The dots of the rows' q (and g) with 16-key groups of k (and v), over
    // d; a guard a group where some group is dead, none where all are.
    // kSplit: q . k^T on the first copy group while v and g land, then
    // g . v^T; else both in one pass.
    const bool full = kend >= 64 * kKT && nk >= 64 * kKT;
    auto dots = [&](auto guarded, auto both, const float* A, const float* Bm, const float* A2,
                    const float* Bm2, float (&acc)[kKT][kRT][4], float (&acc2)[kKT][kRT][4]) {
      for (int d = 0; d < (kend ? dp4 : 0); d += 4) {
        float4 a[kRT], a2[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          a[i] = ld4(A + (kRT * ty + i) * ldk + d);
          if (decltype(both)::value) a2[i] = ld4(A2 + (kRT * ty + i) * ldk + d);
        }
#pragma unroll
        for (int c = 0; c < kKT; ++c)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (decltype(guarded)::value && 64 * c + 16 * jj >= kend) continue;
            const int j = (64 * c + 16 * jj + tx) * ldk + d;
            const float4 k = ld4(Bm + j);
#pragma unroll
            for (int i = 0; i < kRT; ++i)
              acc[c][i][jj] = fmaf(a[i].w, k.w, fmaf(a[i].z, k.z, fmaf(a[i].y, k.y,
                              fmaf(a[i].x, k.x, acc[c][i][jj]))));
            if (decltype(both)::value) {
              const float4 v = ld4(Bm2 + j);
#pragma unroll
              for (int i = 0; i < kRT; ++i)
                acc2[c][i][jj] = fmaf(a2[i].w, v.w, fmaf(a2[i].z, v.z, fmaf(a2[i].y, v.y,
                                 fmaf(a2[i].x, v.x, acc2[c][i][jj]))));
            }
          }
      }
    };
    using No = std::false_type;
    using Yes = std::true_type;
    if constexpr (kSplit) {
      if (full) dots(No{}, No{}, Qs, Ks, Gs, Vs, l, p); else dots(Yes{}, No{}, Qs, Ks, Gs, Vs, l, p);
      hopper::cp_async_wait<0>();
      __syncthreads();
      if (full) dots(No{}, No{}, Gs, Vs, Qs, Ks, p, l); else dots(Yes{}, No{}, Gs, Vs, Qs, Ks, p, l);
    } else {
      if (full) dots(No{}, Yes{}, Qs, Ks, Gs, Vs, l, p); else dots(Yes{}, Yes{}, Qs, Ks, Gs, Vs, l, p);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = kRT * ty + i, row = r0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKT; ++c)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 64 * c + 16 * jj + tx;
          const bool keep = row < S && j < n_keys && !(causal && j > row);
          l[c][i][jj] = keep ? l[c][i][jj] * scale : -INFINITY;
          mx = fmaxf(mx, l[c][i][jj]);
        }
      mx = half_warp_max(mx);
      const float ref = mx == -INFINITY ? 0.f : mx;  // a row past S keeps no key
      float denom = 0.f, dsum = 0.f;
#pragma unroll
      for (int c = 0; c < kKT; ++c)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          l[c][i][jj] = expf(l[c][i][jj] - ref);  // masked: exp(-inf) = 0
          denom += l[c][i][jj];
          dsum += p[c][i][jj] * l[c][i][jj];
        }
      denom = half_warp_sum(denom);
      dsum = half_warp_sum(dsum);
      if (denom == 0.f) denom = 1.f;
      const float sub = dsum / denom;
#pragma unroll
      for (int c = 0; c < kKT; ++c)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 64 * c + 16 * jj + tx;
          if (j < nk) {
            const float e = l[c][i][jj];
            Es[r * ldp + j] = round_to<T>(e);
            DSs[r * ldp + j] = e == 0.f ? 0.f : round_to<T>(e * (p[c][i][jj] - sub));
          }
        }
      if (tx == 0) den[r] = denom;
    }
    __syncwarp();

    // 2. ctx and dq of the same rows; then q / denom and g / denom over them
    const int jend = (hw_keys + 3) & ~3;  // e_c and ds_u are zero from hw_keys to there
    float ac[kRT][4 * kG], aq[kRT][4 * kG];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int n = 0; n < 4 * kG; ++n) ac[i][n] = aq[i][n] = 0.f;
#pragma unroll 2
    for (int j = 0; j < jend; j += 4) {
      float4 e[kRT], s[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        e[i] = ld4(Es + (kRT * ty + i) * ldp + j);
        s[i] = ld4(DSs + (kRT * ty + i) * ldp + j);
      }
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) {
        const int col = 4 * (tx + 16 * gg);
        if (col >= dp4) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v = ld4(Vs + (j + jj) * ldk + col), k = ld4(Ks + (j + jj) * ldk + col);
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            const float ei = jj == 0 ? e[i].x : jj == 1 ? e[i].y : jj == 2 ? e[i].z : e[i].w;
            const float si = jj == 0 ? s[i].x : jj == 1 ? s[i].y : jj == 2 ? s[i].z : s[i].w;
            float* a = &ac[i][4 * gg];
            float* q = &aq[i][4 * gg];
            a[0] = fmaf(ei, v.x, a[0]);
            a[1] = fmaf(ei, v.y, a[1]);
            a[2] = fmaf(ei, v.z, a[2]);
            a[3] = fmaf(ei, v.w, a[3]);
            q[0] = fmaf(si, k.x, q[0]);
            q[1] = fmaf(si, k.y, q[1]);
            q[2] = fmaf(si, k.z, q[2]);
            q[3] = fmaf(si, k.w, q[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = kRT * ty + i, row = r0 + r;
      if (row >= S) continue;  // past S: q and g are zero, and no output
      const float inv = 1.f / den[r];
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) {
        const int col = 4 * (tx + 16 * gg);
        if (col >= dp4) continue;
        const float y[4] = {ac[i][4 * gg] * inv, ac[i][4 * gg + 1] * inv,
                            ac[i][4 * gg + 2] * inv, ac[i][4 * gg + 3] * inv};
        const float z[4] = {aq[i][4 * gg] * scale * inv, aq[i][4 * gg + 1] * scale * inv,
                            aq[i][4 * gg + 2] * scale * inv, aq[i][4 * gg + 3] * scale * inv};
        store4(ctx + ((size_t)b * S + row) * W + h * D + col, col, D, y, vec);
        store4(dqkv + ((size_t)b * S + row) * W3 + h * D + col, col, D, z, vec);
        float* q = Qs + r * ldk + col;
        float* g = Gs + r * ldk + col;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          q[u] = round_to<T>(q[u] * inv);
          g[u] = round_to<T>(g[u] * inv);
        }
      }
    }
    __syncthreads();  // every row's e_c, ds_u, qn and gn

    // 3. dv += e_c^T . gn, dk += ds_u^T . qn over the tile's live rows that
    // may see the thread's keys (causal: from the first key's row)
    const int rows = min(kQT, S - r0);
#pragma unroll
    for (int c = 0; c < kKT; ++c) {
      const int j0 = 64 * c + 4 * ty;
      if (j0 >= n_keys) continue;  // the four keys all dead (n_keys <= nk, nk % 4 == 0)
#pragma unroll 2
      for (int r = causal ? max(0, j0 - r0) : 0; r < rows; ++r) {
        const float4 e = ld4(Es + r * ldp + j0), s = ld4(DSs + r * ldp + j0);
        const float ev[4] = {e.x, e.y, e.z, e.w}, sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int gg = 0; gg < kG; ++gg) {
          const int col = 4 * (tx + 16 * gg);
          if (col >= dp4) continue;
          const float4 gn = ld4(Gs + r * ldk + col), qn = ld4(Qs + r * ldk + col);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            float* a = &dv[c][ii][4 * gg];
            float* q = &dk[c][ii][4 * gg];
            a[0] = fmaf(ev[ii], gn.x, a[0]);
            a[1] = fmaf(ev[ii], gn.y, a[1]);
            a[2] = fmaf(ev[ii], gn.z, a[2]);
            a[3] = fmaf(ev[ii], gn.w, a[3]);
            q[0] = fmaf(sv[ii], qn.x, q[0]);
            q[1] = fmaf(sv[ii], qn.y, q[1]);
            q[2] = fmaf(sv[ii], qn.z, q[2]);
            q[3] = fmaf(sv[ii], qn.w, q[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kKT; ++c)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = 64 * c + 4 * ty + ii;
      if (j >= S) continue;
      T* out = dqkv + ((size_t)b * S + j) * W3 + h * D;
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) {
        const int col = 4 * (tx + 16 * gg);
        if (col >= dp4) continue;
        const float* a = &dk[c][ii][4 * gg];
        const float* v = &dv[c][ii][4 * gg];
        const float y[4] = {a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale};
        const float z[4] = {v[0], v[1], v[2], v[3]};
        store4(out + W + col, col, D, y, vec);
        store4(out + 2 * W + col, col, D, z, vec);
      }
    }
}

template <typename T, int kKT, int kG>
cudaError_t launch_core_bwd_simt(const void* qkv, const void* dctx, void* ctx, void* dqkv,
                                 int B, int S, int heads, int D, int causal, int s_valid,
                                 bool vec, cudaStream_t stream) {
  const size_t smem = core_bwd_smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(attn_core_bwd_simt_kernel<T, kKT, kG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_core_bwd_simt_kernel<T, kKT, kG><<<B * heads, kCoreThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dctx), static_cast<T*>(ctx),
      static_cast<T*>(dqkv), S, heads, D, causal, s_valid, (int)vec,
      (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// S <= 128, D <= 128: one or two key tiles, one or two column groups.
template <typename T>
cudaError_t launch_core_bwd(const void* qkv, const void* dctx, void* ctx, void* dqkv,
                            int B, int S, int heads, int D, int causal, int s_valid,
                            cudaStream_t stream) {
  // 4-element rows and every pointer aligned to them: 16-byte (fp32) or
  // 8-byte (bf16) accesses
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dctx) % align == 0 &&
                   reinterpret_cast<uintptr_t>(ctx) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dqkv) % align == 0;
  const bool two_keys = S > 64, two_cols = core_dp(D) > 64;
  if (!two_keys && !two_cols)
    return launch_core_bwd_simt<T, 1, 1>(qkv, dctx, ctx, dqkv, B, S, heads, D, causal, s_valid,
                                         vec, stream);
  if (!two_keys)
    return launch_core_bwd_simt<T, 1, 2>(qkv, dctx, ctx, dqkv, B, S, heads, D, causal, s_valid,
                                         vec, stream);
  if (!two_cols)
    return launch_core_bwd_simt<T, 2, 1>(qkv, dctx, ctx, dqkv, B, S, heads, D, causal, s_valid,
                                         vec, stream);
  return launch_core_bwd_simt<T, 2, 2>(qkv, dctx, ctx, dqkv, B, S, heads, D, causal, s_valid,
                                       vec, stream);
}

// ---------------------------------------------------------------------------
// attn_core_bwd, bf16: the head on chip, every product on wgmma
// (csrc/wgmma.cuh). One block per (sequence b, head h) of kTiles warpgroups,
// S <= 64 kTiles, D = 64; the head's q, g, k and v are kTiles 64-row tiles
// each, zero past S.
//
//   1. cp.async: every q and g tile and the live k and v tiles (a key tile
//      is live unless it lies wholly at or past s_valid) into 128-byte-
//      swizzled tiles.
//   2. Warpgroup w takes q tile w (rows 64w ..): s = q . k^T and dp = g . v^T
//      for each key tile its rows may see (not the causal triangle's dead
//      tile), 32 fp32 a thread a tile each; the logits scaled after the dot
//      and masked (causal, s_valid, past S); the exact row max, e = exp(l -
//      m), the fp32 denom = rowsum(e) and dsum_u = rowsum(dp e) from those
//      registers (the thread's values, then the quad's); ds_u = e (dp -
//      dsum_u / denom). e_c and ds_u are cast once, repacked in registers as
//      A fragments.
//   3. ctx = (e_c . v) / denom and dq = (ds_u . k) * scale / denom, RS form,
//      each key tile's product in a fresh accumulator, the tiles added in
//      order in fp32; one cast.
//   4. The A fragments of e_c and ds_u stored as bf16 tiles [q row][key]
//      (one per live (q tile, key tile) pair); cast(q / denom) and cast(g /
//      denom) written over the warpgroup's own q and g tiles.
//   5. After one barrier warpgroup w takes key tile w: dv = e_c^T . gn and
//      dk = ds_u^T . qn * scale, keys as the M rows: both operands' rows are
//      the product's K (MN-major descriptors, transpose-A and -B), summed
//      over the q tiles that see the key tile, each in a fresh accumulator.
//
// Rows past S get e = ds_u = 0 and denom = 1 (their q and g are zero), so
// they add nothing to dk and dv. Key tiles no row may see are neither loaded
// nor multiplied; their dk and dv are zero. Unlike csrc/mha_bwd.cu's
// key-tiled pair, nothing goes through device memory between the steps:
// no row statistics, one launch.
// ---------------------------------------------------------------------------

constexpr int kWgD = 64;        // the head width the bf16 kernel is built for
constexpr int kWgMaxSeq = 128;  // two tiles of 64 rows

// Shared memory from a 1024-byte boundary, in tiles of hopper::kTileBytes: q
// (later cast(q / denom)), g (later cast(g / denom)), k and v, kTiles each;
// then e_c and ds_u, a tile per (q tile i, key tile j) at i * kTiles + j.
template <int kTiles>
struct CoreBwdLayout {
  static constexpr uint32_t kT = hopper::kTileBytes;
  static constexpr uint32_t kQ = 0, kG = kTiles * kT, kK = 2 * kTiles * kT,
                            kV = 3 * kTiles * kT, kE = 4 * kTiles * kT,
                            kDS = kE + kTiles * kTiles * kT;
  static constexpr size_t kBytes = kDS + kTiles * kTiles * kT + 1024;  // + alignment slack
};

// min blocks an SM: what the registers of two tiles' logits and dp allow
template <int kTiles>
__global__ void __launch_bounds__(kTiles * hopper::kWarpgroup, kTiles == 1 ? 3 : 1)
attn_core_bwd_wgmma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                           bf16* __restrict__ ctx, bf16* __restrict__ dqkv, int S, int heads,
                           int causal, int s_valid, float scale) {
  using namespace hopper;
  using L = CoreBwdLayout<kTiles>;
  constexpr int kThreads = kTiles * kWarpgroup;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const int W = heads * kWgD, W3 = 3 * W;
  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* base = qkv + (size_t)b * S * W3 + h * kWgD;
  const bf16* gbase = dctx + (size_t)b * S * W + h * kWgD;
  const int n_keys = min(S, s_valid);  // no row sees a key at or past it
  const int key_tiles = (n_keys + 63) / 64;

#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    load_tile_2d<kThreads>(s0 + L::kQ + t * L::kT, base, W3, 64 * t, S, 0, kWgD);
    load_tile_2d<kThreads>(s0 + L::kG + t * L::kT, gbase, W, 64 * t, S, 0, kWgD);
    if (t < key_tiles) {
      load_tile_2d<kThreads>(s0 + L::kK + t * L::kT, base + W, W3, 64 * t, S, 0, kWgD);
      load_tile_2d<kThreads>(s0 + L::kV + t * L::kT, base + 2 * W, W3, 64 * t, S, 0, kWgD);
    }
  }
  cp_async_commit();

  // This warpgroup's q tile; this thread's two rows (accumulator halves
  // hh = 0, 1) and first column.
  const int wg = threadIdx.x / kWarpgroup, q0 = 64 * wg;
  const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4), r_loc = 16 * warp + lane / 4, row0 = q0 + r_loc;
  const int nk = causal ? min(n_keys, q0 + 64) : n_keys;  // keys the tile's rows may see
  const int n_tiles = (nk + 63) / 64;                     // >= 1: q0 < S
  const uint32_t s_q = s0 + L::kQ + wg * L::kT, s_g = s0 + L::kG + wg * L::kT;

  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // 2. the logits (then e) in s, dp (then ds_u) in dp
  float s[kTiles][32], dp[kTiles][32];
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    if (t < n_tiles) {
      issue_abt(s[t], s_q, s0 + L::kK + t * L::kT);
      issue_abt(dp[t], s_g, s0 + L::kV + t * L::kT);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    fence_acc(s[t]);
    fence_acc(dp[t]);
  }
  // den, sub: each row's fp32 denom and dsum_u / denom; a warp whose rows all
  // lie past S keeps e = ds_u = 0 and denom = 1 (its q and g rows are zero)
  float den[2] = {1.f, 1.f}, sub[2] = {0.f, 0.f};
  if (q0 + 16 * warp < S) {
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int hh = (v >> 1) & 1, i = row0 + 8 * hh;
        const int j = 64 * t + 8 * (v >> 2) + c0 + (v & 1);
        const bool ok = t < n_tiles && i < S && j < nk && !(causal && j > i);
        s[t][v] = ok ? s[t][v] * scale : -INFINITY;
        m[hh] = fmaxf(m[hh], s[t][v]);
      }
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = quad_max(m[hh]);  // -inf only for a row past S
      den[hh] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int hh = (v >> 1) & 1;
        const float e = s[t][v] == -INFINITY ? 0.f : expf(s[t][v] - m[hh]);
        s[t][v] = e;
        den[hh] += e;
        dsum[hh] += t < n_tiles ? dp[t][v] * e : 0.f;  // dp of a dead tile: never computed
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      den[hh] = quad_sum(den[hh]);
      if (den[hh] == 0.f) den[hh] = 1.f;  // a row past S
      sub[hh] = quad_sum(dsum[hh]) / den[hh];
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v)
        dp[t][v] = t < n_tiles ? s[t][v] * (dp[t][v] - sub[(v >> 1) & 1]) : 0.f;
  } else {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) s[t][v] = dp[t][v] = 0.f;
  }
  uint32_t ae[kTiles][4][4], ads[kTiles][4][4];  // e_c and ds_u as A fragments
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    to_a_frags(s[t], ae[t]);
    to_a_frags(dp[t], ads[t]);
  }

  // 3. ctx = (e_c . v) / denom, dq = (ds_u . k) * scale / denom: a fresh
  // accumulator a key tile, the tiles added in order
  float cx[kTiles][32], dq[kTiles][32];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int v = 0; v < 32; ++v) cx[t][v] = dq[t][v] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    if (t < n_tiles) {
      issue_ab(cx[t], ae[t], s0 + L::kV + t * L::kT);
      issue_ab(dq[t], ads[t], s0 + L::kK + t * L::kT);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    fence_acc(cx[t]);
    fence_acc(dq[t]);
    fence_frags(ae[t]);
    fence_frags(ads[t]);
  }
#pragma unroll
  for (int t = 1; t < kTiles; ++t)
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      cx[0][v] += cx[t][v];
      dq[0][v] += dq[t][v];
    }
  store_acc(ctx + (size_t)b * S * W + h * kWgD, W, cx[0], row0, S,
            [&](float x, int hh) { return x / den[hh]; });
  store_acc(dqkv + (size_t)b * S * W3 + h * kWgD, W3, dq[0], row0, S,
            [&](float x, int hh) { return (x * scale) / den[hh]; });

  // 4. e_c and ds_u tiles [q row][key] from the fragments (thread t's pair of
  // columns 8c + c0 of rows r_loc, r_loc + 8); cast(q / denom), cast(g /
  // denom) over this warpgroup's q and g tiles (columns 16 (lane % 4) ..;
  // rows past S stay zero)
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    if (t < n_tiles) {
      const uint32_t pair = L::kT * (wg * kTiles + t) + 4 * (lane % 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t off = pair + sw128(r_loc + 8 * (r & 1), 2 * kk + (r >> 1));
          *reinterpret_cast<uint32_t*>(sm + L::kE + off) = ae[t][kk][r];
          *reinterpret_cast<uint32_t*>(sm + L::kDS + off) = ads[t][kk][r];
        }
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (row0 + 8 * hh < S)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const uint32_t off = wg * L::kT + sw128(r_loc + 8 * hh, 2 * (lane % 4) + cc);
        uint4* q = reinterpret_cast<uint4*>(sm + L::kQ + off);
        uint4* g = reinterpret_cast<uint4*>(sm + L::kG + off);
        *q = div_bf16x8(*q, den[hh]);
        *g = div_bf16x8(*g, den[hh]);
      }
  fence_proxy_async();
  __syncthreads();

  // 5. key tile wg: dv = e_c^T . gn, dk = ds_u^T . qn * scale over the q
  // tiles that see it, a fresh accumulator each, added in order
  const int k0 = 64 * wg;
  const int it0 = causal ? wg : 0;  // the q tiles before it see none of its keys
  float tv[kTiles][32], tk[kTiles][32];
  if (k0 < n_keys) {
    wgmma_fence();
#pragma unroll
    for (int it = 0; it < kTiles; ++it)
      if (it >= it0) {
        const uint32_t pair = L::kT * (it * kTiles + wg);
        issue_atb(tv[it], s0 + L::kE + pair, s0 + L::kG + it * L::kT);
        issue_atb(tk[it], s0 + L::kDS + pair, s0 + L::kQ + it * L::kT);
      }
    wgmma_commit();
    wgmma_wait<0>();
  }
  float dv[32], dk[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) dv[v] = dk[v] = 0.f;
#pragma unroll
  for (int it = 0; it < kTiles; ++it) {
    fence_acc(tv[it]);
    fence_acc(tk[it]);
    if (k0 < n_keys && it >= it0)
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        dv[v] += tv[it][v];
        dk[v] += tk[it][v];
      }
  }
  bf16* out = dqkv + (size_t)b * S * W3 + h * kWgD;
  store_acc(out + 2 * W, W3, dv, k0 + r_loc, S, [](float x, int) { return x; });
  store_acc(out + W, W3, dk, k0 + r_loc, S, [&](float x, int) { return x * scale; });
}

template <int kTiles>
cudaError_t launch_core_bwd_wgmma_tiles(const void* qkv, const void* dctx, void* ctx,
                                        void* dqkv, int B, int S, int heads, int causal,
                                        int s_valid, cudaStream_t stream) {
  constexpr int kSmem = (int)CoreBwdLayout<kTiles>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attn_core_bwd_wgmma_kernel<kTiles>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  attn_core_bwd_wgmma_kernel<kTiles><<<dim3(heads, B), kTiles * hopper::kWarpgroup, kSmem,
                                       stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dctx), static_cast<bf16*>(ctx),
      static_cast<bf16*>(dqkv), S, heads, causal, s_valid,
      (float)(1.0 / sqrt((double)kWgD)));
  return cudaGetLastError();
}

cudaError_t launch_core_bwd_wgmma(const void* qkv, const void* dctx, void* ctx, void* dqkv,
                                  int B, int S, int heads, int causal, int s_valid,
                                  cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(dctx) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 4 || reinterpret_cast<uintptr_t>(dqkv) % 4)
    return cudaErrorMisalignedAddress;
  if (S <= 64)
    return launch_core_bwd_wgmma_tiles<1>(qkv, dctx, ctx, dqkv, B, S, heads, causal, s_valid,
                                          stream);
  return launch_core_bwd_wgmma_tiles<2>(qkv, dctx, ctx, dqkv, B, S, heads, causal, s_valid,
                                        stream);
}

// ---------------------------------------------------------------------------
// ln_bwd_rows: for each row of x [rows, W] (compute dtype T), dln [rows, W]
// (fp32, or T: the grad of ops/attention.py layer_norm_rows' output) and g
// [rows, W] (the residual's grad, T, or null):
//   xhat = (x - mean) * rstd, dxhat = dln * gamma,
//   dx_ln = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dx = g + cast(dx_ln), added in the compute dtype (cast(dx_ln) without g);
// and per block, partial[block] = [sum dln*xhat | sum dln] ([2W] fp32) over
// the block's rows, which col_sum adds into dgamma and dbeta.
//
// Bound by bytes: x, dln and g in, dx out. (A block walking 8 rows with four
// scalar passes, eight barriers a row and a partial row every 8 rows, the
// first design, ran at 7-11% of that bound.) ln_rows' row layout
// (layer_norm.cuh): x, dln and g read once into registers, all of a row's
// loads issued before its first sum (16-byte loads, kept as loaded and
// converted where read, so a bf16 chunk takes half the registers and dln is
// converted whichever its dtype), gamma once a warp; the four row sums from
// shuffles in three rounds; each lane adds its columns' dln * xhat and dln
// over the rows it takes in registers, and a block adds its row groups' sums
// in group order into its one partial row. The rows a block takes are the
// caller's plan (ops/attention_bwd.py ln_bwd_split: about two blocks an SM,
// at most 128 registers a thread up to 16 values a lane), so the partial has
// as many rows as the plan has blocks. The order of every add is fixed: a
// rerun gives the same bits. Widths past the register layout's reach take
// ln_bwd_rows_wide_kernel (one block walking the plan's rows).
// ---------------------------------------------------------------------------

template <typename T, typename TD, int V, int kChunks>
__global__ void __launch_bounds__(kLnThreads, kChunks * V <= 16 ? 2 : 1)
ln_bwd_rows_kernel(const T* __restrict__ x, const TD* __restrict__ dln,
                   const T* __restrict__ g, const float* __restrict__ gamma,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int width,
                   int warps, int rows_per_block, float eps) {
  extern __shared__ float sums[];  // [2W]: the block's partial row
  __shared__ float red[4 * kLnWarps];
  const LnLane l(warps);
  const int chunks = width / V, stride = 32 * warps;
  float gm[kChunks][V], acc_a[kChunks][V], acc_b[kChunks][V];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = l.t + k * stride;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      gm[k][i] = c < chunks ? __ldg(gamma + c * V + i) : 0.f;
      acc_a[k][i] = acc_b[k][i] = 0.f;
    }
  }
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  for (int r = r0 + l.group; r < r1; r += l.groups) {
    const size_t o = (size_t)r * width;
    // the row's x, dln and g, all loads issued before the first sum
    LnRaw<T, V> v[kChunks], gv[kChunks];
    LnRaw<TD, V> d[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = l.t + k * stride;
      if (c < chunks) {
        v[k].load(x + o + c * V);
        d[k].load(dln + o + c * V);
        if (g) gv[k].load(g + o + c * V);
      } else {
        v[k].zero();
        d[k].zero();
      }
    }
    float mean, rstd;
    ln_stats<V, kChunks>(v, chunks, width, eps, red, l, mean, rstd);
    float ab[2] = {0.f, 0.f};  // sum dxhat, sum dxhat * xhat
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (l.t + k * stride < chunks) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float dxh = __fmul_rn(d[k][i], gm[k][i]);  // the same bits below
          ab[0] += dxh;
          ab[1] += dxh * ((v[k][i] - mean) * rstd);
        }
      }
    }
    ln_group_sum(ab, red + 2 * kLnWarps, l);
    const float ma = ab[0] / (float)width, mb = ab[1] / (float)width;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = l.t + k * stride;
      if (c < chunks) {
        float y[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (v[k][i] - mean) * rstd;
          // dxhat rounded as in its sum (no fused multiply-add), so that a row whose
          // dxhat are all equal (W = 1) gives dxhat - mean(dxhat) = 0 exactly
          const float dxl = rstd * (__fmul_rn(d[k][i], gm[k][i]) - ma - xh * mb);
          y[i] = g ? gv[k][i] + round_to<T>(dxl) : dxl;
          acc_a[k][i] += d[k][i] * xh;
          acc_b[k][i] += d[k][i];
        }
        ln_store<T, V>(dx + o + c * V, y);
      }
    }
  }
  // the block's partial row: its row groups' sums added in group order
  for (int gi = 0; gi < l.groups; ++gi) {
    if (l.group == gi) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = l.t + k * stride;
        if (c < chunks) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            float* a = sums + c * V + i;
            a[0] = gi ? a[0] + acc_a[k][i] : acc_a[k][i];
            a[width] = gi ? a[width] + acc_b[k][i] : acc_b[k][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* prow = partial + (size_t)blockIdx.x * 2 * width;
  for (int c = threadIdx.x; c < 2 * width; c += kLnThreads) prow[c] = sums[c];
}

// Any width: the block's rows in turn, block sums through shared memory.
template <typename T, typename TD>
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_rows_wide_kernel(const T* __restrict__ x, const TD* __restrict__ dln,
                        const T* __restrict__ g, const float* __restrict__ gamma,
                        T* __restrict__ dx, float* __restrict__ partial, int rows, int width,
                        int rows_per_block, float eps) {
  extern __shared__ float acc[];  // [2W]: this block's sums of dln*xhat, dln
  __shared__ float red[32];
  for (int c = threadIdx.x; c < 2 * width; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * width;
    const TD* dr = dln + (size_t)r * width;
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
      const float dxh = __fmul_rn(to_f(dr[c]), gamma[c]);
      sa += dxh;
      sb += dxh * ((to_f(xr[c]) - mean) * rstd);
    }
    const float ma = block_sum(sa, red) / width;
    const float mb = block_sum(sb, red) / width;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float dc = to_f(dr[c]);
      const float dxl = rstd * (__fmul_rn(dc, gamma[c]) - ma - xh * mb);
      const size_t o = (size_t)r * width + c;
      dx[o] = from_f<T>(g ? to_f(g[o]) + round_to<T>(dxl) : dxl);
      acc[c] += dc * xh;
      acc[width + c] += dc;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * width; c += blockDim.x)
    partial[(size_t)blockIdx.x * 2 * width + c] = acc[c];
}

// Dynamic shared memory past the default 48 KB needs the kernel's consent.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename TD, int V>
cudaError_t launch_ln_bwd_vec(const T* x, const TD* dln, const T* g, const float* gamma, T* dx,
                              float* partial, int rows, int width, int values, int warps,
                              int rows_per_block, float eps, cudaStream_t s) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * (size_t)width * sizeof(float);
  cudaError_t err;
  switch (values) {
#define PLIP_LN_BWD(kValues)                                                              \
  case kValues:                                                                           \
    err = allow_smem(ln_bwd_rows_kernel<T, TD, V, kValues / V>, smem);                    \
    if (err != cudaSuccess) return err;                                                   \
    ln_bwd_rows_kernel<T, TD, V, kValues / V><<<blocks, kLnThreads, smem, s>>>(           \
        x, dln, g, gamma, dx, partial, rows, width, warps, rows_per_block, eps);          \
    break;
    PLIP_LN_BWD(8)
    PLIP_LN_BWD(16)
    PLIP_LN_BWD(24)
    PLIP_LN_BWD(32)
#undef PLIP_LN_BWD
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// vec: 16 bytes' worth of T (x, dln, g, dx 16-byte aligned, width a multiple
// of it) or 1; values: the register bucket; warps: warps a row, 0 for
// ln_bwd_rows_wide_kernel; rows_per_block: the plan's rows a block (one
// partial row each).
template <typename T, typename TD>
cudaError_t launch_ln_bwd_rows(const void* x, const void* dln, const void* g,
                               const float* gamma, void* dx, float* partial, int rows,
                               int width, int vec, int values, int warps, int rows_per_block,
                               float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const TD* dt = static_cast<const TD*>(dln);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (warps == 0) {
    const int blocks = (rows + rows_per_block - 1) / rows_per_block;
    const size_t smem = 2 * (size_t)width * sizeof(float);
    cudaError_t err = allow_smem(ln_bwd_rows_wide_kernel<T, TD>, smem);
    if (err != cudaSuccess) return err;
    ln_bwd_rows_wide_kernel<T, TD><<<blocks, kLnThreads, smem, s>>>(
        xt, dt, gt, gamma, dxt, partial, rows, width, rows_per_block, eps);
    return cudaGetLastError();
  }
  constexpr int kVec = 16 / sizeof(T);
  if ((warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      width > 32 * warps * values)
    return cudaErrorInvalidValue;
  if (vec == 1)
    return launch_ln_bwd_vec<T, TD, 1>(xt, dt, gt, gamma, dxt, partial, rows, width, values,
                                       warps, rows_per_block, eps, s);
  if (vec != kVec || width % kVec) return cudaErrorInvalidValue;
  if (!aligned16({x, dln, g, dx})) return cudaErrorMisalignedAddress;
  return launch_ln_bwd_vec<T, TD, kVec>(xt, dt, gt, gamma, dxt, partial, rows, width, values,
                                        warps, rows_per_block, eps, s);
}

// ---------------------------------------------------------------------------
// col_sum: out[n] = sum over r of in[r, n], fp32, for in [R, C] in fp32 or
// bf16. Bound by bytes: each input byte is read once, R*C*size against R*C
// adds. The grid is planned by the caller (ops/attention_bwd.py:
// col_sum_plan) to put several blocks on every SM at every shape:
//
//   grid.x  column strips: a block of kSumThreads threads is tx = kSumThreads
//           / ty lanes across the strip (V columns each, V = 16 / size
//           unless C or the base allows only a narrower access: C % V == 0
//           and the base V * size aligned) and ty rows;
//   grid.y  row splits of split_rows rows each (at most kSumMaxSplits).
//
// Thread (x, y) adds rows r0 + y, r0 + y + ty, ... of its V columns in that
// order, kSumUnroll loads in flight; the block adds its ty sums in order of
// y. With one split that is the column's sum. With several, each block
// writes its sums to partial [splits, C] (fp32 scratch of the caller), and
// the block of the strip that arrives last (an integer counter per strip,
// counters[], zero before the launch and left zero after it) adds the
// strip's splits in index order. No float atomics: the order of every add is
// fixed by the plan, so a rerun gives the same bits.
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kSumUnroll = 4;
constexpr int kSumMaxSplits = 32;

template <int kBytes> struct RawLoad;
template <> struct RawLoad<16> { using type = uint4; };
template <> struct RawLoad<8> { using type = uint2; };
template <> struct RawLoad<4> { using type = unsigned int; };
template <> struct RawLoad<2> { using type = unsigned short; };

// V consecutive values of T, read as one access.
template <typename T, int V>
struct Chunk {
  using Raw = typename RawLoad<V * sizeof(T)>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ __forceinline__ void add_to(float (&acc)[V]) const {
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += to_f(v[i]);
  }
};

template <int V>
__device__ __forceinline__ void store_floats(float* dst, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads)
col_sum_kernel(const T* __restrict__ in, float* __restrict__ out, float* __restrict__ partial,
               unsigned* __restrict__ counters, int R, int C, int ty, int split_rows) {
  __shared__ __align__(16) float red[kSumThreads * V];  // [ty][strip columns]
  __shared__ unsigned arrived;
  const int tx = kSumThreads / ty, x = threadIdx.x % tx, y = threadIdx.x / tx;
  const int strip = tx * V, c_strip = blockIdx.x * strip, c = c_strip + x * V;
  const int r0 = blockIdx.y * split_rows, r1 = min(R, r0 + split_rows);
  const int splits = gridDim.y;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (c < C) {  // C % V == 0: the V columns are all in or all out
    const T* p = in + c;
    for (int r = r0 + y; r < r1; r += kSumUnroll * ty) {
      Chunk<T, V> ch[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        if (r + u * ty < r1) ch[u].load(p + (size_t)(r + u * ty) * C);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        if (r + u * ty < r1) ch[u].add_to(acc);
    }
  }
  // this block's sums of the strip's columns: the result, or its split's row
  // of the partial sums
  float* dst = splits == 1 ? out : partial + (size_t)blockIdx.y * C;
  if (ty == 1) {
    if (c < C) store_floats<V>(dst + c, acc);
  } else {
    store_floats<V>(red + y * strip + x * V, acc);
    __syncthreads();
    for (int k = threadIdx.x; k < strip && c_strip + k < C; k += kSumThreads) {
      float v = red[k];
      for (int yy = 1; yy < ty; ++yy) v += red[yy * strip + k];
      dst[c_strip + k] = v;
    }
  }
  if (splits == 1) return;

  __threadfence();  // this block's partial sums before its arrival
  __syncthreads();
  if (threadIdx.x == 0) arrived = atomicAdd(counters + blockIdx.x, 1u);
  __syncthreads();
  if (arrived != (unsigned)splits - 1) return;
  __threadfence();
  for (int k = threadIdx.x; k < strip && c_strip + k < C; k += kSumThreads) {
    const float* p = partial + c_strip + k;
    float v[kSumMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kSumMaxSplits; ++sp)
      if (sp < splits) v[sp] = __ldcg(p + (size_t)sp * C);  // from L2: other blocks' writes
    float t = v[0];
#pragma unroll
    for (int sp = 1; sp < kSumMaxSplits; ++sp)
      if (sp < splits) t += v[sp];
    out[c_strip + k] = t;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <typename T, int V>
cudaError_t launch_col_sum_vec(const void* in, float* out, float* partial, unsigned* counters,
                               int R, int C, int ty, int split_rows, cudaStream_t s) {
  const int splits = (R + split_rows - 1) / split_rows;
  const int strip = kSumThreads / ty * V;
  const dim3 grid((C + strip - 1) / strip, splits);
  col_sum_kernel<T, V><<<grid, kSumThreads, 0, s>>>(static_cast<const T*>(in), out, partial,
                                                     counters, R, C, ty, split_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_col_sum(const void* in, float* out, float* partial, unsigned* counters,
                           int R, int C, int vec, int ty, int split_rows, cudaStream_t s) {
  if (vec * sizeof(T) > 16 || C % vec || reinterpret_cast<uintptr_t>(in) % (vec * sizeof(T)))
    return cudaErrorInvalidValue;
  switch (vec) {
    case 1:
      return launch_col_sum_vec<T, 1>(in, out, partial, counters, R, C, ty, split_rows, s);
    case 2:
      return launch_col_sum_vec<T, 2>(in, out, partial, counters, R, C, ty, split_rows, s);
    case 4:
      return launch_col_sum_vec<T, 4>(in, out, partial, counters, R, C, ty, split_rows, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_col_sum_vec<T, 8>(in, out, partial, counters, R, C, ty, split_rows, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// tn = 0: out = a [M, K] . b [N, K]^T in fp32 (out_f32) or the compute
// dtype; tn = 1: out = a [K, M]^T . b [K, N] in fp32. [splits, M, N] for
// splits = ceil(K / kslice) > 1 (fp32 only, or bf16 TN; kslice a multiple
// of 64 in bf16, of 8 in fp32), else [M, N]. bf16 operands 16-byte aligned.
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
      head_dim > 128 || s_valid < 1 || s_valid > S || (size_t)B * heads > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_core_bwd<float>(qkv, dctx, ctx, dqkv, B, S, heads, head_dim, causal,
                                  s_valid, s);
  if (dtype == plip::kBF16) {
    if (head_dim != kWgD)
      return launch_core_bwd<plip::bf16>(qkv, dctx, ctx, dqkv, B, S, heads, head_dim, causal,
                                         s_valid, s);
    if (B > 65535 || heads > 65535) return cudaErrorInvalidValue;
    return launch_core_bwd_wgmma(qkv, dctx, ctx, dqkv, B, S, heads, causal, s_valid, s);
  }
  return cudaErrorInvalidValue;
}

// dln: fp32 (dln_f32) or the compute dtype; g: null for dx = cast(dx_ln).
// The plan (ops/attention.py ln_layout, ops/attention_bwd.py ln_bwd_split):
// vec, values, warps as launch_ln_bwd_rows takes them, rows_per_block;
// partial: [ceil(rows / rows_per_block), 2 * width] fp32.
int plip_ln_bwd_rows(const void* x, const void* dln, const void* g, const float* gamma,
                     void* dx, float* partial, int rows, int width, int vec, int values,
                     int warps, int rows_per_block, float eps, int dtype, int dln_f32,
                     int device, void* stream) {
  if (rows <= 0 || width <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_ln_bwd_rows<float, float>(x, dln, g, gamma, dx, partial, rows, width, vec,
                                            values, warps, rows_per_block, eps, s);
  if (dtype == plip::kBF16 && dln_f32)
    return launch_ln_bwd_rows<plip::bf16, float>(x, dln, g, gamma, dx, partial, rows, width,
                                                 vec, values, warps, rows_per_block, eps, s);
  if (dtype == plip::kBF16)
    return launch_ln_bwd_rows<plip::bf16, plip::bf16>(x, dln, g, gamma, dx, partial, rows,
                                                      width, vec, values, warps,
                                                      rows_per_block, eps, s);
  return cudaErrorInvalidValue;
}

// in: [rows, cols] fp32 or bf16 (dtype); out: [cols] fp32. The plan (the
// col_sum section above): vec columns a load, ty rows a block, split_rows
// rows a split; with more than one split, partial: fp32 [splits, cols] and
// counters: one per column strip, zero.
int plip_col_sum(const void* in, float* out, float* partial, unsigned* counters, int rows,
                 int cols, int vec, int ty, int split_rows, int dtype, int device,
                 void* stream) {
  if (rows <= 0 || cols <= 0 || vec <= 0 || ty <= 0 || ty > 32 || kSumThreads % ty ||
      split_rows <= 0)
    return cudaErrorInvalidValue;
  const int splits = (rows + split_rows - 1) / split_rows;
  if (splits > kSumMaxSplits || (splits > 1 && (!partial || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plip::kF32)
    return launch_col_sum<float>(in, out, partial, counters, rows, cols, vec, ty, split_rows,
                                 s);
  if (dtype == plip::kBF16)
    return launch_col_sum<plip::bf16>(in, out, partial, counters, rows, cols, vec, ty,
                                      split_rows, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
