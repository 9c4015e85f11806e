// The register row layout that ln_rows (attention_sublayer.cu) and
// ln_bwd_rows (attention_sublayer_bwd.cu) share.
//
// A block is kLnThreads threads, 8 warps. A row is held by `warps` warps (1,
// 2, 4 or 8; the block holds 8 / warps rows at once, one a row group): lane
// t of the group (t = warp in group * 32 + lane) holds the row's chunks t, t
// + 32 * warps, ..., each V consecutive values in registers as loaded
// (LnRaw), at most kChunks of them (kChunks * V values, the register bucket:
// 8, 16, 24 or 32). V is 16 bytes' worth of the row's type, read and written
// as one access, or 1 where the width or a base address does not allow it. The
// row's sums are shuffles within each warp, then, for warps > 1, the warps'
// sums through shared memory behind the group's named barrier, added in warp
// order: every lane of the group gets the same bits, and a rerun too. The
// plan (vec, warps, bucket, grid) is the caller's: ops/attention.py
// ln_layout and ln_rows_plan, ops/attention_bwd.py ln_bwd_split.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace plip {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;

// V fp32 values cast to T (round to nearest even) and stored at p as one
// access, as LnRaw reads them.
template <typename T, int V>
__device__ __forceinline__ void ln_store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    static_assert(V * sizeof(T) % 16 == 0, "a chunk is whole 16-byte units");
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int u = 0; u < V / kPer; ++u) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) e[i] = from_f<T>(v[u * kPer + i]);
      *reinterpret_cast<uint4*>(p + u * kPer) = raw;
    }
  }
}

// V values of T kept as loaded (whole 16-byte units, or one value where V ==
// 1) and converted to fp32 where they are read: a bf16 chunk takes half the
// registers of its fp32 values.
template <typename T, int V>
struct LnRaw {
  static_assert(V == 1 || V * sizeof(T) % 16 == 0, "a chunk is whole 16-byte units");
  static constexpr int kUnits = V == 1 ? 1 : V * (int)sizeof(T) / 16;
  using Unit = std::conditional_t<V == 1, T, uint4>;
  Unit u[kUnits];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 1) {
      u[0] = p[0];
    } else {
#pragma unroll
      for (int k = 0; k < kUnits; ++k) u[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if constexpr (V == 1)
        u[k] = from_f<T>(0.f);
      else
        u[k] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_f(reinterpret_cast<const T*>(u)[i]);
  }
};

// A thread's place in the layout.
struct LnLane {
  int warps;   // warps a row
  int group;   // row group in the block
  int groups;  // row groups a block
  int wig;     // warp in the group
  int t;       // lane in the group
  __device__ explicit LnLane(int warps_) : warps(warps_) {
    const int warp = threadIdx.x >> 5;
    group = warp / warps;
    groups = kLnWarps / warps;
    wig = warp % warps;
    t = wig * 32 + (threadIdx.x & 31);
  }
  // the group's named barrier (0 is __syncthreads)
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(warps * 32) : "memory");
  }
};

// The sums of a[0..kN) over the row group. slot: kN * kLnWarps floats of
// shared memory for this round; a round's slot is not written again before
// every lane of the group has passed the next round's barrier (callers take
// two or three rounds a row, each its own slot).
template <int kN>
__device__ __forceinline__ void ln_group_sum(float (&a)[kN], float* slot, const LnLane& l) {
#pragma unroll
  for (int n = 0; n < kN; ++n) a[n] = warp_sum(a[n]);
  if (l.warps == 1) return;
  float* mine = slot + l.group * l.warps;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int n = 0; n < kN; ++n) mine[n * kLnWarps + l.wig] = a[n];
  }
  l.sync();
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = mine[n * kLnWarps];
    for (int w = 1; w < l.warps; ++w) a[n] += mine[n * kLnWarps + w];
  }
}

// Mean and 1/sqrt(var + eps) of a row held as v[kChunks], V values a chunk
// (fp32 arrays or LnRaw; chunks at or past `chunks` zero): two passes over
// the registers, the variance the mean of squared deviations. slots: two
// rounds' of one sum (ln_group_sum).
template <int V, int kChunks, typename Chunk>
__device__ __forceinline__ void ln_stats(const Chunk (&v)[kChunks], int chunks, int width,
                                         float eps, float* slots, const LnLane& l,
                                         float& mean, float& rstd) {
  float s[1] = {0.f};
#pragma unroll
  for (int k = 0; k < kChunks; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += v[k][i];
  ln_group_sum(s, slots, l);
  mean = s[0] / (float)width;
  float q[1] = {0.f};
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (l.t + k * 32 * l.warps < chunks) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[k][i] - mean;
        q[0] += d * d;
      }
    }
  }
  ln_group_sum(q, slots + kLnWarps, l);
  rstd = rsqrtf(q[0] / (float)width + eps);
}

}  // namespace plip
