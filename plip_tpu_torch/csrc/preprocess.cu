// Image preprocessing in one kernel, by hand for Hopper (sm_90a):
//
//   t[y, j]   = q( sum_x img[y, x, c] . C[j, x] )      width pass
//   y[i, j]   = q( sum_y R[i, y] . t[y, j] )           height pass
//   out[i, j] = (y[i, j] - 255 mean_c) / (255 std_c)
//
// per image and channel, q(v) = clip(floor(v + 0.5), 0, 255) (PIL's uint8
// store; identity with emulate = 0), R [out, H] and C [out, W] the bicubic
// resize-and-crop matrices (plip_tpu_torch/ops/resize.py). Replaces
// plip_tpu/ops/preprocess_pallas.py:36 _kernel (wrapper
// preprocess_batch_pallas, :62).
//
// The TPU kernel took one (image, channel) plane a program with both dense
// passes on the MXU and an int8 input shifted by 128 (Mosaic had no u8 -> f32
// cast). Here a block (256 threads) takes `rows` output rows of one image,
// all three channels, and the band of input rows y0 .. y0 + ny that they
// need (the host's plan, ops/preprocess_fused.py):
//
//   1. the band streams through a ring of two buffers in shared memory, a
//      chunk of rows at a time. A chunk is one contiguous run of bytes: its
//      16-byte-aligned middle comes by cp.async, its unaligned head and tail
//      (the band of a 700-pixel row starts anywhere) by byte loads that are
//      stored after the width pass they overlap. The next chunk's copies are
//      in flight while the width pass reads this one;
//   2. width pass: a job is one pixel's three channels in 4 rows of the chunk
//      (byte loads) or, for windows of 8 taps or more, 2 rows (four taps of
//      a row as three 32-bit loads aligned by funnel shifts); its column's
//      tap table (first input column, weights) is in shared memory. t is
//      uint8 with emulate (q leaves an integer 0..255, so the store is
//      exact), fp32 without;
//   3. height pass: a job is 8 values of one output row, from the rows of t
//      its tap table names, then q and the normalize, stored 16 bytes at a
//      time. With emulate the normalize is a table of the 3 x 256 values it
//      can give; without, the divide.
//
// Bound: bytes on this card (256 tiles 256^2 -> 224: 50 MB in, 154 MB of
// fp32 out, 0.061 ms), but the work sets the time: about 2 M FMAs an image
// at 256^2 -> 224, each with its operand's uint8 -> fp32 conversion (I2F, or
// a byte permute into the float 2^23 + b less 2^23), the loads of shared
// memory that feed them, and the table lookups. So the jobs amortise a
// weight load over 6-12 FMAs and a t load and its conversions over 8 FMAs,
// keep index arithmetic out of the tap loops, and the plan fits three
// blocks an SM, whose loads, passes and stores overlap. q is floor(v + 0.5)
// by a round-down add of 2^23, not floorf.
//
// Every sum is the old kernel's: fp32 fmaf from 0 over the row's taps in
// ascending order. A tap table row is its matrix row over [start, start +
// taps), a window that holds the row's nonzero extent; its entries outside
// the extent are the matrix's zeros, and fmaf(0, v, acc) = acc for the
// finite v here. The normalize's table holds the quotients the IEEE divide
// gives: fp32 output is the old kernel's to the bit, bf16 output that value
// rounded once (to nearest even, as .to(torch.bfloat16) rounds). No
// atomics: reruns are bit-equal.
//
// The entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it does
// not take) so the caller can raise.

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "cp_async.cuh"

namespace {

namespace hopper = plip::hopper;

constexpr int kThreads = 256;
constexpr int kVec = 8;       // output values a height-pass job (load_t reads 8)
constexpr int kByteRows = 4;  // rows a width-pass job, byte loads
constexpr int kWordRows = 2;  // rows a width-pass job, word loads
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kTwo23 = 8388608.f;  // 2^23 + b, b an integer below 2^23, is exact in fp32

struct Params {
  const uint8_t* img;  // [B, H, W, 3]
  const int* c_start;  // [n]: output column j's first input column
  const float* c_w;    // [n, cw_stride]: its taps' weights (taps_c of them)
  const int* r_start;  // [n]: output row i's first input row
  const float* r_w;    // [n, taps_r]: its taps' weights
  const int* band;     // [blocks, 2]: a block's first input row and its count
  void* out;           // [B, n, n, 3]
  int B, H, W, n, taps_c, cw_stride, taps_r, rows, blocks, ny_max, chunk_rows, words, vec_store;
  float m0, m1, m2, s0, s1, s2;  // 255 mean_c, 255 std_c
};

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~size_t(15); }

// Byte offsets of a block's shared memory, every part 16-byte aligned. The
// host's plan counts the same (ops/preprocess_fused.smem_bytes); the entry
// point refuses a plan whose count differs.
struct Layout {
  size_t lut, c_start, c_w, r_start, r_w, t, t_stride, ring, ring_bytes, total;
};

__host__ __device__ inline Layout layout(const Params& p, bool emulate, int out_bytes) {
  Layout L;
  size_t o = 0;
  L.lut = o;
  o += up16(emulate ? 3 * 256 * out_bytes : 0);
  L.c_start = o;
  o += up16(4 * (size_t)p.n);
  L.c_w = o;
  o += up16(4 * (size_t)p.n * p.cw_stride);
  L.r_start = o;
  o += up16(4 * (size_t)p.rows);
  L.r_w = o;
  o += up16(4 * (size_t)p.rows * p.taps_r);
  L.t_stride = up16(3 * (size_t)p.n * (emulate ? 1 : 4));
  L.t = o;
  o += (size_t)p.ny_max * L.t_stride;
  // a chunk, its start's shift (< 16) and the 4 bytes a word load reads past a row
  L.ring_bytes = up16((size_t)p.chunk_rows * 3 * p.W + 32);
  L.ring = o;
  o += 2 * L.ring_bytes;
  L.total = o;
  return L;
}

// Byte e of w as a float: a byte permute makes the float 2^23 + b, less 2^23.
template <int e>
__device__ __forceinline__ float byte_f(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B00u, 0x5440u | e)) - kTwo23;
}

// Byte e of w as a float by the integer conversion.
template <int e>
__device__ __forceinline__ float byte_i2f(uint32_t w) {
  return __uint2float_rn((w >> (8 * e)) & 255u);
}

// q(v) + 2^23 as a float, whose low byte is q: floor(v + 0.5) as v + 0.5
// (rounded to nearest, as floorf(v + 0.5f) takes it) plus 2^23 rounded down,
// then clamped; a NaN gives 0, as fmaxf takes it.
__device__ __forceinline__ float quant_bits(float v) {
  return fminf(fmaxf(__fadd_rd(v + 0.5f, kTwo23), kTwo23), kTwo23 + 255.f);
}

__device__ __forceinline__ float pick3(int c, float a, float b, float d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

// A width-pass sum as t holds it.
__device__ __forceinline__ void store_t(uint8_t* t, float v) {
  *t = static_cast<uint8_t>(__float_as_uint(quant_bits(v)));
}
__device__ __forceinline__ void store_t(float* t, float v) { *t = v; }

// The kVec (8) values of a row of t at an 8-byte (uint8) or 32-byte (fp32)
// aligned address.
__device__ __forceinline__ void load_t(const uint8_t* s, float* v) {
  const uint2 w = *reinterpret_cast<const uint2*>(s);
  v[0] = byte_i2f<0>(w.x), v[1] = byte_i2f<1>(w.x), v[2] = byte_i2f<2>(w.x);
  v[3] = byte_i2f<3>(w.x), v[4] = byte_i2f<0>(w.y), v[5] = byte_i2f<1>(w.y);
  v[6] = byte_i2f<2>(w.y), v[7] = byte_i2f<3>(w.y);
}
__device__ __forceinline__ void load_t(const float* s, float* v) {
  const float4 a = reinterpret_cast<const float4*>(s)[0], b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// A chunk's head and tail bytes on their way: a thread's load of at most one
// of each, stored to shared memory by commit(). The loads are issued with
// the chunk's cp.async and stored after the work they overlap.
struct Pending {
  uint8_t* d0 = nullptr;
  uint8_t* d1 = nullptr;
  uint32_t v0 = 0, v1 = 0;
  __device__ __forceinline__ void commit() const {
    if (d0) *d0 = static_cast<uint8_t>(v0);
    if (d1) *d1 = static_cast<uint8_t>(v1);
  }
};

// Bytes src[0, len) to dst[shift + k], shift = src's address mod 16, so that
// the 16-byte pieces are aligned on both sides: the middle by cp.async (one
// group, committed by every thread), the head (threads 0-15) and the tail
// (threads 32-47), fewer than 16 bytes each, by loads left pending.
__device__ __forceinline__ Pending load_run(const uint8_t* src, int len, uint8_t* dst,
                                            int& shift) {
  shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(len, (16 - shift) & 15);
  const int nvec = (len - head) >> 4, tail = head + (nvec << 4);
  uint8_t* d = dst + shift;
  const uint32_t mid = hopper::smem_u32(d + head);
  for (int v = threadIdx.x; v < nvec; v += kThreads)
    hopper::cp_async16(mid + 16 * v, src + head + 16 * v, true);
  hopper::cp_async_commit();
  Pending pd;
  const int k0 = threadIdx.x, k1 = tail + threadIdx.x - 32;
  if (k0 < head) {
    pd.d0 = d + k0;
    pd.v0 = __ldg(src + k0);
  }
  if (threadIdx.x >= 32 && k1 < len) {
    pd.d1 = d + k1;
    pd.v1 = __ldg(src + k1);
  }
  return pd;
}

// One width-pass job: a pixel's three channels in kR rows of the chunk from
// px (its window in the first row); rows at or past rows_left read the last
// row again and are not stored. Byte loads, each byte converted by I2F.
template <int kR, typename TT>
__device__ __forceinline__ void width_bytes(const uint8_t* px, int W3, int rows_left,
                                            const float* w, int taps, TT* o, int ts) {
  float a[kR][3];
  int off[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    a[r][0] = a[r][1] = a[r][2] = 0.f;
    off[r] = min(r, rows_left - 1) * W3;
  }
  for (int k = 0; k < taps; ++k, px += 3) {
    const float wk = w[k];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) a[r][c] = fmaf(wk, __uint2float_rn(px[off[r] + c]), a[r][c]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r < rows_left)
#pragma unroll
      for (int c = 0; c < 3; ++c) store_t(o + r * ts + c, a[r][c]);
}

// The same job with word loads, for wide windows: four taps (12 bytes) of a
// row are three 32-bit loads and three funnel shifts that align the bytes,
// each converted by a byte permute; taps past the last four a byte at a
// time. Reads up to 4 bytes past a row.
template <int kR, typename TT>
__device__ __forceinline__ void width_words(const uint8_t* px, int W3, int rows_left,
                                            const float* w, int taps, TT* o, int ts) {
  float a[kR][3];
  const uint8_t* pr[kR];
  const uint32_t* wp[kR];
  uint32_t sh[kR], x0[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    a[r][0] = a[r][1] = a[r][2] = 0.f;
    pr[r] = px + min(r, rows_left - 1) * W3;
    wp[r] = reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(pr[r]) & ~uintptr_t(3));
    sh[r] = (reinterpret_cast<uintptr_t>(pr[r]) & 3) * 8;
    x0[r] = wp[r][0];
  }
  int k = 0;
  for (; k + 4 <= taps; k += 4) {
    const float w0 = w[k], w1 = w[k + 1], w2 = w[k + 2], w3 = w[k + 3];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const uint32_t x1 = wp[r][1], x2 = wp[r][2], x3 = wp[r][3];
      const uint32_t b0 = __funnelshift_r(x0[r], x1, sh[r]);  // bytes 0-3 of the four taps
      const uint32_t b1 = __funnelshift_r(x1, x2, sh[r]);     // 4-7
      const uint32_t b2 = __funnelshift_r(x2, x3, sh[r]);     // 8-11
      x0[r] = x3;
      wp[r] += 3;
      a[r][0] = fmaf(w0, byte_f<0>(b0), a[r][0]);
      a[r][1] = fmaf(w0, byte_f<1>(b0), a[r][1]);
      a[r][2] = fmaf(w0, byte_f<2>(b0), a[r][2]);
      a[r][0] = fmaf(w1, byte_f<3>(b0), a[r][0]);
      a[r][1] = fmaf(w1, byte_f<0>(b1), a[r][1]);
      a[r][2] = fmaf(w1, byte_f<1>(b1), a[r][2]);
      a[r][0] = fmaf(w2, byte_f<2>(b1), a[r][0]);
      a[r][1] = fmaf(w2, byte_f<3>(b1), a[r][1]);
      a[r][2] = fmaf(w2, byte_f<0>(b2), a[r][2]);
      a[r][0] = fmaf(w3, byte_f<1>(b2), a[r][0]);
      a[r][1] = fmaf(w3, byte_f<2>(b2), a[r][1]);
      a[r][2] = fmaf(w3, byte_f<3>(b2), a[r][2]);
    }
  }
  for (; k < taps; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) a[r][c] = fmaf(wk, __uint2float_rn(pr[r][3 * k + c]), a[r][c]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r < rows_left)
#pragma unroll
      for (int c = 0; c < 3; ++c) store_t(o + r * ts + c, a[r][c]);
}

// The width pass over a chunk of nr rows (t's rows r0 ..): jobs of kR rows
// of one output column; q / n = umulhi(q, n_inv).
template <int kR, bool kWords, typename TT>
__device__ __forceinline__ void width_pass(const Params& p, const uint8_t* chunk, int nr,
                                           const int* cs, const float* cw, uint32_t n_inv,
                                           TT* t, int ts) {
  const int n = p.n, W3 = 3 * p.W;
  const int jobs = (nr + kR - 1) / kR * n;
  for (int q = threadIdx.x; q < jobs; q += kThreads) {
    const int jr = __umulhi(q, n_inv), j = q - jr * n, yl = jr * kR;
    const uint8_t* px = chunk + yl * W3 + cs[j];
    TT* o = t + yl * ts + 3 * j;
    if constexpr (kWords)
      width_words<kR>(px, W3, nr - yl, cw + j * p.cw_stride, p.taps_c, o, ts);
    else
      width_bytes<kR>(px, W3, nr - yl, cw + j * p.cw_stride, p.taps_c, o, ts);
  }
}

// Height pass: job g of row i makes its values kVec g .. kVec g + kVec - 1
// from the rows of t that its tap table names.
template <bool kEmulate, typename TOut, typename TT>
__device__ __forceinline__ void height_pass(const Params& p, const TT* t, int ts, const int* rs,
                                            const float* rw, const TOut* lut, TOut* out,
                                            int nrows) {
  const int n3 = 3 * p.n, groups = (n3 + kVec - 1) / kVec;
  const uint32_t g_inv = 0xFFFFFFFFu / groups + 1;  // q / groups = umulhi(q, g_inv)
  for (int q = threadIdx.x; q < nrows * groups; q += kThreads) {
    const int i = __umulhi(q, g_inv), jc = (q - i * groups) * kVec;
    const TT* tr = t + rs[i] * ts + jc;
    const float* w = rw + i * p.taps_r;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    for (int k = 0; k < p.taps_r; ++k, tr += ts) {
      float v[kVec];
      load_t(tr, v);
      const float wk = w[k];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(wk, v[e], acc[e]);
    }
    TOut o[kVec];
    int c = jc % 3;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (kEmulate)
        o[e] = lut[(c << 8) | (__float_as_uint(quant_bits(acc[e])) & 255)];
      else
        o[e] = plip::from_f<TOut>((acc[e] - pick3(c, p.m0, p.m1, p.m2)) /
                                  pick3(c, p.s0, p.s1, p.s2));
      c = c == 2 ? 0 : c + 1;
    }
    TOut* d = out + (size_t)i * n3 + jc;
    if (p.vec_store && jc + kVec <= n3) {
#pragma unroll
      for (int u = 0; u < kVec * (int)sizeof(TOut) / 16; ++u) {
        uint4 x;
        memcpy(&x, o + u * (16 / sizeof(TOut)), sizeof(x));
        reinterpret_cast<uint4*>(d)[u] = x;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (jc + e < n3) d[e] = o[e];
    }
  }
}

// grid = (output row blocks, B).
template <bool kEmulate, typename TOut>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(const Params p) {
  using TT = std::conditional_t<kEmulate, uint8_t, float>;  // t's type
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(p, kEmulate, sizeof(TOut));
  TOut* lut = reinterpret_cast<TOut*>(smem + L.lut);
  int* cs = reinterpret_cast<int*>(smem + L.c_start);
  float* cw = reinterpret_cast<float*>(smem + L.c_w);
  int* rs = reinterpret_cast<int*>(smem + L.r_start);
  float* rw = reinterpret_cast<float*>(smem + L.r_w);
  TT* t = reinterpret_cast<TT*>(smem + L.t);
  uint8_t* ring = smem + L.ring;
  const int tid = threadIdx.x, n = p.n, n3 = 3 * n, W3 = 3 * p.W;
  const int ts = static_cast<int>(L.t_stride / sizeof(TT));  // t's row, in values
  const int i0 = blockIdx.x * p.rows, nrows = min(p.rows, n - i0);
  const int y0 = p.band[2 * blockIdx.x], ny = p.band[2 * blockIdx.x + 1];
  const uint8_t* band = p.img + ((size_t)blockIdx.y * p.H + y0) * W3;
  // q / d = umulhi(q, 2^32 / d + 1) while q d < 2^32
  const uint32_t n_inv = 0xFFFFFFFFu / n + 1;

  // The first chunk in flight, then the tables.
  int shift;
  Pending pend = load_run(band, min(ny, p.chunk_rows) * W3, ring, shift);
  for (int k = tid; k < n; k += kThreads) cs[k] = 3 * p.c_start[k];  // its byte in a row
  for (int k = tid; k < n * p.cw_stride; k += kThreads) cw[k] = p.c_w[k];
  for (int k = tid; k < nrows; k += kThreads) rs[k] = p.r_start[i0 + k] - y0;  // its row of t
  for (int k = tid; k < nrows * p.taps_r; k += kThreads) rw[k] = p.r_w[(size_t)i0 * p.taps_r + k];
  if (kEmulate)
    for (int k = tid; k < 3 * 256; k += kThreads) {
      const int c = k >> 8;
      lut[k] = plip::from_f<TOut>((static_cast<float>(k & 255) - pick3(c, p.m0, p.m1, p.m2)) /
                                  pick3(c, p.s0, p.s1, p.s2));
    }
  pend.commit();

  // Width pass, a chunk of the band at a time.
  const int chunks = (ny + p.chunk_rows - 1) / p.chunk_rows;
  for (int ck = 0; ck < chunks; ++ck) {
    const int r0 = ck * p.chunk_rows, nr = min(p.chunk_rows, ny - r0);
    int next_shift = 0;
    if (ck + 1 < chunks) {
      const int r1 = r0 + p.chunk_rows;
      pend = load_run(band + (size_t)r1 * W3, min(p.chunk_rows, ny - r1) * W3,
                      ring + ((ck + 1) & 1) * L.ring_bytes, next_shift);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // the chunk (and, the first time, the tables) visible to all
    const uint8_t* chunk = ring + (ck & 1) * L.ring_bytes + shift;
    if (p.words)
      width_pass<kWordRows, true>(p, chunk, nr, cs, cw, n_inv, t + r0 * ts, ts);
    else
      width_pass<kByteRows, false>(p, chunk, nr, cs, cw, n_inv, t + r0 * ts, ts);
    if (ck + 1 < chunks) pend.commit();
    __syncthreads();  // this buffer free for chunk ck + 2; after the last, t whole
    shift = next_shift;
  }

  TOut* out = static_cast<TOut*>(p.out) + ((size_t)blockIdx.y * n + i0) * n3;
  height_pass<kEmulate>(p, t, ts, rs, rw, lut, out, nrows);
}

template <bool kEmulate, typename TOut>
cudaError_t launch(Params p, size_t smem, cudaStream_t stream) {
  const Layout L = layout(p, kEmulate, sizeof(TOut));
  if (L.total != smem || L.total > kMaxSmem) return cudaErrorInvalidValue;
  // 16-byte stores where every job's values start on a 16-byte boundary
  p.vec_store = reinterpret_cast<uintptr_t>(p.out) % 16 == 0 && (3 * p.n) % kVec == 0;
  const auto kernel = preprocess_kernel<kEmulate, TOut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.blocks, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img uint8 [B, H, W, 3] (rows contiguous, any alignment) -> out [B, n_out,
// n_out, 3] in out_dtype (plip::kF32 or kBF16). c_start int32 [n_out], c_w
// fp32 [n_out, cw_stride] (taps_c used): the columns' tap tables; r_start
// int32 [n_out], r_w fp32 [n_out, taps_r]: the rows'; band int32 [ceil(n_out
// / rows), 2]: each block's first input row and its count (at most ny_max),
// over its rows' windows; chunk_rows input rows a load; words: the width
// pass by word loads; smem: the plan's count of a block's shared memory,
// refused unless it is layout()'s.
int plip_preprocess(const void* img, const int* c_start, const float* c_w, const int* r_start,
                    const float* r_w, const int* band, void* out, int B, int H, int W,
                    int n_out, int taps_c, int cw_stride, int taps_r, int rows, int ny_max,
                    int chunk_rows, int words, int smem, float m0, float m1, float m2,
                    float s0, float s1, float s2, int emulate, int out_dtype, int device,
                    void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || W > (1 << 24) || n_out <= 0 ||
      n_out > 65536 || taps_c <= 0 || taps_c > W || cw_stride < taps_c || taps_r <= 0 ||
      taps_r > H || rows <= 0 || ny_max <= 0 || ny_max > H || chunk_rows <= 0 || smem <= 0 ||
      (out_dtype != plip::kF32 && out_dtype != plip::kBF16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Params p{static_cast<const uint8_t*>(img), c_start, c_w, r_start, r_w, band, out, B, H,
                 W, n_out, taps_c, cw_stride, taps_r, rows, (n_out + rows - 1) / rows, ny_max,
                 chunk_rows, words != 0, 0, m0, m1, m2, s0, s1, s2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(smem);
  if (out_dtype == plip::kF32)
    return emulate ? launch<true, float>(p, n, s) : launch<false, float>(p, n, s);
  return emulate ? launch<true, plip::bf16>(p, n, s) : launch<false, plip::bf16>(p, n, s);
}

}  // extern "C"
