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
// cast). Here a block takes TI output rows of one image, all three channels
// (the NHWC input and output rows are read and written whole):
//
//   1. the rows y0..y0+ny of t that those output rows need, every column j
//      and channel, into shared memory: each a sum over the columns x where
//      C[j, :] is not zero, of the uint8 pixel (read as it is) times C[j, x];
//   2. each output element: the sum over the rows y where R[i, :] is not zero
//      of R[i, y] . t[y, j], then q, then the normalize (a divide, as the
//      plain version).
//
// Both passes run in full fp32 on CUDA cores: a TF32 or bf16 product would
// move sums across the .5 boundaries that q rounds at. R and C are banded
// (the bicubic support); their rows' nonzero extents, found on the host,
// bound each sum. A skipped term is an exact zero, so every fp32 sum is the
// dense one's, summed in another order than the plain version's matmul: a
// sum within an ulp of a .5 boundary may round to the neighbouring level.
//
// The entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it does
// not take) so the caller can raise.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float quant(float v, int emulate) {
  return emulate ? fminf(fmaxf(floorf(v + 0.5f), 0.f), 255.f) : v;
}

struct Norm {
  float mean[3], std[3];  // 255 mean_c, 255 std_c
};

// grid = (output row tiles, B). t in shared memory: [ny_max][n_out * 3].
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ img, const float* __restrict__ R,
                  const float* __restrict__ C, const int* __restrict__ r_lo,
                  const int* __restrict__ r_hi, const int* __restrict__ c_lo,
                  const int* __restrict__ c_hi, float* __restrict__ out, int H, int W,
                  int n_out, int rows, Norm norm, int emulate) {
  extern __shared__ float t[];
  const int i0 = blockIdx.x * rows, b = blockIdx.y;
  const int i1 = min(i0 + rows, n_out);
  int y0 = H, y1 = 0;
  for (int i = i0; i < i1; ++i) {
    y0 = min(y0, r_lo[i]);
    y1 = max(y1, r_hi[i]);
  }
  const int ny = max(y1 - y0, 0), row = n_out * 3;
  const uint8_t* base = img + (size_t)b * H * W * 3;

  for (int e = threadIdx.x; e < ny * row; e += kThreads) {
    const int yl = e / row, jc = e % row, j = jc / 3, c = jc % 3;
    const uint8_t* px = base + (size_t)(y0 + yl) * W * 3 + c;
    const float* cj = C + (size_t)j * W;
    float acc = 0.f;
    for (int x = c_lo[j]; x < c_hi[j]; ++x) acc = fmaf((float)px[x * 3], cj[x], acc);
    t[e] = quant(acc, emulate);
  }
  __syncthreads();

  float* o = out + ((size_t)b * n_out + i0) * row;
  for (int e = threadIdx.x; e < (i1 - i0) * row; e += kThreads) {
    const int i = i0 + e / row, jc = e % row, c = jc % 3;
    const float* ri = R + (size_t)i * H;
    float acc = 0.f;
    for (int y = r_lo[i]; y < r_hi[i]; ++y) acc = fmaf(ri[y], t[(y - y0) * row + jc], acc);
    o[e] = (quant(acc, emulate) - norm.mean[c]) / norm.std[c];
  }
}

}  // namespace

extern "C" {

// img uint8 [B, H, W, 3] -> out fp32 [B, n_out, n_out, 3]. R [n_out, H], C
// [n_out, W] fp32; r_lo/r_hi, c_lo/c_hi int32 [n_out]: the nonzero extent
// [lo, hi) of each row of R and C. `rows` output rows a block, whose t takes
// ny_max rows (the most any block needs).
int plip_preprocess(const void* img, const float* R, const float* C, const int* r_lo,
                    const int* r_hi, const int* c_lo, const int* c_hi, float* out, int B,
                    int H, int W, int n_out, int rows, int ny_max, float m0, float m1,
                    float m2, float s0, float s1, float s2, int emulate, int device,
                    void* stream) {
  const size_t smem = sizeof(float) * (size_t)ny_max * n_out * 3;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || n_out <= 0 || rows <= 0 || ny_max < 0 ||
      smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_out + rows - 1) / rows, B);
  preprocess_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), R, C, r_lo, r_hi, c_lo, c_hi, out, H, W, n_out, rows,
      Norm{{m0, m1, m2}, {s0, s1, s2}}, emulate);
  return cudaGetLastError();
}

}  // extern "C"
