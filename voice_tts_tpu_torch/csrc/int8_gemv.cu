// K4: int8 weight-only GEMV for a few rows, y = (x @ W) * scale.
//
// Replaces: voice_tts_tpu/ops/int8_matmul.py `int8_gemv` (Pallas kernel
// `_kernel`): x (N <= 32, D) bf16 (or f32, which the Pallas kernel also
// takes and multiplies in f32), W (D, F) int8 in the JAX (in, out) layout,
// per-output-column scale (F,) f32; f32 accumulation, dequantized in-kernel.
//
// Bound on the H100: device memory.  At N <= 32 rows each weight byte feeds
// at most 32 multiply-adds, so the int8 weight stream (D*F bytes) sets the
// time; the products are exact in f32 (bf16 x int8 fits 16 mantissa bits).
// Design: one block per 128-column stripe and 8-row slab of x.  A warp reads
// whole 128-byte row segments of W (4 int8 per lane, neighbouring lanes on
// neighbouring addresses, coalesced), the 8 warps split the contraction dim,
// and a shared-memory pass sums the warps' partials before the scale.  The
// int8 weight is never widened in device memory.
#include "common.cuh"

namespace {

constexpr int G_COLS = 128;   // output columns per block (4 per lane)
constexpr int G_ROWS = 8;     // rows of x per block
constexpr int G_WARPS = 8;    // contraction split

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if constexpr (kBf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return reinterpret_cast<const float*>(x)[i];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(G_WARPS * 32)
int8_gemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int n_rows, int d, int f) {
  __shared__ float part[G_WARPS][G_ROWS][G_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * G_COLS + lane * 4;
  const int row0 = blockIdx.y * G_ROWS;
  const int rows = min(G_ROWS, n_rows - row0);

  float acc[G_ROWS][4];
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  if (col0 < f) {
    for (int k = warp; k < d; k += G_WARPS) {
      const char4 q = *reinterpret_cast<const char4*>(w + (size_t)k * f + col0);
      const float wq[4] = {(float)q.x, (float)q.y, (float)q.z, (float)q.w};
#pragma unroll
      for (int r = 0; r < G_ROWS; ++r) {
        if (r < rows) {
          const float xv = load_x<kBf16>(x, (size_t)(row0 + r) * d + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] += xv * wq[j];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][r][lane * 4 + j] = acc[r][j];
  __syncthreads();

  for (int i = threadIdx.x; i < G_ROWS * G_COLS; i += blockDim.x) {
    const int r = i / G_COLS, c = i % G_COLS;
    const int col = blockIdx.x * G_COLS + c;
    if (r < rows && col < f) {
      float s = 0.0f;
#pragma unroll
      for (int g = 0; g < G_WARPS; ++g) s += part[g][r][c];
      out[(size_t)(row0 + r) * f + col] = s * scale[col];
    }
  }
}

}  // namespace

// x: (n_rows, d) bf16 (x_is_bf16 = 1) or f32;
// w: (d, f) int8, f % 4 == 0, 4-byte aligned; scale: (f,) f32;
// out: (n_rows, f) f32.
VTT_EXPORT int vtt_int8_gemv(const void* x, int x_is_bf16, const int8_t* w,
                             const float* scale, float* out, int n_rows, int d,
                             int f, void* stream) {
  dim3 grid((f + G_COLS - 1) / G_COLS, (n_rows + G_ROWS - 1) / G_ROWS);
  if (x_is_bf16) {
    int8_gemv_kernel<true><<<grid, G_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, w, scale, out, n_rows, d, f);
  } else {
    int8_gemv_kernel<false><<<grid, G_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, w, scale, out, n_rows, d, f);
  }
  return (int)cudaGetLastError();
}
