// K4: int8 weight-only GEMV for a few rows, y = (x @ W) * scale.
//
// Replaces: voice_tts_tpu/ops/int8_matmul.py `int8_gemv` (Pallas kernel
// `_kernel`): x (N <= 32, D) bf16 (or f32, which the Pallas kernel also
// takes and multiplies in f32), W (D, F) int8 in the JAX (in, out) layout,
// per-output-column scale (F,) f32; f32 accumulation, dequantized in-kernel,
// output in x's dtype.
//
// Bound on the H100: device memory.  At N <= 32 rows each weight byte feeds
// at most 32 multiply-adds, so the int8 weight stream (D*F bytes: 19.7 MB
// for a GPT layer's four products at D 1280, 5.9 us at 3.35 TB/s) sets the
// time; the products are exact in f32 (bf16 x int8 fits 16 mantissa bits).
//
// Design: the stream stage of the int8 tile micro-benchmark (K12 `dot1` /
// `dot8`, csrc/micro_tile.cu), over one (D, F) matrix with the contraction
// split across blocks so that the grid fills the card.  A block owns a
// 128-column stripe (one 128-byte segment a weight row), a slice of
// `split_rows` contraction rows and a slab of NB <= 8 rows of x; the
// planner (`plan_int8_gemv`, ops/int8_matmul.py) picks the split so that
// every shape launches at least two blocks an SM.  The block first puts the
// first chunks of its weight slice in flight (a 4-stage cp.async ring of
// 32-row chunks, 16 bytes a thread: the weights are read-only, so under
// programmatic dependent launch these copies overlap the previous kernel),
// then waits for the previous launch and stages its x slab in shared memory
// as f32 once.  A lane owns 4 columns (one 32-bit word a row) and the 8
// warps split each chunk's rows; each byte is converted with a byte
// permute (no I2F), and the warps' sums are added in warp order.  The
// split partials go to an f32 workspace; a second kernel adds them in split
// order (no atomics: two calls give bit-identical outputs), multiplies by
// the scale and writes x's dtype with round-to-nearest-even.
#include "common.cuh"

namespace {

constexpr int kCols = 128;       // output columns a block owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;       // weight rows a ring stage holds (4 KB)
constexpr int kStages = 4;
constexpr int kMaxSlab = 8;      // rows of x a block takes
constexpr int kMaxSplitRows = 1024;

size_t partial_smem_bytes(int nb, int split_rows) {
  return (size_t)kStages * kChunk * kCols + (size_t)split_rows * nb * 4
         + (size_t)kWarps * nb * kCols * 4;
}

// partial[split, row, col] = sum over the block's contraction rows k of
// x[row, k] * W[k, col], for the block's stripe, split and slab of NB rows.
// Dynamic shared memory: the ring, the x slab [split_rows][NB] f32 (zero
// past D and past N), the warps' sums [kWarps][NB][kCols].
template <int NB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_partial(const void* __restrict__ x, int x_bf16,
                  const int8_t* __restrict__ w, float* __restrict__ partial,
                  int n_rows, int d, int f, int split_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);                      // [kStages][kChunk][kCols]
  float* xs = reinterpret_cast<float*>(smem + kStages * kChunk * kCols);
  float* red = xs + (size_t)split_rows * NB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * split_rows;
  const int k1 = min(d, k0 + split_rows);
  const int row0 = blockIdx.z * NB;
  const int n_chunks = (k1 - k0 + kChunk - 1) / kChunk;

  // the chunk loader: 32 rows x 128 bytes, one 16-byte copy a thread; rows
  // past the slice and columns past F are not copied (their x is zero, or
  // their output is not written)
  const int ld_row = tid >> 3, ld_seg = (tid & 7) * 16;
  const bool ld_cols = col0 + ld_seg < f;
  auto load = [&](int c) {
    const int k = k0 + c * kChunk + ld_row;
    if (c < n_chunks && k < k1 && ld_cols) {
      vtt::cp_async16(ring + ((size_t)(c % kStages) * kChunk + ld_row) * kCols + ld_seg,
                      w + (size_t)k * f + col0 + ld_seg);
    }
    vtt::cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // x is the previous launch's output: staged only after the wait
  vtt::grid_dependency_wait();
  const int span = n_chunks * kChunk;
  for (int i = tid; i < NB * span; i += kThreads) {
    const int r = i / span, kk = i % span;
    const int row = row0 + r, k = k0 + kk;
    float v = 0.0f;
    if (row < n_rows && k < k1) {
      const size_t at = (size_t)row * d + k;
      v = x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[at])
                 : reinterpret_cast<const float*>(x)[at];
    }
    xs[(size_t)kk * NB + r] = v;
  }

  float acc[NB][4];
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    vtt::cp_async_wait<kStages - 2>();
    __syncthreads();                        // chunk c landed; the x slab is staged
    load(c + kStages - 1);
    const int8_t* chunk = ring + (size_t)(c % kStages) * kChunk * kCols;
    const int kr = warp * 4;                // this warp's 4 rows of the chunk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned biased =
          *reinterpret_cast<const unsigned*>(chunk + (kr + i) * kCols + lane * 4) ^ 0x80808080u;
      float wf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wf[j] = vtt::byte_to_f32(biased, j);
      const float* xk = xs + (size_t)(c * kChunk + kr + i) * NB;
      float xv[NB];
      if constexpr (NB % 4 == 0) {
#pragma unroll
        for (int r = 0; r < NB; r += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xk + r);
          xv[r] = v.x; xv[r + 1] = v.y; xv[r + 2] = v.z; xv[r + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < NB; ++r) xv[r] = xk[r];
      }
#pragma unroll
      for (int r = 0; r < NB; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv[r], wf[j], acc[r][j]);
    }
  }
  vtt::cp_async_wait<0>();
  vtt::launch_dependents();

  // the warps' sums in warp order
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    *reinterpret_cast<float4*>(red + ((size_t)warp * NB + r) * kCols + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int i = tid; i < NB * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int row = row0 + r, col = col0 + c;
    if (row < n_rows && col < f) {
      float s = 0.0f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) s += red[((size_t)g * NB + r) * kCols + c];
      partial[((size_t)blockIdx.y * n_rows + row) * f + col] = s;
    }
  }
}

// out[i] = (partial[0, i] + partial[1, i] + ...) * scale[col], in split
// order, written in x's dtype.
template <bool kBf16>
__global__ void __launch_bounds__(256)
int8_gemv_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                 void* __restrict__ out, int n, int f, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float sc = i < n ? scale[i % f] : 0.0f;   // read-only: before the wait
  vtt::grid_dependency_wait();
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * n + i];
  const float y = s * sc;
  if constexpr (kBf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  } else {
    reinterpret_cast<float*>(out)[i] = y;
  }
}

template <int NB>
cudaError_t launch_partial(const void* x, int x_bf16, const int8_t* w, float* partial,
                           int n_rows, int d, int f, int split_rows, int splits,
                           cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(NB, split_rows);
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)int8_gemv_partial<NB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((f + kCols - 1) / kCols, splits, (n_rows + NB - 1) / NB);
  return vtt::launch_pdl(int8_gemv_partial<NB>, grid, dim3(kThreads), smem, stream,
                         x, x_bf16, w, partial, n_rows, d, f, split_rows);
}

}  // namespace

// x: (n_rows, d) bf16 (x_is_bf16 = 1) or f32; w: (d, f) int8, f % 16 == 0,
// 16-byte aligned; scale: (f,) f32; partial: (splits, n_rows, f) f32
// scratch; out: (n_rows, f) in x's dtype.  slab (1, 2, 4 or 8 rows of x a
// block), split_rows (a multiple of 32, at most 1024) and splits (the
// contraction cut into splits slices of split_rows, the last one shorter)
// come from the planner.  Two launches, both with programmatic dependent
// launch: the partial products and their fixed-order sum.
VTT_EXPORT int vtt_int8_gemv(const void* x, int x_is_bf16, const int8_t* w,
                             const float* scale, float* partial, void* out,
                             int n_rows, int d, int f, int slab, int split_rows,
                             int splits, void* stream) {
  if (n_rows < 1 || n_rows > 4 * kMaxSlab || f % 16 != 0 || split_rows % kChunk != 0
      || split_rows < kChunk || split_rows > kMaxSplitRows || splits < 1
      || (splits - 1) * split_rows >= d || splits * split_rows < d) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (slab) {
    case 1: err = launch_partial<1>(x, x_is_bf16, w, partial, n_rows, d, f, split_rows, splits, s); break;
    case 2: err = launch_partial<2>(x, x_is_bf16, w, partial, n_rows, d, f, split_rows, splits, s); break;
    case 4: err = launch_partial<4>(x, x_is_bf16, w, partial, n_rows, d, f, split_rows, splits, s); break;
    case 8: err = launch_partial<8>(x, x_is_bf16, w, partial, n_rows, d, f, split_rows, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n = n_rows * f;
  const dim3 grid((n + 255) / 256);
  err = x_is_bf16
      ? vtt::launch_pdl(int8_gemv_reduce<true>, grid, dim3(256), 0, s, partial, scale, out, n, f, splits)
      : vtt::launch_pdl(int8_gemv_reduce<false>, grid, dim3(256), 0, s, partial, scale, out, n, f, splits);
  return (int)err;
}
