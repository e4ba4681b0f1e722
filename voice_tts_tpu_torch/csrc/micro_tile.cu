// K12: the int8 tile-stream micro-benchmark, out = x + sum_t stage(x, w[t]).
//
// Replaces: scripts/micro_tile.py `run` (Pallas kernel `make_kernel`): x
// (8, D) f32 and T int8 (D, D) tiles (288 of 1280 x 1280 at the defaults, a
// decode step's int8 weights, 472 MB); each mode is one template instance
// (see voice_tts_tpu_torch/ops/micro_tile.py for what each computes).
//
// Bound on the H100: device memory.  Every mode moves all T * D * D weight
// bytes (3.35 TB/s: 0.141 ms at the defaults); the products of dot8 are
// 2 * 8 * D * D operations a tile, 8 a weight byte, far below the rate at
// which the card could do them.  That is what the benchmark measures: how
// near the stream floor each compute stage stays.
//
// Design.  Nothing carries from tile to tile inside a call, so the tiles
// spread over the card: a block owns a 128-column slice and a group of 4
// tiles (720 blocks at the defaults for 132 SMs).  It streams each tile's
// whole (D, 128) slab through a 4-stage cp.async ring of 32-row chunks,
// even in `dma` and `convert`, whose output reads only 8 rows: the TPU
// kernel's BlockSpec moves each whole tile into VMEM, and a port that read 8
// rows would time nothing.  A lane owns 4 columns (one 32-bit word a row),
// the 8 warps split each chunk's rows; a tile's term is summed across warps
// in shared memory (int32 for dot8i, cast to f32 only then, as the JAX
// `y.astype(f32)` of each tile) and added to the block's f32 partial.  A
// second pass adds the partials to x in group order: deterministic, no
// atomics.  The f32 -> int8 cast of x saturates (truncation, clamp, NaN ->
// 0) as JAX's does.  CUDA-core FMAs and dp4a; mma.sync / wgmma come later.
#include "common.cuh"

namespace {

constexpr int kRows = 8;         // rows of x
constexpr int kCols = 128;       // columns a block owns (one 128-byte segment)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;       // tile rows a pipeline stage holds (4 KB)
constexpr int kStages = 4;

enum Mode { kDma = 0, kConvert = 1, kDot1 = 2, kDot8 = 3, kDot8i = 4 };

using vtt::byte_to_f32;

// f32 -> int8 as JAX's astype: cvt.rzi truncates toward zero, maps NaN to
// 0 and saturates to int32; the clamp then saturates to int8.
__device__ __forceinline__ int saturate_int8(float v) {
  return min(max(__float2int_rz(v), -128), 127);
}

template <int kMode>
__host__ __device__ __forceinline__ size_t x_smem_bytes(int d) {
  return kMode == kDot1 ? (size_t)d * 4
       : kMode == kDot8 ? (size_t)d * kRows * 4
       : kMode == kDot8i ? (size_t)d * kRows : 0;
}

template <int kMode>
size_t smem_bytes(int d) {
  size_t bytes = (size_t)kStages * kChunk * kCols + x_smem_bytes<kMode>(d);
  if (kMode == kConvert) bytes += (size_t)kChunk * kCols * 2;
  if (kMode >= kDot1) bytes += (size_t)kWarps * kRows * kCols * 4;
  return bytes;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
micro_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  float* __restrict__ partial, int n_tiles, int d,
                  int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);                 // [kStages][kChunk][kCols]
  unsigned char* rest = smem + (size_t)kStages * kChunk * kCols;
  float* xs = reinterpret_cast<float*>(rest);                     // dot1: [D]; dot8: [D][8]
  int* xq = reinterpret_cast<int*>(rest);                         // dot8i: [D / 4][8] packed
  rest += x_smem_bytes<kMode>(d);
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(rest);   // convert: [kChunk][kCols]
  float* red = reinterpret_cast<float*>(rest);                    // dots: [kWarps][8][kCols]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int t0 = blockIdx.y * tiles_per_block;
  const int tiles = min(tiles_per_block, n_tiles - t0);
  const int chunks_per_tile = d / kChunk;
  const int n_chunks = tiles * chunks_per_tile;

  if (kMode == kDot1) {
    for (int k = tid; k < d; k += kThreads) xs[k] = vtt::round_bf16(x[k]);
  } else if (kMode == kDot8) {
    for (int i = tid; i < kRows * d; i += kThreads) {
      const int r = i / d, k = i % d;
      xs[k * kRows + r] = vtt::round_bf16(x[i]);
    }
  } else if (kMode == kDot8i) {
    int8_t* xb = reinterpret_cast<int8_t*>(xq);
    for (int i = tid; i < kRows * d; i += kThreads) {
      const int r = i / d, k = i % d;
      xb[(k / 4) * (kRows * 4) + r * 4 + k % 4] = (int8_t)saturate_int8(x[i]);
    }
  }

  // the chunk loader: 32 rows x 128 bytes, one 16-byte copy a thread
  auto load = [&](int c) {
    if (c < n_chunks) {
      const int t = t0 + c / chunks_per_tile, k0 = (c % chunks_per_tile) * kChunk;
      const int row = tid >> 3, seg = (tid & 7) * 16;
      vtt::cp_async16(ring + ((size_t)(c % kStages) * kChunk + row) * kCols + seg,
                      w + ((size_t)t * d + k0 + row) * d + col0 + seg);
    }
    vtt::cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // this thread's 4 outputs of the block's (8, 128) partial
  const int out_r = (tid * 4) / kCols, out_c = (tid * 4) % kCols;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float accf[kRows][4];
  int acci[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) { accf[r][j] = 0.0f; acci[r][j] = 0; }

  for (int c = 0; c < n_chunks; ++c) {
    vtt::cp_async_wait<kStages - 2>();
    __syncthreads();
    load(c + kStages - 1);
    const int8_t* chunk = ring + (size_t)(c % kStages) * kChunk * kCols;
    const int kc = c % chunks_per_tile;            // chunk index within its tile
    const bool last_of_tile = kc == chunks_per_tile - 1;

    if (kMode == kDma) {
      if (kc == 0) {                               // the tile's rows 0..7 are here
        const unsigned v = *reinterpret_cast<const unsigned*>(chunk + out_r * kCols + out_c);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[j] += byte_to_f32(v ^ 0x80808080u, j);
      }
    } else if (kMode == kConvert) {
      // the whole chunk to bf16 in shared memory, 16 bytes a thread
      const int row = tid >> 3, seg = (tid & 7) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(chunk + row * kCols + seg);
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          conv[row * kCols + seg + q * 4 + j] =
              __float2bfloat16_rn(byte_to_f32(words[q] ^ 0x80808080u, j));
      if (kc == 0) {
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sum[j] += __bfloat162float(conv[out_r * kCols + out_c + j]);
      }
    } else {
      // dots: a warp's 4 consecutive chunk rows, a lane's 4 columns
      const int kr = warp * 4;
      unsigned wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = *reinterpret_cast<const unsigned*>(chunk + (kr + i) * kCols + lane * 4);
      const int k = kc * kChunk + kr;              // contraction row of wv[0]
      if (kMode == kDot8i) {
        // transpose the 4x4 bytes: col[j] holds rows k..k+3 of column j
        const unsigned lo01 = __byte_perm(wv[0], wv[1], 0x5140);
        const unsigned lo23 = __byte_perm(wv[2], wv[3], 0x5140);
        const unsigned hi01 = __byte_perm(wv[0], wv[1], 0x7362);
        const unsigned hi23 = __byte_perm(wv[2], wv[3], 0x7362);
        const int col[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                            (int)__byte_perm(lo01, lo23, 0x7632),
                            (int)__byte_perm(hi01, hi23, 0x5410),
                            (int)__byte_perm(hi01, hi23, 0x7632)};
        const int* xk = xq + (k / 4) * kRows;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int xr = xk[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acci[r][j] = __dp4a(col[j], xr, acci[r][j]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned biased = wv[i] ^ 0x80808080u;
          float wf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wf[j] = byte_to_f32(biased, j);
          if (kMode == kDot1) {
            const float xv = xs[k + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) accf[0][j] = fmaf(xv, wf[j], accf[0][j]);
          } else {
            const float4 xa = *reinterpret_cast<const float4*>(xs + (size_t)(k + i) * kRows);
            const float4 xb = *reinterpret_cast<const float4*>(xs + (size_t)(k + i) * kRows + 4);
            const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int j = 0; j < 4; ++j) accf[r][j] = fmaf(xv[r], wf[j], accf[r][j]);
          }
        }
      }
      if (last_of_tile) {
        // the tile's term: the warps' sums in warp order, then into the partial
        constexpr int kUsed = kMode == kDot1 ? 1 : kRows;
#pragma unroll
        for (int r = 0; r < kUsed; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* slot = red + ((size_t)warp * kRows + r) * kCols + lane * 4 + j;
            if (kMode == kDot8i) {
              *reinterpret_cast<int*>(slot) = acci[r][j];
              acci[r][j] = 0;
            } else {
              *slot = accf[r][j];
              accf[r][j] = 0.0f;
            }
          }
        __syncthreads();
        if (out_r < kUsed) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t at = (size_t)out_r * kCols + out_c + j;
            if (kMode == kDot8i) {
              int y = 0;
              for (int g = 0; g < kWarps; ++g)
                y += reinterpret_cast<const int*>(red)[(size_t)g * kRows * kCols + at];
              sum[j] += (float)y;                  // the per-tile int32 -> f32 cast
            } else {
              float y = 0.0f;
              for (int g = 0; g < kWarps; ++g) y += red[(size_t)g * kRows * kCols + at];
              sum[j] += y;
            }
          }
        }
      }
    }
  }
  vtt::cp_async_wait<0>();

  float* dst = partial + ((size_t)blockIdx.y * kRows + out_r) * d + col0 + out_c;
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = sum[j];
}

// out = x + partial[0] + partial[1] + ..., in group order
__global__ void micro_tile_reduce(const float* __restrict__ x,
                                  const float* __restrict__ partial,
                                  float* __restrict__ out, int groups, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  for (int g = 0; g < groups; ++g) acc += partial[(size_t)g * n + i];
  out[i] = acc;
}

template <int kMode>
cudaError_t launch(const float* x, const int8_t* w, float* partial, int n_tiles,
                   int d, int tiles_per_block, cudaStream_t stream) {
  const size_t bytes = smem_bytes<kMode>(d);
  cudaError_t err = cudaFuncSetAttribute(
      micro_tile_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(d / kCols, (n_tiles + tiles_per_block - 1) / tiles_per_block);
  micro_tile_kernel<kMode><<<grid, kThreads, bytes, stream>>>(x, w, partial, n_tiles, d,
                                                              tiles_per_block);
  return cudaGetLastError();
}

}  // namespace

// x: (8, d) f32; w: (n_tiles, d, d) int8, d % 128 == 0; partial:
// (ceil(n_tiles / tiles_per_block), 8, d) f32 scratch; out: (8, d) f32.
// mode: 0 dma, 1 convert, 2 dot1, 3 dot8, 4 dot8i.
VTT_EXPORT int vtt_micro_tile(const float* x, const int8_t* w, float* partial,
                              float* out, int mode, int n_tiles, int d,
                              int tiles_per_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (mode) {
    case kDma: err = launch<kDma>(x, w, partial, n_tiles, d, tiles_per_block, s); break;
    case kConvert: err = launch<kConvert>(x, w, partial, n_tiles, d, tiles_per_block, s); break;
    case kDot1: err = launch<kDot1>(x, w, partial, n_tiles, d, tiles_per_block, s); break;
    case kDot8: err = launch<kDot8>(x, w, partial, n_tiles, d, tiles_per_block, s); break;
    case kDot8i: err = launch<kDot8i>(x, w, partial, n_tiles, d, tiles_per_block, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n = kRows * d;
  const int groups = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  micro_tile_reduce<<<(n + 255) / 256, 256, 0, s>>>(x, partial, out, groups, n);
  return (int)cudaGetLastError();
}
