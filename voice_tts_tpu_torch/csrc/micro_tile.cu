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
// rows would time nothing.  The f32 -> int8 cast of x saturates
// (truncation, clamp, NaN -> 0) as JAX's does.  A second pass adds the
// blocks' partials to x in group order: deterministic, no atomics.
//
// dma, convert, dot1 (`micro_tile_kernel`, 8 warps): a lane owns 4 columns
// (one 32-bit word a row), the warps split each chunk's rows on the CUDA
// cores, and a tile's term is summed across warps in shared memory.
//
// dot8, dot8i (`micro_tile_mma_kernel`, 4 warps): the 8-row products on the
// tensor cores with mma.sync.  On the CUDA cores they were issue-bound (8
// FMAs, a convert and shared-memory reads of x a weight byte; dp4a after a
// byte transpose).  A warp owns 32 columns and takes each whole 32-row
// chunk: M is the columns (two m16 tiles), N = 8 the rows of x, K the
// chunk's rows.  Lane (g, t) reads 4 bytes (4 columns) of rows 4t..4t+3 and
// 16+4t..16+4t+3, so one byte permute gives 4 consecutive k of one column,
// which is an A fragment's word: dot8i feeds it to m16n8k32 s8 x s8 -> s32
// (exact; the tile's int32 is cast to f32 once, as JAX's), dot8 turns each
// pair of rows into an exact bf16 pair (a permute, two masks and one bf16
// subtraction) for m16n8k16 bf16 -> f32 (the products are exact; only the
// order of the f32 sums moves).  Rows g and g + 8 of m16 tile q are
// columns 4g + 2q and 4g + 2q + 1 of the warp's 32, and the k16 steps' k
// are the rows in the order the lane holds them: x's fragments (int8 or bf16 rows
// in shared memory, padded so that the 8 rows fall in distinct banks) take
// the same order.  The ring's 16-byte segments are swizzled by row
// (segment ^ 2 ((row / 4) % 4)), so a warp's 32 word reads hit 32 banks.
// wgmma does not suit: its 8-bit operands must be K-major in shared memory,
// and the tiles are column-contiguous (a transpose through shared memory,
// the convert mode's traffic); from registers, mma.sync needs none.  128
// threads and 37 KB (dot8 at D 1280) let 6 blocks share an SM, so the 720
// blocks are resident at once and no second wave streams alone.
#include "common.cuh"

namespace {

constexpr int kRows = 8;         // rows of x
constexpr int kCols = 128;       // columns a block owns (one 128-byte segment)
constexpr int kChunk = 32;       // tile rows a pipeline stage holds (4 KB)
constexpr int kStages = 4;

enum Mode { kDma = 0, kConvert = 1, kDot1 = 2, kDot8 = 3, kDot8i = 4 };

using vtt::byte_to_f32;

// f32 -> int8 as JAX's astype: cvt.rzi truncates toward zero, maps NaN to
// 0 and saturates to int32; the clamp then saturates to int8.
__device__ __forceinline__ int saturate_int8(float v) {
  return min(max(__float2int_rz(v), -128), 127);
}

// ---------------------------------------------------------------------------
// dma, convert, dot1 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int kMode>
size_t smem_bytes(int d) {
  size_t bytes = (size_t)kStages * kChunk * kCols;
  if (kMode == kConvert) bytes += (size_t)kChunk * kCols * 2;
  if (kMode == kDot1) bytes += (size_t)d * 4 + (size_t)kWarps * kCols * 4;
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
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(rest);   // convert: [kChunk][kCols]
  float* xs = reinterpret_cast<float*>(rest);                     // dot1: [D]
  float* red = xs + d;                                            // dot1: [kWarps][kCols]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int t0 = blockIdx.y * tiles_per_block;
  const int tiles = min(tiles_per_block, n_tiles - t0);
  const int chunks_per_tile = d / kChunk;
  const int n_chunks = tiles * chunks_per_tile;

  if (kMode == kDot1) {
    for (int k = tid; k < d; k += kThreads) xs[k] = vtt::round_bf16(x[k]);
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
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int c = 0; c < n_chunks; ++c) {
    vtt::cp_async_wait<kStages - 2>();
    __syncthreads();
    load(c + kStages - 1);
    const int8_t* chunk = ring + (size_t)(c % kStages) * kChunk * kCols;
    const int kc = c % chunks_per_tile;            // chunk index within its tile

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
      // dot1: a warp's 4 consecutive chunk rows, a lane's 4 columns
      const int kr = warp * 4;
      const int k = kc * kChunk + kr;              // contraction row of the first
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned biased =
            *reinterpret_cast<const unsigned*>(chunk + (kr + i) * kCols + lane * 4) ^ 0x80808080u;
        const float xv = xs[k + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(xv, byte_to_f32(biased, j), acc[j]);
      }
      if (kc == chunks_per_tile - 1) {
        // the tile's term: the warps' sums in warp order, then into the partial
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          red[warp * kCols + lane * 4 + j] = acc[j];
          acc[j] = 0.0f;
        }
        __syncthreads();
        if (out_r == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float y = 0.0f;
            for (int g = 0; g < kWarps; ++g) y += red[g * kCols + out_c + j];
            sum[j] += y;
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

// ---------------------------------------------------------------------------
// dot8, dot8i on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                 // a warp owns 32 of the 128 columns
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlocksPerSm = 6;           // 792 slots on 132 SMs for 720 blocks
constexpr int kXPad = 16;                    // elements after each row of x

template <int kMode>
size_t mma_smem_bytes(int d) {
  return (size_t)kStages * kChunk * kCols + (size_t)kRows * (d + kXPad) * (kMode == kDot8 ? 2 : 1);
}

// byte offset of 16-byte segment `seg` of chunk row `row` in the swizzled ring
__device__ __forceinline__ int swizzled(int row, int seg) {
  return row * kCols + ((seg ^ (((row >> 2) & 3) << 1)) << 4);
}

// bytes j of rows r and r + 1 as an exact bf16 pair (row r in the low
// half): a permute puts them in the low byte of each half-word; 0x4300 |
// (b & 0x7f) is 128 + (b & 0x7f), and 0x4300 | (b & 0x80) is 128 for b >= 0
// and 256 for b < 0, so their difference is b
template <int J>
__device__ __forceinline__ unsigned int8_pair_to_bf16x2(unsigned row_r, unsigned row_r1) {
  const unsigned spread = __byte_perm(row_r, row_r1, J | ((4 + J) << 8));
  const unsigned hi = (spread & 0x007f007fu) | 0x43004300u;
  const unsigned lo = (spread & 0x00800080u) | 0x43004300u;
  unsigned out;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(hi), "r"(lo));
  return out;
}

__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int kMode>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSm)
micro_tile_mma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                      float* __restrict__ partial, int n_tiles, int d,
                      int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);                 // [kStages][kChunk][kCols]
  unsigned char* xs = smem + (size_t)kStages * kChunk * kCols;    // [8][d + kXPad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int t0 = blockIdx.y * tiles_per_block;
  const int tiles = min(tiles_per_block, n_tiles - t0);
  const int chunks_per_tile = d / kChunk;
  const int n_chunks = tiles * chunks_per_tile;
  const int xstride = d + kXPad;

  // the chunk loader: 32 rows x 128 bytes, two 16-byte copies a thread
  auto load = [&](int c) {
    if (c < n_chunks) {
      const int t = t0 + c / chunks_per_tile, k0 = (c % chunks_per_tile) * kChunk;
      int8_t* stage = ring + (size_t)(c % kStages) * kChunk * kCols;
#pragma unroll
      for (int q = 0; q < kChunk * kCols / 16 / kMmaThreads; ++q) {
        const int piece = tid + q * kMmaThreads, row = piece >> 3, seg = piece & 7;
        vtt::cp_async16(stage + swizzled(row, seg),
                        w + ((size_t)t * d + k0 + row) * d + col0 + seg * 16);
      }
    }
    vtt::cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // x's 8 rows, k-contiguous, while the ring fills: bf16 (dot8) or
  // saturated int8 (dot8i); the first chunk's barrier orders the stores
  for (int i = tid * 4; i < kRows * d; i += kMmaThreads * 4) {
    const int r = i / d, k = i % d;
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    if (kMode == kDot8) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs) + (r * xstride + k) / 2;
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    } else {
      const unsigned q = (saturate_int8(v.x) & 0xff) | (saturate_int8(v.y) & 0xff) << 8 |
                         (saturate_int8(v.z) & 0xff) << 16 | (unsigned)saturate_int8(v.w) << 24;
      *reinterpret_cast<unsigned*>(xs + r * xstride + k) = q;
    }
  }

  // The lane reads columns 32 warp + 4 g..+3 of chunk rows 4 tq + i and
  // 16 + 4 tq + i: the same swizzled offset in every such row, since
  // (row / 4) % 4 = tq for all eight.
  const int lane_off = swizzled(4 * tq, (warp * 32 + g * 4) >> 4) - 4 * tq * kCols + (g & 3) * 4;

  // accumulators of the two m16 tiles (q): c[0..1] at column 32 warp + 4 g
  // + 2 q, c[2..3] at the next column; c[0] / c[2] x row 2 tq, c[1] / c[3]
  // x row 2 tq + 1
  float sum[2][4] = {};
  float accf[2][4] = {};
  int acci[2][4] = {};

  for (int c = 0; c < n_chunks; ++c) {
    vtt::cp_async_wait<kStages - 2>();
    __syncthreads();
    load(c + kStages - 1);
    const int8_t* chunk = ring + (size_t)(c % kStages) * kChunk * kCols + lane_off;
    const int kc = c % chunks_per_tile;
    unsigned r[2][4];                              // rows 16 h + 4 tq + i
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[h][i] = *reinterpret_cast<const unsigned*>(chunk + (16 * h + 4 * tq + i) * kCols);
    const int xk = kc * kChunk + 4 * tq;           // x's column for r[0][0]

    if (kMode == kDot8i) {
      // a 4 x 4 byte transpose: col[j] holds the 4 rows of column 4 g + j,
      // k-contiguous, one A word
      unsigned col[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned p01 = __byte_perm(r[h][0], r[h][1], 0x5140);
        const unsigned p23 = __byte_perm(r[h][2], r[h][3], 0x5140);
        const unsigned q01 = __byte_perm(r[h][0], r[h][1], 0x7362);
        const unsigned q23 = __byte_perm(r[h][2], r[h][3], 0x7362);
        col[h][0] = __byte_perm(p01, p23, 0x5410);
        col[h][1] = __byte_perm(p01, p23, 0x7632);
        col[h][2] = __byte_perm(q01, q23, 0x5410);
        col[h][3] = __byte_perm(q01, q23, 0x7632);
      }
      const int8_t* xq = reinterpret_cast<const int8_t*>(xs) + g * xstride + xk;
      const unsigned b0 = *reinterpret_cast<const unsigned*>(xq);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(xq + 16);
      mma_s8(acci[0], col[0][0], col[0][1], col[1][0], col[1][1], b0, b1);
      mma_s8(acci[1], col[0][2], col[0][3], col[1][2], col[1][3], b0, b1);
    } else {
      // two k16 steps (rows 0-15, 16-31 of the chunk); in a step the lane's
      // k pairs (2 tq, 2 tq + 1) and (2 tq + 8, 2 tq + 9) are rows (4 tq,
      // 4 tq + 1) and (4 tq + 2, 4 tq + 3), for A and B alike
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned* v = r[h];
        const uint2 b = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const __nv_bfloat16*>(xs) + g * xstride + xk + 16 * h);
        mma_bf16(accf[0], int8_pair_to_bf16x2<0>(v[0], v[1]), int8_pair_to_bf16x2<1>(v[0], v[1]),
                 int8_pair_to_bf16x2<0>(v[2], v[3]), int8_pair_to_bf16x2<1>(v[2], v[3]), b.x, b.y);
        mma_bf16(accf[1], int8_pair_to_bf16x2<2>(v[0], v[1]), int8_pair_to_bf16x2<3>(v[0], v[1]),
                 int8_pair_to_bf16x2<2>(v[2], v[3]), int8_pair_to_bf16x2<3>(v[2], v[3]), b.x, b.y);
      }
    }
    if (kc == chunks_per_tile - 1) {
      // the tile's term into the partial (dot8i: its int32 cast to f32 once)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[q][e] += kMode == kDot8i ? (float)acci[q][e] : accf[q][e];
          accf[q][e] = 0.0f;
          acci[q][e] = 0;
        }
    }
  }
  vtt::cp_async_wait<0>();

  float* dst = partial + (size_t)blockIdx.y * kRows * d + col0 + warp * 32 + g * 4;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    dst[(size_t)(2 * tq) * d + 2 * q] = sum[q][0];
    dst[(size_t)(2 * tq + 1) * d + 2 * q] = sum[q][1];
    dst[(size_t)(2 * tq) * d + 2 * q + 1] = sum[q][2];
    dst[(size_t)(2 * tq + 1) * d + 2 * q + 1] = sum[q][3];
  }
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

constexpr bool on_tensor_cores(int mode) { return mode == kDot8 || mode == kDot8i; }

// the mode's kernel, block size and dynamic shared memory, with the
// attributes it needs set (the tensor-core kernel asks for the largest
// shared-memory carveout, so that 6 blocks fit an SM)
template <int kMode>
cudaError_t prepare(int d, const void** kernel, int* threads, size_t* bytes) {
  if constexpr (on_tensor_cores(kMode)) {
    *kernel = (const void*)micro_tile_mma_kernel<kMode>;
    *threads = kMmaThreads;
    *bytes = mma_smem_bytes<kMode>(d);
  } else {
    *kernel = (const void*)micro_tile_kernel<kMode>;
    *threads = kThreads;
    *bytes = smem_bytes<kMode>(d);
  }
  cudaError_t err = vtt::allow_dynamic_smem(*kernel, *bytes);
  if (err == cudaSuccess && on_tensor_cores(kMode)) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

template <int kMode>
cudaError_t launch(const float* x, const int8_t* w, float* partial, int n_tiles,
                   int d, int tiles_per_block, cudaStream_t stream) {
  const void* kernel;
  int threads;
  size_t bytes;
  cudaError_t err = prepare<kMode>(d, &kernel, &threads, &bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(d / kCols, (n_tiles + tiles_per_block - 1) / tiles_per_block);
  void* args[] = {(void*)&x, (void*)&w, (void*)&partial, (void*)&n_tiles, (void*)&d,
                  (void*)&tiles_per_block};
  return cudaLaunchKernel(kernel, grid, dim3(threads), args, bytes, stream);
}

template <int kMode>
cudaError_t occupancy(int d, int* blocks_per_sm) {
  const void* kernel;
  int threads;
  size_t bytes;
  cudaError_t err = prepare<kMode>(d, &kernel, &threads, &bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, bytes);
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

// The blocks of mode's tile kernel that one SM holds at once at width d.
VTT_EXPORT int vtt_micro_tile_occupancy(int mode, int d, int* blocks_per_sm) {
  switch (mode) {
    case kDma: return (int)occupancy<kDma>(d, blocks_per_sm);
    case kConvert: return (int)occupancy<kConvert>(d, blocks_per_sm);
    case kDot1: return (int)occupancy<kDot1>(d, blocks_per_sm);
    case kDot8: return (int)occupancy<kDot8>(d, blocks_per_sm);
    case kDot8i: return (int)occupancy<kDot8i>(d, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
