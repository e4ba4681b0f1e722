// K1, K3, K6 and K7: GPT-2 decode step of the int8 or int4 trunk for B rows
// (B = 1 for K1, up to 12 for K3, K = 2..8 tokens of one sequence for the
// speculative verify K6), with the folded readout, a bf16 or int8 KV cache
// and, for beam search, an ancestor table.
//
// Replaces: voice_tts_tpu/ops/fused_decode.py `fused_decode_step` (Pallas
// `_kernel_merged` + `_attend`: K1, float-KV and int8-KV branches),
// `fused_decode_step_batch` (Pallas `_kernel_batch` + `_attend_batch`: K3,
// with `beam_src`, `kv_scales` and `readout_pack`), `fused_decode_verify`
// (Pallas `_kernel_batch` + `_attend_verify`: K6) and the int4 weight branch
// of all three (`pack_gpt_int4` tiles dequantized in `_dot_one_tile`: K7).
//
// The Pallas kernels run the whole trunk in one call because TPU grid steps
// run in order on one core and a residual can live in VMEM scratch across
// them.  A GPU grid gives no such order, so the step is a host-sequenced
// chain of launches, five per layer plus one for the readout:
//
//   dq_gemv  [LN1 prologue]                  x   -> qkv (B, 3D)
//   attend   [one block per head, row and    qkv -> ctx (B, D), kv_new rows
//             256-position split; the last
//             block of a (row, head) combines]
//   dq_gemv  [residual epilogue]             ctx -> x += proj(ctx)
//   dq_gemv  [LN2 prologue, GELU]            x   -> h (B, 4D)
//   dq_gemv  [residual epilogue]             h   -> x += fc2(h)   (K = 4D, 4 k-tiles)
//   dq_gemv  [final-LN prologue]             x   -> logits (B, 12 * VT)
//
// K6 is the same chain over its K rows with `verify_attend` in place of
// `attend`; an int4 pack (K7) runs `dq_gemv4` in place of `dq_gemv` for the
// trunk's products (the readout stays int8).
//
// Numerics reproduced from the Pallas kernels: the activation is rounded to
// bf16 before every product, f32 accumulation, then `* scale + bias`; the fc2
// bias is added once; q is scaled by hd^-0.5 in f32; cache rows are widened to
// f32 and, from an int8 cache, multiplied by the scale of the row they are
// read from; the current token's k/v enter attention unrounded while kv_new
// is stored in the cache dtype (bf16), or as f32 beside an int8 cache (the
// caller quantizes it); the final LN runs in f32.
//
// What is TPU-only in the Pallas K3 and left out here: the one-hot ancestor
// multiply-add and the `beam_k` grouping (on the card an ancestor is a plain
// gather: row b at position t loads cache row src[b, t]), the [lo, hi)
// interval scalars that stand in for the additive bias (the bias is read
// directly; -1e30 gives the same softmax as the Pallas -inf), and
// `batch_block_t`.
//
// Weight layout (see voice_tts_tpu_torch/ops/fused_decode.py `pack_gpt`):
// every (D, D) int8 tile of the JAX pack is stored transposed, (out, in), so
// one output column's weights are contiguous and a block's columns are one
// contiguous slab.  A (F, K) matrix is `n_ktiles` such blocks, [kt][F][K/kt].
//
// Bound on the H100: device memory.  A step reads the whole int8 trunk once
// (12 D^2 bytes per layer, 472 MB at D = 1280, L = 24) plus the int8 readout,
// and B live KV prefixes (one per row, pos_b * D bytes per layer and k|v,
// int8 or bf16); each weight byte feeds B multiply-adds: 0.2 ms for a beam-3
// step at pos 1500 with an int8 cache.
//
// Design of the int8 chain (dq_gemv and attend; K1, K3, K6's GEMVs).  With
// a few rows, a launch's own work is a few microseconds, so what the design
// fights is latency: the time between launches and the dependent round
// trips inside one.  Every such kernel runs under programmatic dependent
// launch (`vtt::launch_pdl`): its blocks may start while the previous
// launch drains, and before `griddepcontrol.wait` they read only what no
// launch of the step writes (the weights, LN constants, scales and biases;
// the cache, its scales, the bias, the ancestor table, pos_rows), staging
// it in shared memory with cp.async; after the wait they read the previous
// launch's output (x, qkv, ctx, h).  Each kernel lets its dependents start
// after its main loop (`griddepcontrol.launch_dependents`).
// - The GEMV block owns 8 output columns (16 where it runs an LN prologue
//   on up to 8 rows, which halves the blocks that restage x and the LN
//   constants), puts its whole weight slab (8-16 x K bytes) in flight
//   first, then stages the B rows as bf16 (through the LN: the rows copied
//   as f32 once, then one warp a row); a lane reads 16 weights and 16
//   activations of a row at a time from shared memory and converts the
//   bytes with a byte permute (no I2F).  A warp reads each weight once for
//   all B rows: the 472 MB stream is read once per beam step, not once per
//   beam.
// - Attention splits each row's live prefix [0, pos_b) into 256-position
//   splits, one block per (head, row, split) (flash-decoding: 360 blocks at
//   beam-3, pos 1500, for the card's 132 SMs).  A block
//   copies its chunk's k and v rows (through the ancestor table, 16-byte
//   copies) into shared memory before the wait, scores the chunk, and writes
//   its max, sum and unnormalised weighted sum of V to a workspace; the last
//   block of a (row, head) to arrive (an arrival count it resets) combines
//   the splits in split order with the current token's unrounded k/v:
//   deterministic, and no launch of its own.
//
// K7, int4 weights (`dq_gemv4`).  Bound: device memory, half the int8
// trunk: 236 MB of nibble pairs plus 14.7 MB of g128 scales a step at
// L = 24, D = 1280, so about 0.075 ms at 3.35 TB/s.  A tile is stored (out,
// in/2): one output column's D/2 bytes run along the contraction axis, byte
// k holding contraction row k in its low nibble and row k + D/2 in its high
// nibble; its group scales (G per tile, one per `gsize` contraction rows of
// each half) sit beside it, contiguous.  The design is dq_gemv's: one warp
// per output column streams the column's bytes once for all B rows, 4 bytes
// a lane; each nibble is sign-extended in registers (((v & 15) ^ 8) - 8 and
// v >> 4, the JAX kernel's unpack), and each lane keeps one f32 partial per
// row for the low group and one for the high group, multiplied by the
// group's scale at the group's end and added to the row's f32 sum, as the
// JAX default scheme (`int4_expand=False`) sums its per-group products.
//
// K6, the verify attention (`verify_attend`).  Bound: device memory, the
// int8 trunk once for all K rows (472 MB) plus the bf16 prefix (37 MB at
// pos 300): about 0.15 ms at 3.35 TB/s.  One block per (head, query row j):
// row j attends the committed prefix [0, pos) of the sequence's cache row
// under the bias, as `attend` does, then rows i <= j of the K current
// tokens with their unrounded f32 k/v read from `qkv` (never through the
// cache: the JAX kernel keeps the causal tail in f32); the k/v rows written
// for the cache are rounded to bf16.  Each of the K blocks of a head reads
// the whole prefix: the Pallas kernel's shared slab (one block per head
// reading each prefix row once for all K rows) is left to a later change.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int GEMV_WARPS = 8;
constexpr int ATT_WARPS = 8;
constexpr int ATT_CHUNK = 256;
constexpr int MAX_VERIFY = 8;   // K6 rows

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// Widen the 4 bf16 values of one 8-byte load to f32 (f[j] is element j).
__device__ __forceinline__ void bf16x4_to_f32(const uint2 raw, float* f) {
  f[0] = __uint_as_float(raw.x << 16);
  f[1] = __uint_as_float(raw.x & 0xffff0000u);
  f[2] = __uint_as_float(raw.y << 16);
  f[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// 8 cache values widened to f32: 16 bytes of bf16 or 8 bytes of int8.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  vtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)(raw.x >> (8 * i));
    f[4 + i] = (float)(int8_t)(raw.y >> (8 * i));
  }
}

// Stage the nrows input rows x (nrows, k_total) f32 into shared memory as
// bf16 (xs), through the LN prologue when ln_w != nullptr (`stage` holds
// k_total floats of staging).  The caller synchronises afterwards.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           const float* __restrict__ ln_w,
                                           const float* __restrict__ ln_b,
                                           __nv_bfloat16* xs, float* stage,
                                           float* scratch, int k_total,
                                           int nrows) {
  for (int r = 0; r < nrows; ++r) {
    const float* xr = x + (size_t)r * k_total;
    __nv_bfloat16* xb = xs + (size_t)r * k_total;
    if (ln_w != nullptr) {
      // each thread reads back only the stage entries it wrote itself
      float s = 0.0f;
      for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
        const float v = xr[i];
        stage[i] = v;
        s += v;
      }
      const float mean = vtt::block_sum(s, scratch) / (float)k_total;
      float v = 0.0f;
      for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
        const float c = stage[i] - mean;
        v += c * c;
      }
      const float var = vtt::block_sum(v, scratch) / (float)k_total;
      const float rstd = rsqrtf(var + 1e-5f);
      for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
        xb[i] = __float2bfloat16_rn((stage[i] - mean) * rstd * ln_w[i] + ln_b[i]);
      }
    } else {
      for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
        xb[i] = __float2bfloat16_rn(xr[i]);
      }
    }
  }
}

// Lane 0 of a column's warp: out[r, col] = epi(acc summed over the warp ...)
template <int EPI, int NB>
__device__ __forceinline__ void gemv_epilogue(const float* acc, int nrows,
                                              int lane, int col, float scale,
                                              float bias, const float* res,
                                              float* out, int f_total) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nrows) {
      const float a = vtt::warp_sum(acc[r]);
      if (lane == 0) {
        float y = a * scale + bias;
        if (EPI == EPI_GELU) y = gelu_tanh(y);
        if (EPI == EPI_RESIDUAL) y = res[(size_t)r * f_total + col] + y;
        out[(size_t)r * f_total + col] = y;
      }
    }
  }
}

// Stage the nrows input rows x (nrows, k_total) f32 into shared memory as
// bf16 (xs), 16 bytes a thread, k_total % 4 == 0.  With an LN prologue (xf
// != nullptr) the rows are first copied as f32 into xf (nrows * k_total f32
// of shared memory: one read of device memory), then one warp a row takes
// the mean and variance from there with warp reductions and writes the
// normalised row times lnw plus lnb (k_total f32 each, staged in shared
// memory by the caller).  Ends with a barrier.
__device__ __forceinline__ void stage_rows_smem(const float* __restrict__ x, float* xf,
                                                const float* lnw, const float* lnb,
                                                __nv_bfloat16* xs, int k_total,
                                                int nrows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k4 = k_total / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  if (xf == nullptr) {
    for (int i = threadIdx.x; i < nrows * k4; i += blockDim.x) {
      const float4 v = x4[i];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs) + 2 * i;
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    __syncthreads();
    return;
  }
  for (int i = threadIdx.x; i < nrows * k4; i += blockDim.x) {
    reinterpret_cast<float4*>(xf)[i] = x4[i];
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += nwarps) {
    const float4* xr = reinterpret_cast<const float4*>(xf + (size_t)r * k_total);
    float s = 0.0f;
    for (int i = lane; i < k4; i += 32) {
      const float4 v = xr[i];
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = vtt::warp_sum(s) / (float)k_total;
    float q = 0.0f;
    for (int i = lane; i < k4; i += 32) {
      const float4 v = xr[i];
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, e = v.w - mean;
      q += (a * a + b * b) + (c * c + e * e);
    }
    const float rstd = rsqrtf(vtt::warp_sum(q) / (float)k_total + 1e-5f);
    __nv_bfloat162* xb = reinterpret_cast<__nv_bfloat162*>(xs + (size_t)r * k_total);
    for (int i = lane; i < k4; i += 32) {
      const float4 v = xr[i];
      const float4 g = reinterpret_cast<const float4*>(lnw)[i];
      const float4 b = reinterpret_cast<const float4*>(lnb)[i];
      xb[2 * i] = __floats2bfloat162_rn((v.x - mean) * rstd * g.x + b.x,
                                        (v.y - mean) * rstd * g.y + b.y);
      xb[2 * i + 1] = __floats2bfloat162_rn((v.z - mean) * rstd * g.z + b.z,
                                            (v.w - mean) * rstd * g.w + b.w);
    }
  }
  __syncthreads();
}

// The int8 GEMV of the chain (K1, K3, K6), launched with programmatic
// dependent launch: out[r, f] = epi(sum_k bf16(ln(x[r]))[k] * W[f, k] *
// scale[f] + bias[f]) for rows r < nrows <= NB.  x, out, res: (nrows, K) /
// (nrows, F) f32; W: [n_ktiles][F][ktile] int8, ktile % 16 == 0; ln_w ==
// nullptr -> no LN.  A block owns GEMV_WARPS * CPW output columns, CPW a
// warp.  Its weights (contiguous in each k-tile), the LN constants, scales
// and biases are read-only for the whole step, so the block first puts
// them in flight as 16-byte cp.async copies into shared memory, before the
// dependency wait; only then does it read what the previous launch wrote
// (x, and the residual rows), so staging x and the LN prologue overlap the
// weight copies.  A lane then reads 16 weights (16 bytes) a column and, per
// row, 16 bf16 activations (32 bytes) at a time from shared memory,
// converting the bytes with a byte permute, into two f32 chains (even and
// odd weights) that are added before the warp's shuffle reduction to lane
// 0's epilogue.  Dynamic shared memory:
// GEMV_WARPS * CPW * K int8, nrows * K bf16, and with an LN the LN weight
// and bias (K f32 each) and the f32 rows (nrows * K).
template <int EPI, int NB, int CPW>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
dq_gemv_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, const int8_t* __restrict__ w,
               int n_ktiles, int ktile, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* res, float* out,
               int f_total, int nrows) {
  constexpr int kCols = GEMV_WARPS * CPW;    // output columns a block owns
  extern __shared__ uint4 smem4[];
  const int k_total = n_ktiles * ktile;
  int8_t* ws = reinterpret_cast<int8_t*>(smem4);     // [n_ktiles][kCols][ktile]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ws + (size_t)kCols * k_total);
  float* lnw = reinterpret_cast<float*>(xs + (size_t)nrows * k_total);  // LN only
  float* lnb = lnw + k_total;
  float* xf = lnb + k_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols;
  const int wcol = col0 + warp * CPW;        // this warp's first column

  if (ln_w != nullptr) {                     // copy group 1: the LN constants
    for (int i = threadIdx.x; i < k_total / 4; i += blockDim.x) {
      vtt::cp_async16(lnw + 4 * i, ln_w + 4 * i);
      vtt::cp_async16(lnb + 4 * i, ln_b + 4 * i);
    }
  }
  vtt::cp_async_commit();
  const int seg = min(kCols, f_total - col0) * ktile / 16;   // copies a k-tile
  for (int i = threadIdx.x; i < n_ktiles * seg; i += blockDim.x) {
    const int kt = i / seg, s = i % seg;
    vtt::cp_async16(ws + (size_t)kt * kCols * ktile + s * 16,
                    w + ((size_t)kt * f_total + col0) * ktile + s * 16);
  }
  vtt::cp_async_commit();                    // copy group 2: the weight slab
  float sc[CPW], bi[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    sc[c] = wcol + c < f_total ? scale[wcol + c] : 0.0f;
    bi[c] = wcol + c < f_total ? bias[wcol + c] : 0.0f;
  }

  vtt::grid_dependency_wait();
  float rv[CPW][NB];                         // the residual rows (lane 0)
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      rv[c][r] = EPI == EPI_RESIDUAL && lane == 0 && r < nrows && wcol + c < f_total
                     ? res[(size_t)r * f_total + wcol + c] : 0.0f;
    }
  vtt::cp_async_wait<1>();                   // the LN constants; the barrier in
                                             // stage_rows_smem publishes them
  stage_rows_smem(x, ln_w != nullptr ? xf : nullptr, lnw, lnb, xs, k_total, nrows);
  vtt::cp_async_wait<0>();
  __syncthreads();

  float acc[CPW][NB][2];                     // a column and row: even, odd weights
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int r = 0; r < NB; ++r) acc[c][r][0] = acc[c][r][1] = 0.0f;
  if (wcol < f_total) {
    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int8_t* wc = ws + ((size_t)kt * kCols + warp * CPW) * ktile;
      const __nv_bfloat16* xk = xs + (size_t)kt * ktile;
#pragma unroll 2
      for (int k = lane * 16; k < ktile; k += 32 * 16) {
        float wf[CPW][16];
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          const uint4 q = *reinterpret_cast<const uint4*>(wc + (size_t)c * ktile + k);
          const unsigned words[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                                     q.z ^ 0x80808080u, q.w ^ 0x80808080u};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) wf[c][4 * u + j] = vtt::byte_to_f32(words[u], j);
        }
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          if (r < nrows) {
            float xv[16];
            vtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(xk + (size_t)r * k_total + k), xv);
            vtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(xk + (size_t)r * k_total + k + 8), xv + 8);
#pragma unroll
            for (int c = 0; c < CPW; ++c)
#pragma unroll
              for (int j = 0; j < 16; ++j) acc[c][r][j & 1] = fmaf(xv[j], wf[c][j], acc[c][r][j & 1]);
          }
        }
      }
    }
  }
  vtt::launch_dependents();
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const int col = wcol + c;
    if (col >= f_total) break;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      if (r < nrows) {
        const float a = vtt::warp_sum(acc[c][r][0] + acc[c][r][1]);
        if (lane == 0) {
          float y = a * sc[c] + bi[c];
          if (EPI == EPI_GELU) y = gelu_tanh(y);
          if (EPI == EPI_RESIDUAL) y = rv[c][r] + y;
          out[(size_t)r * f_total + col] = y;
        }
      }
    }
  }
}

// The signed low and high nibble of one packed byte, as f32.
__device__ __forceinline__ void unpack_int4(const signed char b, float& lo, float& hi) {
  const int v = b;
  lo = (float)(((v & 15) ^ 8) - 8);
  hi = (float)(v >> 4);
}

// The int4 GEMV (K7): out[r, f] = epi(sum over the groups of a tile, in
// group order, of (sum_k bf16(ln(x[r]))[k] * nibble[f, k]) * gscale[f, g],
// summed over the contraction tiles, + bias[f]).  W: [n_ktiles][F][ktile/2]
// nibble pairs (byte k: contraction row k low, row k + ktile/2 high);
// gscale: [n_ktiles][F][G], G = ktile / gsize, the low half's G/2 groups
// first.  Shared memory as dq_gemv_kernel's.
template <int EPI, int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
dq_gemv4_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const int8_t* __restrict__ w,
                int n_ktiles, int ktile, const float* __restrict__ gscale,
                int gsize, const float* __restrict__ bias, const float* res,
                float* out, int f_total, int nrows) {
  extern __shared__ uint4 smem4[];
  __shared__ float scratch[32];
  const int k_total = n_ktiles * ktile;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* stage = reinterpret_cast<float*>(xs + (size_t)nrows * k_total);
  stage_rows(x, ln_w, ln_b, xs, stage, scratch, k_total, nrows);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * GEMV_WARPS + warp;
  if (col >= f_total) return;
  const int half = ktile / 2;            // packed bytes of a column per tile
  const int n_groups = ktile / gsize;
  const int per_half = n_groups / 2;
  float acc[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = 0.0f;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int8_t* wcol = w + ((size_t)kt * f_total + col) * half;
    const float* scol = gscale + ((size_t)kt * f_total + col) * n_groups;
    const __nv_bfloat16* xk = xs + (size_t)kt * ktile;
    for (int g = 0; g < per_half; ++g) {
      float plo[NB], phi[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) plo[r] = phi[r] = 0.0f;
      for (int c = g * gsize + lane * 4; c < (g + 1) * gsize; c += 32 * 4) {
        const char4 q = *reinterpret_cast<const char4*>(wcol + c);
        float lo[4], hi[4];
        unpack_int4(q.x, lo[0], hi[0]);
        unpack_int4(q.y, lo[1], hi[1]);
        unpack_int4(q.z, lo[2], hi[2]);
        unpack_int4(q.w, lo[3], hi[3]);
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          if (r < nrows) {
            const __nv_bfloat16* xr = xk + (size_t)r * k_total;
            float xl[4], xh[4];
            bf16x4_to_f32(*reinterpret_cast<const uint2*>(xr + c), xl);
            bf16x4_to_f32(*reinterpret_cast<const uint2*>(xr + half + c), xh);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              plo[r] += xl[j] * lo[j];
              phi[r] += xh[j] * hi[j];
            }
          }
        }
      }
      const float s_lo = scol[g], s_hi = scol[per_half + g];
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        acc[r] += plo[r] * s_lo;
        acc[r] += phi[r] * s_hi;
      }
    }
  }
  gemv_epilogue<EPI, NB>(acc, nrows, lane, col, 1.0f, bias[col], res, out,
                         f_total);
}

// K6's online softmax of one block's query over the prefix [0, pos) of
// the sequence's bf16 cache row.  Lane layout: a cache row of hd values is
// read by lpr = hd/8 lanes, 8 values each (`sub`); a warp covers rows =
// 32/lpr positions at once (`g`); brow is the additive bias.  Scores of a
// chunk of ATT_CHUNK positions go to shared memory (p); on return m and l
// hold the running max and sum (the same in every thread) and acc this
// lane's 8 partial weighted sums of V.
__device__ __forceinline__ void attend_prefix(
    const float* q, const __nv_bfloat16* __restrict__ cache_k,
    const __nv_bfloat16* __restrict__ cache_v, const float* __restrict__ brow,
    int pos, int d, size_t col, int lpr, int rows, int g, int sub, int warp,
    float* p, float* scratch, float& m, float& l, float* acc) {
  m = -INFINITY;
  l = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < pos; c0 += ATT_CHUNK) {
    const int n = min(ATT_CHUNK, pos - c0);
    for (int r0 = warp * rows; r0 < n; r0 += ATT_WARPS * rows) {
      const int tt = r0 + g;
      float s = 0.0f;
      if (tt < n) {
        float kr[8];
        load8(cache_k + (size_t)(c0 + tt) * d + col, kr);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += q[j] * kr[j];
      }
      for (int o = lpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tt < n && sub == 0) p[tt] = s + brow[c0 + tt];
    }
    __syncthreads();
    float cm = -INFINITY;
    for (int tt = threadIdx.x; tt < n; tt += blockDim.x) cm = fmaxf(cm, p[tt]);
    cm = vtt::block_max(cm, scratch);
    const float m_new = fmaxf(m, cm);
    const float alpha = expf(m - m_new);
    float ps = 0.0f;
    for (int tt = threadIdx.x; tt < n; tt += blockDim.x) {
      const float e = expf(p[tt] - m_new);
      p[tt] = e;
      ps += e;
    }
    ps = vtt::block_sum(ps, scratch);  // ends with a barrier: p is complete
    l = l * alpha + ps;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] *= alpha;
    for (int tt = warp * rows + g; tt < n; tt += ATT_WARPS * rows) {
      float vr[8];
      load8(cache_v + (size_t)(c0 + tt) * d + col, vr);
      const float pt = p[tt];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += pt * vr[j];
    }
    m = m_new;
    __syncthreads();  // p is rewritten by the next chunk
  }
}

// Sum the lanes' partial weighted sums of V into part[w * hd + i] (the row
// groups of each warp first, lanes sharing `sub`), then a barrier.
__device__ __forceinline__ void store_partials(float* acc, float* part, int lpr,
                                               int g, int sub, int warp, int hd) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    for (int o = lpr; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) part[warp * hd + sub * 8 + j] = acc[j];
  }
  __syncthreads();
}

// Split-prefix attention of K1 / K3 (flash-decoding), launched with
// programmatic dependent launch.  One block per (head, row, split): split s
// covers positions [s * ATT_CHUNK, (s + 1) * ATT_CHUNK) of the row's live
// prefix [0, pos_b).  The cache, its scales, the bias, the ancestor table
// and pos_rows are read-only for the step, so before the dependency wait the
// block copies its chunk's k and v rows (through the table) into shared
// memory with cp.async and stages the bias and the int8 scales; after it,
// it reads q from qkv (the previous launch's output), scores the chunk, and
// keeps the chunk's max m, sum l and unnormalised weighted sum of V, o (hd
// values).  A split past pos_b has m = -inf, l = 0, o = 0.  Each block
// writes (o, m, l) to `work` [B][H][S][hd + 2] and counts itself in
// `arrivals` [B][H]; the last block of a (row, head) resets the count for
// the next launch and combines the S splits in split order, with the
// current token's unrounded k/v, into ctx, and writes kv_new once: no
// launch of its own, and the same result whichever block comes last.
// qkv: (B, 3D) f32 [q | k | v]; cache_k, cache_v: this layer's (B, Tmax,
// D) planes; scales: this layer's (B, Tmax, 2) f32 (int8 cache only);
// bias: (B, Tmax) f32 additive mask; src: (B, Tmax) i32 ancestor rows or
// null (row b reads itself); pos_rows: (B,) i32 or null (every row at
// pos_all); ctx: (B, D) f32; kv_new: (2, B, D), bf16 beside a bf16 cache,
// f32 beside an int8 one.  A row at pos 0 attends to its current token only.
// Needs hd % 8 == 0 and 32 % (hd / 8) == 0.  Dynamic shared memory: k and v
// [ATT_CHUNK][hd] CacheT each, then p, k and v scales [ATT_CHUNK] f32 each,
// then ATT_WARPS * hd f32 of warp partials.
template <typename CacheT>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attend_split_kernel(const float* __restrict__ qkv, const CacheT* __restrict__ cache_k,
                    const CacheT* __restrict__ cache_v, const float* __restrict__ scales,
                    const float* __restrict__ bias, const int* __restrict__ src,
                    const int* __restrict__ pos_rows, int pos_all, int t_max, int d,
                    int hd, float q_scale, float* __restrict__ ctx,
                    void* __restrict__ kv_new, float* __restrict__ work,
                    int* __restrict__ arrivals) {
  constexpr bool kInt8 = std::is_same<CacheT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  CacheT* kc = reinterpret_cast<CacheT*>(smem);
  CacheT* vc = kc + (size_t)ATT_CHUNK * hd;
  float* p = reinterpret_cast<float*>(vc + (size_t)ATT_CHUNK * hd);
  float* ks = p + ATT_CHUNK;
  float* vsc = ks + ATT_CHUNK;
  float* part = vsc + ATT_CHUNK;            // [ATT_WARPS][hd]; the combine's [S][hd + 2]
  __shared__ int srow[ATT_CHUNK];           // source cache row of each chunk position
  __shared__ float scratch[32];
  __shared__ float s_cur;
  __shared__ int last;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int heads = gridDim.x, nrows = gridDim.y, n_splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = hd / 8, rows = 32 / lpr;
  const int g = lane / lpr, sub = lane % lpr;
  const int pos = min(pos_rows != nullptr ? pos_rows[b] : pos_all, t_max);
  const int c0 = sp * ATT_CHUNK;
  const int n = max(0, min(ATT_CHUNK, pos - c0));

  // the chunk's cached rows, read-only for the step: the table first, then
  // hd values at (source row, position) as 16-byte copies (8-byte where an
  // int8 row is not a multiple of 16 bytes), the bias and the int8 scales
  for (int tt = tid; tt < n; tt += blockDim.x) {
    srow[tt] = src != nullptr ? src[(size_t)b * t_max + c0 + tt] : b;
  }
  __syncthreads();
  const int row_bytes = hd * (int)sizeof(CacheT);
  const int cw = row_bytes % 16 == 0 ? 16 : 8;
  const int segs = row_bytes / cw;
  for (int i = tid; i < n * segs; i += blockDim.x) {
    const int tt = i / segs, sg = i % segs;
    const size_t at = ((size_t)srow[tt] * t_max + c0 + tt) * d + (size_t)h * hd;
    const char* gk = reinterpret_cast<const char*>(cache_k + at) + sg * cw;
    const char* gv = reinterpret_cast<const char*>(cache_v + at) + sg * cw;
    char* sk = reinterpret_cast<char*>(kc + (size_t)tt * hd) + sg * cw;
    char* sv = reinterpret_cast<char*>(vc + (size_t)tt * hd) + sg * cw;
    if (cw == 16) {
      vtt::cp_async16(sk, gk);
      vtt::cp_async16(sv, gv);
    } else {
      vtt::cp_async8(sk, gk);
      vtt::cp_async8(sv, gv);
    }
  }
  vtt::cp_async_commit();
  for (int tt = tid; tt < n; tt += blockDim.x) {
    p[tt] = bias[(size_t)b * t_max + c0 + tt];
    if constexpr (kInt8) {
      const size_t at = (size_t)srow[tt] * t_max + c0 + tt;
      ks[tt] = scales[at * 2];
      vsc[tt] = scales[at * 2 + 1];
    }
  }

  // q, and the current token's k and v (whichever block combines needs
  // them): the previous launch's output
  vtt::grid_dependency_wait();
  const float* qrow = qkv + (size_t)b * 3 * d;
  const float* k_cur = qrow + d + (size_t)h * hd;
  const float* v_cur = qrow + 2 * d + (size_t)h * hd;
  const size_t col = (size_t)h * hd + sub * 8;
  float q[8], acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    q[j] = qrow[col + j] * q_scale;
    acc[j] = 0.0f;
  }
  const float kn = tid < hd ? k_cur[tid] : 0.0f;
  const float vn = tid < hd ? v_cur[tid] : 0.0f;
  if (warp == 0) {                           // the current token's score, from
    float sc = 0.0f;                         // the lanes of the first row group
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sc += q[j] * k_cur[sub * 8 + j];
    }
    for (int o = lpr / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
    if (lane == 0) s_cur = sc;
  }
  vtt::cp_async_wait<0>();
  __syncthreads();

  float m = -INFINITY, l = 0.0f;
  if (n > 0) {                               // uniform across the block
    for (int r0 = warp * rows; r0 < n; r0 += ATT_WARPS * rows) {
      const int tt = r0 + g;
      float sc = 0.0f;
      if (tt < n) {
        float kr[8];
        load8(kc + (size_t)tt * hd + sub * 8, kr);
        if constexpr (kInt8) {
#pragma unroll
          for (int j = 0; j < 8; ++j) kr[j] *= ks[tt];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) sc += q[j] * kr[j];
      }
      for (int o = lpr / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (tt < n && sub == 0) p[tt] += sc;
    }
    __syncthreads();
    float cm = -INFINITY;
    for (int tt = tid; tt < n; tt += blockDim.x) cm = fmaxf(cm, p[tt]);
    m = vtt::block_max(cm, scratch);
    float ps = 0.0f;
    for (int tt = tid; tt < n; tt += blockDim.x) {
      const float e = expf(p[tt] - m);
      p[tt] = e;
      ps += e;
    }
    l = vtt::block_sum(ps, scratch);         // ends with a barrier: p is complete
    for (int tt = warp * rows + g; tt < n; tt += ATT_WARPS * rows) {
      float vr[8];
      load8(vc + (size_t)tt * hd + sub * 8, vr);
      if constexpr (kInt8) {                 // dequantized first, as the plain version
#pragma unroll
        for (int j = 0; j < 8; ++j) vr[j] *= vsc[tt];
      }
      const float pt = p[tt];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += pt * vr[j];
    }
  }
  vtt::launch_dependents();
  store_partials(acc, part, lpr, g, sub, warp, hd);

  const size_t bh = (size_t)b * heads + h;
  const int stride = hd + 2;                 // one split's (o, m, l)
  float* mine = work + (bh * n_splits + sp) * stride;
  for (int i = tid; i < hd; i += blockDim.x) {
    float a = 0.0f;
    for (int w = 0; w < ATT_WARPS; ++w) a += part[w * hd + i];
    mine[i] = a;
  }
  if (tid == 0) {
    mine[hd] = m;
    mine[hd + 1] = l;
  }
  __threadfence();                           // the partial before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                           // the other splits' partials after it
  if (tid == 0) arrivals[bh] = 0;

  // the combine: every split's (o, m, l) into shared memory at once, then
  // summed in split order with the current token's k/v unrounded
  const float* all = work + bh * n_splits * stride;
  for (int i = tid; i < n_splits * stride; i += blockDim.x) part[i] = __ldcg(all + i);
  __syncthreads();
  // the online-softmax recurrence over the splits in order (each split's
  // terms rescaled to the running max; live splits come first, and a split
  // with no live position, m = -inf, adds nothing), then the current token
  float m_run = part[hd], l_run = part[hd + 1];
  for (int s = 1; s < n_splits; ++s) {
    const float ms = part[s * stride + hd];
    const float m_new = fmaxf(m_run, ms);
    if (m_new == -INFINITY) continue;        // an idle pos-0 row
    l_run = l_run * expf(m_run - m_new) + part[s * stride + hd + 1] * expf(ms - m_new);
    m_run = m_new;
  }
  const float sc = s_cur;
  const float m_f = fmaxf(m_run, sc);
  const float alpha = expf(m_run - m_f);
  const float p_cur = expf(sc - m_f);
  const float l_f = l_run * alpha + p_cur;
  if (tid < hd) {
    float a = part[tid], ma = part[hd];
    for (int s = 1; s < n_splits; ++s) {
      const float ms = part[s * stride + hd];
      const float m_new = fmaxf(ma, ms);
      if (m_new == -INFINITY) continue;
      a = a * expf(ma - m_new) + part[s * stride + tid] * expf(ms - m_new);
      ma = m_new;
    }
    a *= alpha;
    ctx[(size_t)b * d + (size_t)h * hd + tid] = (a + p_cur * vn) / l_f;
    const size_t ko = (size_t)b * d + (size_t)h * hd + tid;
    const size_t vo = (size_t)(nrows + b) * d + (size_t)h * hd + tid;
    if constexpr (kInt8) {
      static_cast<float*>(kv_new)[ko] = kn;
      static_cast<float*>(kv_new)[vo] = vn;
    } else {
      static_cast<__nv_bfloat16*>(kv_new)[ko] = __float2bfloat16_rn(kn);
      static_cast<__nv_bfloat16*>(kv_new)[vo] = __float2bfloat16_rn(vn);
    }
  }
}

// K6's attention, one block per (head, query row j) of K <= MAX_VERIFY rows
// of ONE sequence at positions pos .. pos + K - 1: the committed prefix
// [0, pos) of the sequence's cache row under the bias (`attend_prefix`),
// then rows i <= j of the K current tokens with their unrounded k/v from
// `qkv` (B = K rows, as in attend_split_kernel).  cache_k, cache_v: this layer's
// (1, Tmax, D) bf16 planes; bias: (1, Tmax); kv_new: (2, K, D) bf16.
__global__ void __launch_bounds__(ATT_WARPS * 32)
verify_attend_kernel(const float* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ cache_k,
                     const __nv_bfloat16* __restrict__ cache_v,
                     const float* __restrict__ bias, int pos, int t_max, int d,
                     int hd, float q_scale, float* __restrict__ ctx,
                     __nv_bfloat16* __restrict__ kv_new) {
  __shared__ float p[ATT_CHUNK];
  __shared__ float scratch[32];
  __shared__ float s_tail[MAX_VERIFY];  // scores of the causal tail rows
  extern __shared__ float part[];       // ATT_WARPS * hd partial sums of V
  const int h = blockIdx.x, j = blockIdx.y, kk = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = hd / 8, rows = 32 / lpr;
  const int g = lane / lpr, sub = lane % lpr;
  const size_t col = (size_t)h * hd + sub * 8;
  const size_t stride = (size_t)3 * d;  // one qkv row
  const float* qrow = qkv + (size_t)j * stride;

  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    kv_new[(size_t)j * d + h * hd + i] = __float2bfloat16_rn(qrow[d + h * hd + i]);
    kv_new[(size_t)(kk + j) * d + h * hd + i] =
        __float2bfloat16_rn(qrow[2 * d + h * hd + i]);
  }
  float q[8], acc[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) q[jj] = qrow[col + jj] * q_scale;
  // tail row i is scored by row group g of warp w with i = w * rows + g
  // (ATT_WARPS * rows >= 8 >= K for every hd this kernel takes)
  const int i_tail = warp * rows + g;
  float st = 0.0f;
  if (i_tail <= j) {
    const float* k_i = qkv + i_tail * stride + d + h * hd + sub * 8;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) st += q[jj] * k_i[jj];
  }
  for (int o = lpr / 2; o > 0; o >>= 1) st += __shfl_xor_sync(0xffffffffu, st, o);
  if (i_tail <= j && sub == 0) s_tail[i_tail] = st;

  float m, l;
  attend_prefix(q, cache_k, cache_v, bias, min(pos, t_max), d, col, lpr, rows, g,
                sub, warp, p, scratch, m, l, acc);
  store_partials(acc, part, lpr, g, sub, warp, hd);  // its barrier publishes s_tail
  float m_f = m;
  for (int i = 0; i <= j; ++i) m_f = fmaxf(m_f, s_tail[i]);
  const float alpha = expf(m - m_f);
  float l_f = l * alpha;
  for (int i = 0; i <= j; ++i) l_f += expf(s_tail[i] - m_f);
  float* crow = ctx + (size_t)j * d + h * hd;
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float a = 0.0f;
    for (int w = 0; w < ATT_WARPS; ++w) a += part[w * hd + c];
    a *= alpha;
    for (int i = 0; i <= j; ++i) {
      a += expf(s_tail[i] - m_f) * qkv[i * stride + 2 * d + h * hd + c];
    }
    crow[c] = a / l_f;
  }
}

// One GEMV launch: int8 weights with a per-column scale (gsize == 0) or
// int4 nibble pairs with group scales of gsize contraction rows (gsize > 0).
struct GemvArgs {
  const float* x;
  const float* ln_w;
  const float* ln_b;
  const int8_t* w;
  int n_ktiles, ktile;
  const float* scale;
  int gsize;
  const float* bias;
  const float* res;
  float* out;
  int f_total, nrows;
};

template <int EPI, int NB, int CPW>
cudaError_t launch_dq_gemv(const GemvArgs& a, cudaStream_t stream) {
  const size_t k_total = (size_t)a.n_ktiles * a.ktile;
  const int grid = (a.f_total + GEMV_WARPS * CPW - 1) / (GEMV_WARPS * CPW);
  const size_t smem = GEMV_WARPS * CPW * k_total + a.nrows * k_total * sizeof(__nv_bfloat16)
                      + (a.ln_w != nullptr ? (2 + a.nrows) * k_total * sizeof(float) : 0);
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)dq_gemv_kernel<EPI, NB, CPW>, smem);
  if (e != cudaSuccess) return e;
  return vtt::launch_pdl(dq_gemv_kernel<EPI, NB, CPW>, dim3(grid), dim3(GEMV_WARPS * 32),
                         smem, stream, a.x, a.ln_w, a.ln_b, a.w, a.n_ktiles, a.ktile,
                         a.scale, a.bias, a.res, a.out, a.f_total, a.nrows);
}

template <int EPI, int NB>
cudaError_t launch_gemv_nb(const GemvArgs& a, cudaStream_t stream) {
  const size_t k_total = (size_t)a.n_ktiles * a.ktile;
  const int grid = (a.f_total + GEMV_WARPS - 1) / GEMV_WARPS;
  if (a.gsize == 0) {
    // an LN GEMV restages x and the LN constants in every block: two
    // columns a warp halve the blocks that do it, up to 8 rows
    if constexpr (EPI != EPI_RESIDUAL && NB <= 8) {
      if (a.ln_w != nullptr) return launch_dq_gemv<EPI, NB, 2>(a, stream);
    }
    return launch_dq_gemv<EPI, NB, 1>(a, stream);
  }
  const size_t smem = a.nrows * k_total * sizeof(__nv_bfloat16)
                      + (a.ln_w != nullptr ? k_total * sizeof(float) : 0);
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)dq_gemv4_kernel<EPI, NB>, smem);
  if (e != cudaSuccess) return e;
  dq_gemv4_kernel<EPI, NB><<<grid, GEMV_WARPS * 32, smem, stream>>>(
      a.x, a.ln_w, a.ln_b, a.w, a.n_ktiles, a.ktile, a.scale, a.gsize,
      a.bias, a.res, a.out, a.f_total, a.nrows);
  return cudaGetLastError();
}

// rows are rounded up to an instantiated accumulator count
template <int EPI>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  if (a.nrows <= 1) return launch_gemv_nb<EPI, 1>(a, stream);
  if (a.nrows <= 2) return launch_gemv_nb<EPI, 2>(a, stream);
  if (a.nrows <= 3) return launch_gemv_nb<EPI, 3>(a, stream);
  if (a.nrows <= 4) return launch_gemv_nb<EPI, 4>(a, stream);
  if (a.nrows <= 8) return launch_gemv_nb<EPI, 8>(a, stream);
  return launch_gemv_nb<EPI, 12>(a, stream);
}

}  // namespace

// Dequantizing GEMV over 1 <= nrows <= 12 rows with optional LN prologue
// and epilogue (0 none, 1 GELU-tanh, 2 residual add `res`).  gsize == 0:
// int8 weights [n_ktiles][F][ktile] and one scale per output column
// (`scale`, F floats); ktile % 16 == 0, w 16-byte aligned (the kernel runs
// under programmatic dependent launch).  gsize > 0: int4
// nibble pairs [n_ktiles][F][ktile / 2] and group scales
// [n_ktiles][F][ktile / gsize] (`scale`), an even number of groups a tile,
// gsize % 4 == 0.  ln_w / ln_b / res may be null where unused.
VTT_EXPORT int vtt_dq_gemv(const float* x, const float* ln_w, const float* ln_b,
                           const int8_t* w, int n_ktiles, int ktile,
                           const float* scale, int gsize, const float* bias,
                           const float* res, float* out, int f_total, int nrows,
                           int epilogue, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nrows < 1 || nrows > 12 || ktile % 4 != 0 || (gsize == 0 && ktile % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (gsize != 0 && (gsize < 0 || gsize % 4 != 0 || ktile % gsize != 0
                     || (ktile / gsize) % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const GemvArgs a{x, ln_w, ln_b, w, n_ktiles, ktile, scale, gsize, bias, res,
                   out, f_total, nrows};
  switch (epilogue) {
    case EPI_NONE:
      return (int)launch_gemv<EPI_NONE>(a, s);
    case EPI_GELU:
      return (int)launch_gemv<EPI_GELU>(a, s);
    case EPI_RESIDUAL:
      return (int)launch_gemv<EPI_RESIDUAL>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6's attention of one layer for 2 <= nrows <= 8 rows of one sequence at
// positions pos .. pos + nrows - 1; see verify_attend_kernel.  bf16 cache,
// hd as in vtt_decode_attend.
VTT_EXPORT int vtt_verify_attend(const float* qkv, const void* cache_k,
                                 const void* cache_v, const float* bias,
                                 int pos, int nrows, int t_max, int d,
                                 int heads, float q_scale, float* ctx,
                                 void* kv_new, void* stream) {
  const int hd = d / heads;
  if (d % heads != 0 || hd % 8 != 0 || 32 % (hd / 8) != 0 || nrows < 1
      || nrows > MAX_VERIFY || pos < 0 || pos + nrows > t_max) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)ATT_WARPS * hd * sizeof(float);
  verify_attend_kernel<<<dim3(heads, nrows), ATT_WARPS * 32, smem,
                         (cudaStream_t)stream>>>(
      qkv, static_cast<const __nv_bfloat16*>(cache_k),
      static_cast<const __nv_bfloat16*>(cache_v), bias, pos, t_max, d, hd,
      q_scale, ctx, static_cast<__nv_bfloat16*>(kv_new));
  return (int)cudaGetLastError();
}

// Attention of one layer for nrows rows; see attend_split_kernel.  hd = d /
// heads with hd % 8 == 0 and 32 % (hd / 8) == 0; cache rows 16-byte
// aligned.  int8_kv selects the int8 cache (scales required, kv_new f32)
// over bf16.  n_splits >= ceil(max pos / ATT_CHUNK) splits, at least 1;
// work: (nrows, heads, n_splits, hd + 2) f32 scratch; arrivals: (nrows,
// heads) int32, zero before the first launch and left zero by each.
VTT_EXPORT int vtt_decode_attend(const float* qkv, const void* cache_k,
                                 const void* cache_v, const float* scales,
                                 const float* bias, const int* src,
                                 const int* pos_rows, int pos, int nrows,
                                 int t_max, int d, int heads, float q_scale,
                                 float* ctx, void* kv_new, int int8_kv,
                                 float* work, int n_splits, int* arrivals,
                                 void* stream) {
  const int hd = d / heads;
  if (d % heads != 0 || hd % 8 != 0 || 32 % (hd / 8) != 0 || nrows < 1
      || (int8_kv && scales == nullptr) || n_splits < 1
      || (pos_rows == nullptr && (long long)n_splits * ATT_CHUNK < (pos < t_max ? pos : t_max))
      || (pos_rows != nullptr && (long long)n_splits * ATT_CHUNK < t_max)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(heads, nrows, n_splits);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t tail = (3 * ATT_CHUNK + std::max((size_t)ATT_WARPS * hd,
                                                 (size_t)n_splits * (hd + 2))) * sizeof(float);
  if (int8_kv) {
    const size_t smem = 2 * (size_t)ATT_CHUNK * hd + tail;
    const cudaError_t e = vtt::allow_dynamic_smem((const void*)attend_split_kernel<int8_t>, smem);
    if (e != cudaSuccess) return (int)e;
    return (int)vtt::launch_pdl(
        attend_split_kernel<int8_t>, grid, dim3(ATT_WARPS * 32), smem, s, qkv,
        static_cast<const int8_t*>(cache_k), static_cast<const int8_t*>(cache_v),
        scales, bias, src, pos_rows, pos, t_max, d, hd, q_scale, ctx, kv_new,
        work, arrivals);
  }
  const size_t smem = 2 * (size_t)ATT_CHUNK * hd * sizeof(__nv_bfloat16) + tail;
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)attend_split_kernel<__nv_bfloat16>,
                                                smem);
  if (e != cudaSuccess) return (int)e;
  return (int)vtt::launch_pdl(
      attend_split_kernel<__nv_bfloat16>, grid, dim3(ATT_WARPS * 32), smem, s, qkv,
      static_cast<const __nv_bfloat16*>(cache_k), static_cast<const __nv_bfloat16*>(cache_v),
      scales, bias, src, pos_rows, pos, t_max, d, hd, q_scale, ctx, kv_new, work,
      arrivals);
}

VTT_EXPORT const char* vtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
