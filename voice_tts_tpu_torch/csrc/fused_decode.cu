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
// K6 is the same chain over its K rows with `verify_split` in place of
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
// L = 24, D = 1280, so about 0.075 ms at 3.35 TB/s; one layer's four
// GEMVs read 9.8 MB, 3 us.  A tile is stored (out, in/2): one output
// column's D/2 bytes run along the contraction axis, byte k holding
// contraction row k in its low nibble and row k + D/2 in its high nibble;
// its group scales (G per tile, one per `gsize` contraction rows of each
// half) sit beside it, contiguous.  As with the int8 GEMV, a launch's own
// work is a few microseconds, so the design fights latency and issue
// count: it runs under programmatic dependent launch, with the block's
// nibble slab, scales and biases in flight (cp.async) before the
// dependency wait; one block owns 1-4 runs of 8 columns (a run is one
// tensor-core tile wide; more on the LN GEMVs, whose every block restages
// x and the LN constants: qkv and fc 160 blocks); the group sums run on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulation), a warp
// a (run, tile, group) unit, the nibbles converted to exact bf16 pairs with a byte permute, a
// mask and one bf16 subtraction (1.5 instructions a nibble where the CUDA
// cores took 4 with the product); each group's sum is multiplied by its
// scale and the sums added in group, then tile order by one thread a row
// and column, as the JAX default scheme (`int4_expand=False`) sums its
// per-group products.  The block's warps (4-16) come from the planner
// (`plan_int4_gemv`): as few rounds of units as 16 warps allow.
//
// K6, the verify attention (`verify_split`).  Bound: device memory, the
// int8 trunk once for all K rows (472 MB) plus the bf16 prefix (37 MB at
// pos 300): about 0.15 ms at 3.35 TB/s.  Row j attends the committed
// prefix [0, pos) of the sequence's cache row under the bias, then rows
// i <= j of the K current tokens with their unrounded f32 k/v read from
// `qkv` (never through the cache: the JAX kernel keeps the causal tail in
// f32); the k/v rows written for the cache are rounded to bf16.  The
// Pallas kernel's shared slab joined to the split-prefix design of
// `attend_split`: one block per (head, prefix split of `verify_splits`
// positions, 32-256) attends its split for all K rows, so each prefix row
// is read from device memory once per head, not once per row; the split's
// k and v rows go to shared memory (cp.async) before the dependency wait;
// the last block of a head to arrive stages every split's partials in
// shared memory and combines them in split order, then the causal tail:
// no launch of its own, deterministic.  200 blocks at pos 300, 320 at pos
// 1500 (the unsplit kernel launched 80).  In a device loop the position
// is an int in device memory (JAX's `pos0 = p + s.step` from the loop
// state): the grid is then a fixed plan for the cache (`verify_plan`), a
// block whose split starts at or past the position only arrives, and the
// combine takes the live splits alone, as the host-int form does.
//
// K6 over an int4 pack (`fused_decode.py:1322` with `FusedDecodePackInt4`):
// the same chain, every trunk GEMV K7's `dq_gemv4` over the K rows (its
// LN prologue and epilogues, up to 12 rows, grids from `plan_int4_gemv`),
// `verify_split` unchanged.  Bound: 236 MB of nibble pairs plus 14.7 MB of
// g128 scales, once for all K rows, and the bf16 prefix: about 0.08 ms at
// pos 300.  The group sums on the tensor cores are not sequential IEEE f32
// sums, so it matches its plain version within a tolerance, and two calls
// are bit-equal.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int GEMV_WARPS = 8;
constexpr int GEMV4_MIN_WARPS = 4, GEMV4_MAX_WARPS = 16;  // K7: a block's warps
constexpr int GEMV4_MAX_COL_BLOCKS = 4;  // K7: runs of 8 output columns a block
constexpr int ATT_WARPS = 8;
constexpr int ATT_CHUNK = 256;
constexpr int MAX_VERIFY = 8;   // K6 rows
constexpr int VERIFY_MAX_SPLIT = 256;   // K6 prefix positions a block

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
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
// bf16 rows of xs_stride elements (xs), k_total % 4 == 0, each thread's
// 16-byte loads of device memory issued STAGE_BATCH at a time before any
// is used (one round trip a batch, not one a load).  With an LN prologue
// (xf != nullptr) the rows are first copied as f32 into xf (nrows *
// k_total f32 of shared memory), then one warp a row takes the mean and
// variance from there with warp reductions and writes the normalised row
// times lnw plus lnb (k_total f32 each, staged in shared memory by the
// caller).  Ends with a barrier.
constexpr int STAGE_BATCH = 4;
__device__ __forceinline__ void stage_rows_smem(const float* __restrict__ x, float* xf,
                                                   const float* lnw, const float* lnb,
                                                   __nv_bfloat16* xs, int xs_stride,
                                                   int k_total, int nrows) {
  const int k4 = k_total / 4;
  const int n4 = nrows * k4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int i0 = threadIdx.x; i0 < n4; i0 += STAGE_BATCH * blockDim.x) {
    float4 v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = x4[i];
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n4) break;
      if (xf != nullptr) {
        reinterpret_cast<float4*>(xf)[i] = v[u];
      } else {
        const int r = i / k4, c = i % k4;
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + (size_t)r * xs_stride) + 2 * c;
        dst[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
        dst[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
      }
    }
  }
  __syncthreads();
  if (xf == nullptr) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nwarps) {
    const float4* xr = reinterpret_cast<const float4*>(xf + (size_t)r * k_total);
    float sm = 0.0f;
    for (int i = lane; i < k4; i += 32) {
      const float4 v = xr[i];
      sm += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = vtt::warp_sum(sm) / (float)k_total;
    float q = 0.0f;
    for (int i = lane; i < k4; i += 32) {
      const float4 v = xr[i];
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, e = v.w - mean;
      q += (a * a + b * b) + (c * c + e * e);
    }
    const float rstd = rsqrtf(vtt::warp_sum(q) / (float)k_total + 1e-5f);
    __nv_bfloat162* xb = reinterpret_cast<__nv_bfloat162*>(xs + (size_t)r * xs_stride);
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
  stage_rows_smem(x, ln_w != nullptr ? xf : nullptr, lnw, lnb, xs, k_total, k_total, nrows);
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

// Two nibbles of a packed word whose nibbles had their sign bit flipped
// (word ^ 0x88888888: 0..15 for -8..7) as a bf16 pair, exactly: bytes
// `sel` of the word spread to the pair's halves (a byte permute), the
// nibble at `shift` of each or'ed into 0x4300 (bf16 128 + u), then 136
// subtracted from both halves.
template <int SEL, int SHIFT>
__device__ __forceinline__ unsigned nibbles_to_bf16x2(unsigned flipped) {
  const unsigned v = ((__byte_perm(flipped, 0u, SEL) >> SHIFT) & 0x000F000Fu) | 0x43004300u;
  unsigned out;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(v), "r"(0x43084308u));
  return out;
}

// D += A B on the tensor cores: m16n8k16, bf16 inputs, f32 accumulation
// (A 16 x 16 row-major in four registers, B 16 x 8 in two, D 16 x 8).
__device__ __forceinline__ void mma_bf16_16816(float* d, unsigned a0, unsigned a1, unsigned a2,
                                               unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The int4 GEMV (K7), launched with programmatic dependent launch:
// out[r, f] = epi(sum over the contraction tiles, in order, of the tile's
// sum over its groups, in group order (low half, then high half), of
// (sum_k bf16(ln(x[r]))[k] * nibble[f, k]) * gscale[f, g], then + bias[f]).
// W: [n_ktiles][F][ktile/2] nibble pairs (byte k: contraction row k low,
// row k + ktile/2 high); gscale: [n_ktiles][F][G], G = ktile / gsize, the
// low half's G/2 groups first.  A block owns col_blocks runs of 8 output
// columns (a run is one tensor-core tile wide).  Before the dependency
// wait it puts its nibble slab (a contiguous run of each tile; in shared
// memory each column padded by 16 bytes, so that 8 columns' reads fall in
// distinct banks), group scales and biases in flight as 16-byte cp.async
// copies, with the LN constants; after it, it stages x as bf16 (through
// the LN; its loads batched) and reads the residual rows.  The group sums
// run on the tensor cores: a unit is one run, tile and group, and the
// block's warps (4-16, the planner's choice) take the units in turn.  A
// unit is gsize / 16 steps of two m16n8k16 products (low half, high half)
// into two f32 accumulators: lane (g, t) loads 4 bytes of column g at 4t
// of the step's 16 and the 4 activations of row g they multiply (one
// permutation of the step's 16 contraction rows for both operands), and
// converts the 8 nibbles into 4 exact bf16 pairs with a byte permute, a
// mask and one bf16 subtraction; the rows past nrows are zeros.  A unit's
// group sums, each times its column's group scale, go to shared memory;
// then one thread a (row, column) adds them in tile and group order, adds
// the bias and applies the epilogue.  BIG: more than 8 rows (the A rows
// g + 8 are live).  Dynamic shared memory: the slab 8 * col_blocks *
// (ktile / 2 + 16) bytes a tile, the scales (n_ktiles * 8 * col_blocks * G
// f32), the biases, the units' scaled sums (units * 2 * nrows * 8 f32),
// the bf16 rows (nrows * (K + 8)), and with an LN the LN weight and bias
// (K f32 each) and the f32 rows.
template <int EPI, bool BIG>
__global__ void __launch_bounds__(GEMV4_MAX_WARPS * 32)
dq_gemv4_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const int8_t* __restrict__ w,
                int n_ktiles, int ktile, const float* __restrict__ gscale,
                int gsize, const float* __restrict__ bias, const float* res,
                float* out, int f_total, int nrows, int col_blocks) {
  extern __shared__ uint4 smem4[];
  const int kcols = 8 * col_blocks;          // output columns a block owns
  const int k_total = n_ktiles * ktile;
  const int half = ktile / 2;                // packed bytes of a column a tile
  const int cstride = half + 16;             // a column's bytes in shared memory
  const int n_groups = ktile / gsize;
  const int per_half = n_groups / 2;
  const int n_units = col_blocks * n_ktiles * per_half;
  const int xstride = k_total + 8;           // a bf16 row in shared memory
  int8_t* ws = reinterpret_cast<int8_t*>(smem4);                       // [n_ktiles][kcols][cstride]
  float* gss = reinterpret_cast<float*>(ws + (size_t)n_ktiles * kcols * cstride);  // [n_ktiles][kcols][G]
  float* bs = gss + (size_t)n_ktiles * kcols * n_groups;               // [kcols]
  float* gsum = bs + kcols;                  // [n_units][2][nrows][8]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(gsum + (size_t)n_units * 2 * nrows * 8);
  float* lnw = reinterpret_cast<float*>(xs + (size_t)nrows * xstride);  // LN only
  float* lnb = lnw + k_total;
  float* xf = lnb + k_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int col0 = blockIdx.x * kcols;
  const int ncols = min(kcols, f_total - col0);   // a multiple of 8

  if (ln_w != nullptr) {                     // copy group 1: the LN constants
    for (int i = tid; i < k_total / 4; i += blockDim.x) {
      vtt::cp_async16(lnw + 4 * i, ln_w + 4 * i);
      vtt::cp_async16(lnb + 4 * i, ln_b + 4 * i);
    }
  }
  vtt::cp_async_commit();
  const int cchunks = half / 16;             // 16-byte copies a column and tile
  for (int i = tid; i < n_ktiles * ncols * cchunks; i += blockDim.x) {
    const int kc = i / cchunks, s = i - kc * cchunks;   // kc = kt * ncols + column
    const int kt = kc / ncols, c = kc - kt * ncols;
    vtt::cp_async16(ws + ((size_t)kt * kcols + c) * cstride + s * 16,
                    w + ((size_t)kt * f_total + col0 + c) * half + s * 16);
  }
  const int gseg = ncols * n_groups / 4;     // scale copies a k-tile
  for (int i = tid; i < n_ktiles * gseg; i += blockDim.x) {
    const int kt = i / gseg, s = i - kt * gseg;
    vtt::cp_async16(gss + (size_t)kt * kcols * n_groups + s * 4,
                    gscale + ((size_t)kt * f_total + col0) * n_groups + s * 4);
  }
  if (tid < ncols / 4) vtt::cp_async16(bs + 4 * tid, bias + col0 + 4 * tid);
  vtt::cp_async_commit();                    // copy group 2: slab, scales, biases

  vtt::grid_dependency_wait();
  // the epilogue's (row, column) elements of this thread: their residuals now
  constexpr int kEpi = 3;                    // 12 rows x 32 columns over 128 threads
  const int n_out = nrows * ncols;
  float rv[kEpi];
#pragma unroll
  for (int j = 0; j < kEpi; ++j) {
    const int e = tid + j * blockDim.x;
    rv[j] = EPI == EPI_RESIDUAL && e < n_out
                ? res[(size_t)(e / ncols) * f_total + col0 + e % ncols] : 0.0f;
  }
  vtt::cp_async_wait<1>();                   // the LN constants; the barrier in
                                             // stage_rows_smem publishes them
  stage_rows_smem(x, ln_w != nullptr ? xf : nullptr, lnw, lnb, xs, xstride, k_total, nrows);
  vtt::cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;     // the fragments' group and lane in it
  const bool row_lo = g < nrows, row_hi = BIG && g + 8 < nrows;
  for (int u = warp; u < n_units; u += nwarps) {
    const int nb = u % col_blocks, kg = u / col_blocks;   // a group's column blocks
    const int kt = kg / per_half, gi = kg - kt * per_half;
    if (nb * 8 >= ncols) continue;           // uniform across the warp
    const int8_t* wc = ws + ((size_t)kt * kcols + nb * 8 + g) * cstride;
    const __nv_bfloat16* xr = xs + (size_t)kt * ktile;
    float dlo[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dhi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = gi * gsize; k0 < (gi + 1) * gsize; k0 += 16) {
      const int k = k0 + 4 * t;
      const unsigned q = *reinterpret_cast<const unsigned*>(wc + k) ^ 0x88888888u;
      uint2 alo = make_uint2(0u, 0u), ahi = make_uint2(0u, 0u);
      uint2 alo8 = make_uint2(0u, 0u), ahi8 = make_uint2(0u, 0u);
      if (row_lo) {
        alo = *reinterpret_cast<const uint2*>(xr + (size_t)g * xstride + k);
        ahi = *reinterpret_cast<const uint2*>(xr + (size_t)g * xstride + half + k);
      }
      if (row_hi) {
        alo8 = *reinterpret_cast<const uint2*>(xr + (size_t)(g + 8) * xstride + k);
        ahi8 = *reinterpret_cast<const uint2*>(xr + (size_t)(g + 8) * xstride + half + k);
      }
      mma_bf16_16816(dlo, alo.x, alo8.x, alo.y, alo8.y, nibbles_to_bf16x2<0x4140, 0>(q),
                     nibbles_to_bf16x2<0x4342, 0>(q));
      mma_bf16_16816(dhi, ahi.x, ahi8.x, ahi.y, ahi8.y, nibbles_to_bf16x2<0x4140, 4>(q),
                     nibbles_to_bf16x2<0x4342, 4>(q));
    }
    // the unit's group sums of (row g | g + 8, columns 2t, 2t + 1), each
    // times its column's scale
    const float* sc = gss + ((size_t)kt * kcols + nb * 8) * n_groups;
    float* gu = gsum + (size_t)u * 2 * nrows * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, c = 2 * t + (e & 1);
      if (r < nrows) {
        gu[r * 8 + c] = __fmul_rn(dlo[e], sc[c * n_groups + gi]);
        gu[(nrows + r) * 8 + c] = __fmul_rn(dhi[e], sc[c * n_groups + per_half + gi]);
      }
    }
  }
  vtt::launch_dependents();
  __syncthreads();
  // a thread a (row, column) element: the scaled group sums in group order
  // into each tile's sum, the tiles' sums in tile order, then bias and
  // epilogue
#pragma unroll
  for (int j = 0; j < kEpi; ++j) {
    const int e = tid + j * blockDim.x;
    if (e >= n_out) break;
    const int er = e / ncols, ec = e % ncols, nb = ec >> 3, c8 = ec & 7;
    float acc = 0.0f;
    for (int kt = 0; kt < n_ktiles; ++kt) {
      float tile = 0.0f;
      for (int gi = 0; gi < per_half; ++gi) {
        const float* gu =
            gsum + (size_t)((kt * per_half + gi) * col_blocks + nb) * 2 * nrows * 8;
        tile = __fadd_rn(tile, gu[er * 8 + c8]);
        tile = __fadd_rn(tile, gu[(nrows + er) * 8 + c8]);
      }
      acc = __fadd_rn(acc, tile);
    }
    float y = __fadd_rn(acc, bs[ec]);
    if (EPI == EPI_GELU) y = gelu_tanh(y);
    if (EPI == EPI_RESIDUAL) y = rv[j] + y;
    out[(size_t)er * f_total + col0 + ec] = y;
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

// K6's attention (split prefix), launched with programmatic dependent
// launch: K <= KMAX rows of ONE sequence at positions pos .. pos + K - 1.
// Row j attends the committed prefix [0, pos) of the sequence's cache row
// under the bias, then rows i <= j of the K current tokens with their
// unrounded f32 k/v from `qkv` (K rows of (3D) f32 [q | k | v]).  One block
// per (head, split): split s covers prefix positions [s * split_t, (s + 1)
// * split_t), and the block attends them for all K rows at once, so each
// prefix row is read from device memory once per head, not once per row.
// The cache and the bias are read-only for the step, so before the
// dependency wait the block copies its split's k and v rows into shared
// memory (16-byte cp.async) and stages the bias; after it, it reads the K
// queries.  A position's k row is read once for the K scores, a warp takes
// a row's softmax over the split, and a position's v row is read once for
// the K weighted sums.  Each block writes every row's (o, m, l) to `work`
// [H][S][K][hd + 2] (a split with no live position: m = -inf, l = 0, o =
// 0) and counts itself in `arrivals` [H]; the last block of a head to
// arrive resets the count and combines, for each row, the splits in split
// order, then the causal tail, and writes ctx and the bf16 kv_new rows: no
// launch of its own, and the same result whichever block comes last.
// cache_k, cache_v: this layer's (1, Tmax, D) bf16 planes; bias: (1, Tmax)
// f32; kv_new: (2, K, D) bf16.  Dynamic shared memory: k and v [split_t][hd]
// bf16 each, the scores [K][split_t], the bias [split_t] and the warp
// partials [ATT_WARPS][K][hd] f32.
// Bytes of shared memory at the start of K6's block: its split's k and v
// rows, which then hold every split's (o, m, l) of every row for the
// combine; a multiple of 16.
__host__ __device__ __forceinline__ size_t verify_kv_bytes(int split_t, int hd, int n_splits,
                                                           int kk) {
  const size_t kv = 2 * (size_t)split_t * hd * sizeof(__nv_bfloat16);
  const size_t comb = (size_t)n_splits * kk * (hd + 2) * sizeof(float);
  return ((kv > comb ? kv : comb) + 15) / 16 * 16;
}

template <int KMAX>
__global__ void __launch_bounds__(ATT_WARPS * 32)
verify_split_kernel(const float* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ cache_k,
                    const __nv_bfloat16* __restrict__ cache_v,
                    const float* __restrict__ bias, int pos_arg,
                    const int* __restrict__ pos_dev, int t_max, int kk, int d, int hd,
                    float q_scale, int split_t, float* __restrict__ ctx,
                    __nv_bfloat16* __restrict__ kv_new, float* __restrict__ work,
                    int* __restrict__ arrivals) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vc = kc + (size_t)split_t * hd;
  float* p = reinterpret_cast<float*>(                                // [kk][split_t]
      smem + verify_kv_bytes(split_t, hd, gridDim.y, kk));
  float* bs = p + (size_t)kk * split_t;                              // [split_t]
  float* part = bs + split_t;      // [ATT_WARPS][kk][hd]; the combine's tail scores
  __shared__ float ml[KMAX][2];    // each row's max and sum over the split
  __shared__ int last;
  const int h = blockIdx.x, sp = blockIdx.y;
  const int n_splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = hd / 8, rows = 32 / lpr;
  const int g = lane / lpr, sub = lane % lpr;
  const size_t row3 = (size_t)3 * d;         // one qkv row
  // a device position is clamped to [0, t_max - kk]: no read past the cache
  const int pos = pos_dev != nullptr ? min(max(__ldg(pos_dev), 0), t_max - kk) : pos_arg;
  const int n_live = max(1, (pos + split_t - 1) / split_t);   // splits with work
  const int c0 = sp * split_t;
  const int n = max(0, min(split_t, pos - c0));

  // the split's k and v rows and its bias: read-only for the step
  const int segs = hd / 8;                   // 16-byte copies a row
  for (int i = tid; i < n * segs; i += blockDim.x) {
    const int tt = i / segs, sg = i % segs;
    const size_t at = (size_t)(c0 + tt) * d + (size_t)h * hd + sg * 8;
    vtt::cp_async16(kc + (size_t)tt * hd + sg * 8, cache_k + at);
    vtt::cp_async16(vc + (size_t)tt * hd + sg * 8, cache_v + at);
  }
  vtt::cp_async_commit();
  for (int tt = tid; tt < n; tt += blockDim.x) bs[tt] = bias[c0 + tt];

  vtt::grid_dependency_wait();
  float q[KMAX][8];                          // the K queries' 8 values of this lane
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[j][i] = j < kk ? qkv[j * row3 + (size_t)h * hd + sub * 8 + i] * q_scale : 0.0f;
    }
  vtt::cp_async_wait<0>();
  __syncthreads();

  if (n > 0) {                               // uniform across the block
    for (int r0 = warp * rows; r0 < n; r0 += ATT_WARPS * rows) {
      const int tt = r0 + g;
      float kr[8], s[KMAX];
      if (tt < n) {
        load8(kc + (size_t)tt * hd + sub * 8, kr);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kr[i] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        s[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s[j] += q[j][i] * kr[i];
        for (int o = lpr / 2; o > 0; o >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      if (tt < n && sub == 0) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < kk) p[(size_t)j * split_t + tt] = s[j] + bs[tt];
        }
      }
    }
    __syncthreads();
    if (warp < kk) {                         // warp j: row j's softmax over the split
      float* pj = p + (size_t)warp * split_t;
      float cm = -INFINITY;
      for (int tt = lane; tt < n; tt += 32) cm = fmaxf(cm, pj[tt]);
      cm = vtt::warp_max(cm);
      float ps = 0.0f;
      for (int tt = lane; tt < n; tt += 32) {
        const float e = expf(pj[tt] - cm);
        pj[tt] = e;
        ps += e;
      }
      ps = vtt::warp_sum(ps);
      if (lane == 0) {
        ml[warp][0] = cm;
        ml[warp][1] = ps;
      }
    }
    __syncthreads();
    float acc[KMAX][8];
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
    for (int tt = warp * rows + g; tt < n; tt += ATT_WARPS * rows) {
      float vr[8];
      load8(vc + (size_t)tt * hd + sub * 8, vr);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        const float pt = j < kk ? p[(size_t)j * split_t + tt] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] += pt * vr[i];
      }
    }
    // the row groups of each warp (lanes sharing `sub`), then per warp
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        for (int o = lpr; o < 32; o <<= 1) acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], o);
      }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < kk) {
#pragma unroll
          for (int i = 0; i < 8; ++i) part[((size_t)warp * kk + j) * hd + sub * 8 + i] = acc[j][i];
        }
      }
    }
  }
  vtt::launch_dependents();
  __syncthreads();

  const int stride = hd + 2;                 // one row's (o, m, l)
  float* mine = work + ((size_t)h * n_splits + sp) * kk * stride;
  if (sp < n_live) {                         // a split past the position only arrives
    for (int i = tid; i < kk * hd; i += blockDim.x) {
      const int j = i / hd, c = i % hd;
      float a = 0.0f;
      if (n > 0) {
        for (int w = 0; w < ATT_WARPS; ++w) a += part[((size_t)w * kk + j) * hd + c];
      }
      mine[j * stride + c] = a;
    }
    if (tid < kk) {
      mine[tid * stride + hd] = n > 0 ? ml[tid][0] : -INFINITY;
      mine[tid * stride + hd + 1] = n > 0 ? ml[tid][1] : 0.0f;
    }
  }
  __threadfence();                           // the partials before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + h, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                           // the other splits' partials after it
  if (tid == 0) arrivals[h] = 0;

  // the combine: every split's (o, m, l) of every row into shared memory at
  // once (over the k and v rows), and the causal tail's scores, row j
  // against the unrounded k of token i <= j (a warp a pair)
  const size_t split_stride = (size_t)kk * stride;
  float* all = reinterpret_cast<float*>(smem);   // [n_splits][kk][hd + 2]
  const float* mine_all = work + (size_t)h * n_splits * split_stride;
  for (int i = tid; i < n_live * (int)split_stride; i += blockDim.x) {
    all[i] = __ldcg(mine_all + i);
  }
  float* s_tail = part;                      // [kk][kk]
  for (int pr = warp; pr < kk * kk; pr += ATT_WARPS) {
    const int j = pr / kk, i = pr % kk;
    if (i > j) continue;                     // uniform across the warp
    float s = 0.0f;
    for (int c = lane; c < hd; c += 32) {
      s += qkv[j * row3 + (size_t)h * hd + c] * q_scale * qkv[i * row3 + d + (size_t)h * hd + c];
    }
    s = vtt::warp_sum(s);
    if (lane == 0) s_tail[pr] = s;
  }
  __syncthreads();
  // then, for each row and value: the splits in split order (the
  // online-softmax recurrence, a split with m = -inf adding nothing), then
  // rows i <= j of the tail; and the kv rows for the cache, in bf16
  for (int e = tid; e < kk * hd; e += blockDim.x) {
    const int j = e / hd, c = e % hd;
    const float* oj = all + (size_t)j * stride;
    float m_run = oj[hd], l_run = oj[hd + 1], a = oj[c];
    for (int s = 1; s < n_live; ++s) {
      const float* os = oj + s * split_stride;
      const float ms = os[hd];
      const float m_new = fmaxf(m_run, ms);
      if (m_new == -INFINITY) continue;      // no live position yet
      const float keep = expf(m_run - m_new), add = expf(ms - m_new);
      l_run = l_run * keep + os[hd + 1] * add;
      a = a * keep + os[c] * add;
      m_run = m_new;
    }
    float m_f = m_run;
    for (int i = 0; i <= j; ++i) m_f = fmaxf(m_f, s_tail[j * kk + i]);
    const float alpha = expf(m_run - m_f);
    float l_f = l_run * alpha;
    a *= alpha;
    const size_t hc = (size_t)h * hd + c;
    for (int i = 0; i <= j; ++i) {
      const float pt = expf(s_tail[j * kk + i] - m_f);
      l_f += pt;
      a += pt * qkv[i * row3 + 2 * d + hc];
    }
    ctx[(size_t)j * d + hc] = a / l_f;
    kv_new[(size_t)j * d + hc] = __float2bfloat16_rn(qkv[j * row3 + d + hc]);
    kv_new[(size_t)(kk + j) * d + hc] = __float2bfloat16_rn(qkv[j * row3 + 2 * d + hc]);
  }
}

// One GEMV launch: int8 weights with a per-column scale, or int4 nibble
// pairs with group scales of gsize contraction rows (`scale`).
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

template <int EPI, bool BIG>
cudaError_t launch_dq_gemv4(const GemvArgs& a, int warps, int col_blocks, cudaStream_t stream) {
  const size_t kcols = 8 * col_blocks;
  const size_t k_total = (size_t)a.n_ktiles * a.ktile;
  const int grid = (a.f_total + (int)kcols - 1) / (int)kcols;
  const size_t n_groups = a.ktile / a.gsize;
  const size_t units = col_blocks * a.n_ktiles * n_groups / 2;
  const size_t smem = a.n_ktiles * kcols * (a.ktile / 2 + 16)
                      + (a.n_ktiles * kcols * n_groups + kcols + units * 2 * a.nrows * 8)
                            * sizeof(float)
                      + a.nrows * (k_total + 8) * sizeof(__nv_bfloat16)
                      + (a.ln_w != nullptr ? (2 + a.nrows) * k_total * sizeof(float) : 0);
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)dq_gemv4_kernel<EPI, BIG>, smem);
  if (e != cudaSuccess) return e;
  return vtt::launch_pdl(dq_gemv4_kernel<EPI, BIG>, dim3(grid), dim3(warps * 32), smem, stream,
                         a.x, a.ln_w, a.ln_b, a.w, a.n_ktiles, a.ktile, a.scale, a.gsize,
                         a.bias, a.res, a.out, a.f_total, a.nrows, col_blocks);
}

template <int EPI>
cudaError_t launch_gemv4_epi(const GemvArgs& a, int warps, int col_blocks, cudaStream_t stream) {
  return a.nrows > 8 ? launch_dq_gemv4<EPI, true>(a, warps, col_blocks, stream)
                     : launch_dq_gemv4<EPI, false>(a, warps, col_blocks, stream);
}

// cpw: output columns a warp (1, or 2 for an LN GEMV up to 8 rows)
template <int EPI, int NB>
cudaError_t launch_gemv_nb(const GemvArgs& a, int cpw, cudaStream_t stream) {
  if constexpr (EPI != EPI_RESIDUAL && NB <= 8) {
    if (cpw == 2) return launch_dq_gemv<EPI, NB, 2>(a, stream);
  }
  if (cpw != 1) return cudaErrorInvalidValue;
  return launch_dq_gemv<EPI, NB, 1>(a, stream);
}

// rows are rounded up to an instantiated accumulator count
template <int EPI>
cudaError_t launch_gemv(const GemvArgs& a, int cpw, cudaStream_t stream) {
  if (a.nrows <= 1) return launch_gemv_nb<EPI, 1>(a, cpw, stream);
  if (a.nrows <= 2) return launch_gemv_nb<EPI, 2>(a, cpw, stream);
  if (a.nrows <= 3) return launch_gemv_nb<EPI, 3>(a, cpw, stream);
  if (a.nrows <= 4) return launch_gemv_nb<EPI, 4>(a, cpw, stream);
  if (a.nrows <= 8) return launch_gemv_nb<EPI, 8>(a, cpw, stream);
  return launch_gemv_nb<EPI, 12>(a, cpw, stream);
}

template <int KMAX>
int launch_verify(dim3 grid, size_t smem, cudaStream_t s, const float* qkv,
                  const __nv_bfloat16* ck, const __nv_bfloat16* cv, const float* bias,
                  int pos, const int* pos_dev, int t_max, int nrows, int d, int hd,
                  float q_scale, int split_t, float* ctx, __nv_bfloat16* kvn, float* work,
                  int* arrivals) {
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)verify_split_kernel<KMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)vtt::launch_pdl(verify_split_kernel<KMAX>, grid, dim3(ATT_WARPS * 32), smem, s,
                              qkv, ck, cv, bias, pos, pos_dev, t_max, nrows, d, hd, q_scale,
                              split_t, ctx, kvn, work, arrivals);
}

int launch_gemv_epi(const GemvArgs& a, int epilogue, int cpw, cudaStream_t s) {
  switch (epilogue) {
    case EPI_NONE:
      return (int)launch_gemv<EPI_NONE>(a, cpw, s);
    case EPI_GELU:
      return (int)launch_gemv<EPI_GELU>(a, cpw, s);
    case EPI_RESIDUAL:
      return (int)launch_gemv<EPI_RESIDUAL>(a, cpw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The int8 dequantizing GEMV over 1 <= nrows <= 12 rows with optional LN
// prologue and epilogue (0 none, 1 GELU-tanh, 2 residual add `res`): int8
// weights [n_ktiles][F][ktile] and one scale per output column (`scale`, F
// floats); ktile % 16 == 0, w 16-byte aligned (the kernel runs under
// programmatic dependent launch).  An LN GEMV (ln_w set) up to 8 rows
// takes two columns a warp: that halves the blocks that restage x and the
// LN constants.  ln_w / ln_b / res may be null where unused.
VTT_EXPORT int vtt_dq_gemv(const float* x, const float* ln_w, const float* ln_b,
                           const int8_t* w, int n_ktiles, int ktile,
                           const float* scale, const float* bias,
                           const float* res, float* out, int f_total, int nrows,
                           int epilogue, void* stream) {
  if (nrows < 1 || nrows > 12 || ktile % 16 != 0) return (int)cudaErrorInvalidValue;
  const GemvArgs a{x, ln_w, ln_b, w, n_ktiles, ktile, scale, 0, bias, res,
                   out, f_total, nrows};
  const int cpw = ln_w != nullptr && epilogue != EPI_RESIDUAL && nrows <= 8 ? 2 : 1;
  return launch_gemv_epi(a, epilogue, cpw, (cudaStream_t)stream);
}

// The int4 GEMV (K7) over 1 <= nrows <= 12 rows; see dq_gemv4_kernel.
// Nibble pairs [n_ktiles][F][ktile / 2] and group scales [n_ktiles][F][G],
// G = ktile / gsize even; gsize % 16 == 0, ktile % 32 == 0, F % 8 == 0,
// w, gscale and bias 16-byte aligned.  warps (4-16) and col_blocks (1-4
// runs of 8 output columns) a block come from the caller's plan
// (`plan_int4_gemv`).  ln_w / ln_b / res may be null where unused.
VTT_EXPORT int vtt_dq_gemv4(const float* x, const float* ln_w, const float* ln_b,
                            const int8_t* w, int n_ktiles, int ktile,
                            const float* gscale, int gsize, const float* bias,
                            const float* res, float* out, int f_total, int nrows,
                            int epilogue, int warps, int col_blocks, void* stream) {
  if (nrows < 1 || nrows > 12 || n_ktiles < 1 || ktile % 32 != 0 || f_total % 8 != 0
      || gsize < 16 || gsize % 16 != 0 || ktile % gsize != 0 || (ktile / gsize) % 2 != 0
      || warps < GEMV4_MIN_WARPS || warps > GEMV4_MAX_WARPS || col_blocks < 1
      || col_blocks > GEMV4_MAX_COL_BLOCKS) {
    return (int)cudaErrorInvalidValue;
  }
  const GemvArgs a{x, ln_w, ln_b, w, n_ktiles, ktile, gscale, gsize, bias, res,
                   out, f_total, nrows};
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_NONE:
      return (int)launch_gemv4_epi<EPI_NONE>(a, warps, col_blocks, s);
    case EPI_GELU:
      return (int)launch_gemv4_epi<EPI_GELU>(a, warps, col_blocks, s);
    case EPI_RESIDUAL:
      return (int)launch_gemv4_epi<EPI_RESIDUAL>(a, warps, col_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6's attention of one layer for 1 <= nrows <= 8 rows of one sequence at
// positions pos .. pos + nrows - 1; see verify_split_kernel.  bf16 cache,
// hd as in vtt_decode_attend.  pos is the host int `pos` when pos_dev is
// null, else the int at pos_dev, read on the device and clamped to [0,
// t_max - nrows].  The prefix [0, pos) in n_splits splits of split_t
// positions (`verify_splits`, or `verify_plan` for a device position):
// 1 <= split_t <= VERIFY_MAX_SPLIT, n_splits * split_t >= pos (>= t_max -
// nrows for a device position), at least one split; work: (heads,
// n_splits, nrows, hd + 2) f32 scratch; arrivals: (heads,) int32, zero
// before the first launch and left zero by each.
VTT_EXPORT int vtt_verify_attend(const float* qkv, const void* cache_k,
                                 const void* cache_v, const float* bias,
                                 int pos, const int* pos_dev, int nrows, int t_max,
                                 int d, int heads, float q_scale, float* ctx,
                                 void* kv_new, float* work, int split_t,
                                 int n_splits, int* arrivals, void* stream) {
  const int hd = d / heads;
  const long long cover = (long long)n_splits * split_t;
  if (d % heads != 0 || hd % 8 != 0 || 32 % (hd / 8) != 0 || nrows < 1
      || nrows > MAX_VERIFY || nrows > t_max || split_t < 1
      || split_t > VERIFY_MAX_SPLIT || n_splits < 1
      || (pos_dev == nullptr && (pos < 0 || pos + nrows > t_max || cover < pos))
      || (pos_dev != nullptr && cover < t_max - nrows)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = verify_kv_bytes(split_t, hd, n_splits, nrows)
                      + ((size_t)(nrows + 1) * split_t + (size_t)ATT_WARPS * nrows * hd)
                            * sizeof(float);
  const dim3 grid(heads, n_splits);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* ck = static_cast<const __nv_bfloat16*>(cache_k);
  const auto* cv = static_cast<const __nv_bfloat16*>(cache_v);
  auto* kvn = static_cast<__nv_bfloat16*>(kv_new);
  if (nrows <= 4) {
    return launch_verify<4>(grid, smem, s, qkv, ck, cv, bias, pos, pos_dev, t_max, nrows, d,
                            hd, q_scale, split_t, ctx, kvn, work, arrivals);
  }
  return launch_verify<MAX_VERIFY>(grid, smem, s, qkv, ck, cv, bias, pos, pos_dev, t_max,
                                   nrows, d, hd, q_scale, split_t, ctx, kvn, work, arrivals);
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
