// K8: the whole DiT block trunk of one velocity evaluation, one C call.
//
// Replaces voice_tts_tpu/ops/attic/dit_blocks.py `dit_block_chain` (all 13
// blocks in one pallas_call over a sequential (depth, 5) grid, the residual
// resident in VMEM).  On Hopper blocks run in no order on 132 SMs and the
// residual (B*T*D f32, 2.9 MB at B 2, T 704, D 512) does not fit one SM, so
// `vtt_dit_block_chain` loops over the layers on the given stream and
// launches, per layer:
//   1. adaRMS of the residual -> bf16 (`ada_rms_kernel`);
//   2. the QKV GEMM with RoPE in its epilogue -> bf16 q | k | v;
//   3. attention on the tensor cores: K9's bf16 flash tile
//      (dit_attention_mma.cuh) on the q | k | v planes of `qkv`;
//   4. the Wo GEMM adding into the residual;
//   5. adaRMS -> bf16, then the W1 | W3 GEMM with SiLU(gate) * up in its
//      epilogue -> bf16;
//   6. the W2 GEMM adding into the residual, its three 512-row contraction
//      tiles added one after another as the TPU kernel's SwiGLU partials.
// The residual stays in global memory (in the 50 MB L2 at these sizes); one
// ctypes call replaces the ~260 torch ops of an eager trunk evaluation.
//
// Numerics are the TPU kernel's: f32 residual, adaRMS as x_hat * w' + b'
// (RMSNorm scale folded into w', eps 1e-5), every product's left operand
// rounded to bf16 and accumulated in f32, q, k, v, the attention context and
// the FFN input stored in bf16, the unnormalised probabilities rounded to
// bf16 before P.V.  RoPE rotates each interleaved (even, odd) pair in f32
// with f32 cos / sin; the TPU kernel's `(q @ P) * sin` lane-swap matmul (a
// Mosaic workaround) saw bf16-rounded q and bf16 tables.
//
// Bound: operations.  Per layer 2 * B*T * D * 13 D multiply-adds in the
// GEMMs (about 125 GFLOP a trunk at B 2, T 704) and 4 * B*T * lens * D in
// the attention (24 GFLOP) against 17 MB of bf16 weights: 0.15 ms at the
// dense bf16 peak.  Design, for that:
// - the GEMMs run on warpgroup `wgmma.mma_async` m64nNk16 (bf16, f32
//   accumulators in registers), A and the weight tile read from shared
//   memory, both 128-byte swizzled.  A ring of 4-6 stages of 64-deep K
//   slices is fed by TMA (`cp.async.bulk.tensor.2d`, one thread issues a
//   stage's two tiles, an `mbarrier` counts the bytes in); the descriptors
//   come from `cuTensorMapEncodeTiled` through `cudaGetDriverEntryPoint`,
//   so the build links nothing new.  One wgmma group stays in flight while
//   the next stage is awaited.  Rows past M are zero-filled by TMA and
//   never stored.  No warp specialisation and no persistent blocks: K is
//   512 or 1536, 8-24 slices a block;
// - the tile is planned per GEMM (`plan_gemm`, mirrored by
//   `plan_dit_gemm` in ops/dit_blocks.py): 128 x 128 (two consumer
//   warpgroups, 4 stages) where that gives at least 132 blocks, else
//   64 x 64 (one warpgroup, 6 stages): at B 2, T 704 QKV 132 blocks,
//   W1 | W3 264, Wo and W2 176;
// - every launch of the chain but the first runs under programmatic
//   dependent launch: a GEMM block issues its first weight stages before
//   `griddepcontrol.wait` (weights are read-only for the call), then its
//   activation tiles; each kernel lets the next one launch once all its
//   blocks run, so launch latency and the ring's fill overlap the previous
//   kernel's tail (the deeper the ring, the more weight slices are in
//   before the wait: 4 / 6 stages measured faster than 3 / 4);
// - the epilogues' branches are uniform over a tile, so RoPE's table loads
//   issue together (inside a per-element branch they serialised);
// - adaRMS is a launch of its own (one warp a row, 16-byte loads).  Folded
//   into the QKV and W1 | W3 blocks (each computing its rows' adaRMS into
//   an A buffer holding all of K) it saved two launches a layer but had
//   every block re-read its residual rows once per N tile (12-24 times)
//   from L2: the trunk ran slower on an H100, so the fold was dropped;
// The epilogues are kept exactly: RoPE on the f32 accumulators of the q | k
// columns, SiLU(gate) * up on the interleaved (w1, w3) column pairs, the
// residual added in f32, W2's three contraction tiles into it in order.
#include <cuda.h>

#include "dit_attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int G_BK = 64;            // K slice: one 128-byte swizzle row of bf16
constexpr int G_MIN_BLOCKS = 132;   // the H100's SMs: a GEMM fills them or goes small

enum { EPI_QKV_ROPE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

struct EpiArgs {
  bf16* out;            // QKV_ROPE: (M, N) bf16; SWIGLU: (M, N / 2) bf16
  float* resid;         // RESIDUAL: (M, N) f32, updated in place
  const float* cos;     // QKV_ROPE: (T, 64) f32, expanded per pair
  const float* sin;
  int t_len;            // QKV_ROPE: rows are (batch, time), time = row % t_len
  int rope_cols;        // QKV_ROPE: columns [0, rope_cols) are rotated (q | k)
  int ksplit;           // RESIDUAL: partial sums of this many K rows are added in order
};

// The GEMM tile of an (M, N, K) product: 128 x 128 where that launches at
// least G_MIN_BLOCKS blocks, else 64 x 64.  ops/dit_blocks.py
// `plan_dit_gemm` is the same rule.
struct TilePlan {
  int bm, bn;
};
TilePlan plan_gemm(int m, int n) {
  if (n % 128 == 0 && ((m + 127) / 128) * (n / 128) >= G_MIN_BLOCKS) return {128, 128};
  return {64, 64};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (64 x rows) box at (c0 along K, c1 along rows) of `map` into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major bf16 tile with 128-byte rows,
// 128-byte swizzled (the TMA layout): start address, stride between 8-row
// groups 1024 bytes, layout type 1 (128B swizzle).  Stepping 16 K values
// adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (the warpgroup's 64 x 64 f32 accumulator fragment) += A (64 x 16) B^T,
// A and B (64 x 16) bf16 K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (the warpgroup's 64 x 128 f32 accumulator fragment) += A (64 x 16) B^T,
// A and B (128 x 16) bf16 K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n64(d, da, db);
  }
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int WG, int BN, int STAGES>
struct GemmShape {
  static constexpr int BM = 64 * WG;
  static constexpr int A_BYTES = BM * G_BK * 2;      // one K slice of A
  static constexpr int W_BYTES = BN * G_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  // the ring, 1024-byte aligned (the swizzle's period), then the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 8 * STAGES;
};

// C[M, N] = A[M, K] W[N, K]^T with the epilogue EPI.  A: bf16 (M, K) rows
// through `map_a` (box 64 x BM); W: bf16 (L * N, K) rows through `map_w`
// (box 64 x BN), this layer's rows from w_row0.  N % BN == 0, K % 64 == 0.
// One wgmma group stays in flight while the next stage is awaited; a
// stage is refilled once the group that read it has completed.
template <int EPI, int WG, int BN, int STAGES>
__global__ void __launch_bounds__(128 * WG)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, int w_row0, int M, int N,
                      int K, const EpiArgs ep) {
  using S = GemmShape<WG, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nk = K / G_BK;
  unsigned char* a_ring = base;
  unsigned char* w_ring = base + STAGES * S::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_ring + STAGES * S::W_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * S::BM;
  const int pre = min(STAGES, nk);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first weight stages: read-only for the call, so before the wait
    for (int s = 0; s < pre; ++s) {
      mbar_expect_tx(&full[s], S::STAGE_BYTES);
      tma_load(w_ring + s * S::W_BYTES, &map_w, s * G_BK, w_row0 + n0, &full[s]);
    }
  }
  vtt::grid_dependency_wait();
  vtt::launch_dependents();
  if (tid == 0) {
    for (int s = 0; s < pre; ++s)
      tma_load(a_ring + s * S::A_BYTES, &map_a, s * G_BK, m0, &full[s]);
  }
  __syncthreads();   // the barriers' initialisation, before any thread waits

  // accumulator element 4 j + 2 hh + e: row 16 warp + g + 8 hh of the
  // warpgroup's 64, column 8 j + 2 tq + e
  const int row_base = m0 + wg * 64 + warp * 16 + g;
  float acc[BN / 2];
  float res[EPI == EPI_RESIDUAL ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  if constexpr (EPI == EPI_RESIDUAL) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row_base + 8 * hh, col = n0 + 8 * j + 2 * tq;
        float2 r = make_float2(0.0f, 0.0f);
        if (row < M) r = *reinterpret_cast<const float2*>(ep.resid + (size_t)row * N + col);
        res[4 * j + 2 * hh] = r.x;
        res[4 * j + 2 * hh + 1] = r.y;
      }
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a_tile = a_ring + s * S::A_BYTES + wg * 64 * G_BK * 2;
    const unsigned char* w_tile = w_ring + s * S::W_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk)
      wgmma_tile<BN>(acc, smem_desc(a_tile + kk * 32), smem_desc(w_tile + kk * 32));
    wgmma_commit();
    if (EPI == EPI_RESIDUAL && ((kt + 1) * G_BK) % ep.ksplit == 0) {
      wgmma_wait<0>();   // a contraction tile's partial, into the residual in order
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        res[i] += acc[i];
        acc[i] = 0.0f;
      }
    } else {
      wgmma_wait<1>();   // the group of kt - 1 is done; kt's stays in flight
      fence_regs(acc);
    }
    if (kt >= 1) {
      __syncthreads();   // every warpgroup is done with stage (kt - 1) % STAGES
      const int refill = kt - 1 + STAGES;
      if (tid == 0 && refill < nk) {
        const int rs = (kt - 1) % STAGES;
        mbar_expect_tx(&full[rs], S::STAGE_BYTES);
        tma_load(a_ring + rs * S::A_BYTES, &map_a, refill * G_BK, m0, &full[rs]);
        tma_load(w_ring + rs * S::W_BYTES, &map_w, refill * G_BK, w_row0 + n0, &full[rs]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // a tile is all q | k columns or all v (rope_cols is a multiple of BN), so
  // the RoPE branch is uniform and a row's table entries load together
  const bool rotate = EPI == EPI_QKV_ROPE && n0 < ep.rope_cols;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_base + 8 * hh;
    float c[BN / 8], sn[BN / 8];
    if (rotate) {
      const int tab = (min(row, M - 1) % ep.t_len) * vtt::ATT_HD;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int idx = tab + (8 * j + 2 * tq) % vtt::ATT_HD;   // n0 % 64 == 0
        c[j] = ep.cos[idx];
        sn[j] = ep.sin[idx];
      }
    }
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      const float x0 = acc[4 * j + 2 * hh], x1 = acc[4 * j + 2 * hh + 1];
      if constexpr (EPI == EPI_QKV_ROPE) {
        if (rotate) {
          store_bf16x2(ep.out + (size_t)row * N + col, x0 * c[j] - x1 * sn[j],
                       x1 * c[j] + x0 * sn[j]);
        } else {
          store_bf16x2(ep.out + (size_t)row * N + col, x0, x1);
        }
      } else if constexpr (EPI == EPI_RESIDUAL) {
        *reinterpret_cast<float2*>(ep.resid + (size_t)row * N + col) =
            make_float2(res[4 * j + 2 * hh], res[4 * j + 2 * hh + 1]);
      } else {   // SWIGLU: (gate, up) of FFN column col / 2
        const float silu = x0 / (1.0f + expf(-x0));
        ep.out[(size_t)row * (N / 2) + col / 2] = __float2bfloat16_rn(silu * x1);
      }
    }
  }
}

// adaRMS of the residual, one warp a row: y = bf16(x * rsqrt(mean(x^2) +
// eps) * w + b) with w, b the step's folded (D,) halves; 16-byte loads.
// D % 4 == 0.
__global__ void __launch_bounds__(128)
    ada_rms_kernel(const float* __restrict__ x, const float* __restrict__ wb,
                   bf16* __restrict__ y, int M, int D) {
  vtt::grid_dependency_wait();
  vtt::launch_dependents();
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float ss = 0.0f;
  for (int j = 4 * lane; j < D; j += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + j);
    ss = fmaf(v.x, v.x, ss);
    ss = fmaf(v.y, v.y, ss);
    ss = fmaf(v.z, v.z, ss);
    ss = fmaf(v.w, v.w, ss);
  }
  ss = vtt::warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + 1e-5f);
  for (int j = 4 * lane; j < D; j += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + j);
    const float4 w = *reinterpret_cast<const float4*>(wb + j);
    const float4 c = *reinterpret_cast<const float4*>(wb + D + j);
    bf16* out = y + (size_t)row * D + j;
    store_bf16x2(out, (v.x * r) * w.x + c.x, (v.y * r) * w.y + c.y);
    store_bf16x2(out + 2, (v.z * r) * w.z + c.z, (v.w * r) * w.w + c.w);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) looked up through the
// runtime, so the library links nothing new.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A TMA map of a row-major bf16 (rows, cols) matrix read in boxes of 64
// columns x box_rows rows, 128-byte swizzled; rows past the end read as 0.
cudaError_t make_map(CUtensorMap* map, const bf16* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)G_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One GEMM of the chain: A (M, K) times the (N, K) rows of `w` from
// `w_row0`; `w_rows` the rows of the whole (L * N, K) weight stack.
struct Gemm {
  CUtensorMap map_a, map_w;
  TilePlan tile;
  int M, N, K;
};

cudaError_t prepare(Gemm& gm, const bf16* a, const bf16* w, int w_rows, int M, int N, int K) {
  gm.tile = plan_gemm(M, N);
  gm.M = M;
  gm.N = N;
  gm.K = K;
  cudaError_t e = make_map(&gm.map_a, a, M, K, gm.tile.bm);
  if (e == cudaSuccess) e = make_map(&gm.map_w, w, w_rows, K, gm.tile.bn);
  return e;
}

template <int EPI, int WG, int BN, int STAGES>
cudaError_t launch_tile(const Gemm& gm, int w_row0, const EpiArgs& ep, bool pdl,
                        cudaStream_t stream) {
  using S = GemmShape<WG, BN, STAGES>;
  auto kernel = gemm_wgmma_kernel<EPI, WG, BN, STAGES>;
  const int smem = S::SMEM;
  cudaError_t e = vtt::allow_dynamic_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(gm.N / BN, (gm.M + S::BM - 1) / S::BM);
  if (pdl)
    return vtt::launch_pdl(kernel, grid, dim3(128 * WG), smem, stream, gm.map_a, gm.map_w,
                           w_row0, gm.M, gm.N, gm.K, ep);
  kernel<<<grid, 128 * WG, smem, stream>>>(gm.map_a, gm.map_w, w_row0, gm.M, gm.N, gm.K, ep);
  return cudaGetLastError();
}

// adaRMS of the (M, D) residual x into y with one step's halves wb.
cudaError_t ada_rms(const float* x, const float* wb, bf16* y, int M, int D,
                    cudaStream_t stream, bool pdl) {
  const dim3 grid((M + 3) / 4);
  if (pdl) return vtt::launch_pdl(ada_rms_kernel, grid, dim3(128), 0, stream, x, wb, y, M, D);
  ada_rms_kernel<<<grid, 128, 0, stream>>>(x, wb, y, M, D);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm(const Gemm& gm, int w_row0, const EpiArgs& ep, cudaStream_t stream,
                 bool pdl) {
  if (gm.tile.bm == 128) return launch_tile<EPI, 2, 128, 4>(gm, w_row0, ep, pdl, stream);
  return launch_tile<EPI, 1, 64, 6>(gm, w_row0, ep, pdl, stream);
}

}  // namespace

#define VTT_TRY(expr)                          \
  do {                                         \
    const cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// The tile `plan_gemm` gives an (m, n, k) GEMM of the chain: *bm x *bn.
VTT_EXPORT int vtt_dit_gemm_plan(int m, int n, int k, int* bm, int* bn) {
  if (m < 1 || n % 64 || k % G_BK) return (int)cudaErrorInvalidValue;
  const TilePlan t = plan_gemm(m, n);
  *bm = t.bm;
  *bn = t.bn;
  return (int)cudaSuccess;
}

// x: (B*T, D) f32 trunk input; out: (B*T, D) f32, the residual and result;
// wqkv: (L, 3D, D), wo: (L, D, D), w13: (L, 6D, D) with rows (w1[i], w3[i])
// interleaved, w2: (L, D, 3D), all bf16 (out, in); wb: (L, 2, 2D) f32 one
// step's folded adaRMS halves; cos, sin: (T, 64) f32; lens: (B,) int32 valid
// keys; y: (B*T, D), qkv: (B*T, 3D), ctx: (B*T, D), act: (B*T, 3D) bf16
// scratch.  D % 64 == 0, head width 64; every pointer 16-byte aligned.
// pdl: 0 launches every kernel in full stream order, so a profiler's kernel
// spans do not overlap (a measurement arm); 1 is the chain's launch.
VTT_EXPORT int vtt_dit_block_chain(const float* x, float* out, const bf16* wqkv,
                                   const bf16* wo, const bf16* w13, const bf16* w2,
                                   const float* wb, const float* cos, const float* sin,
                                   const int* lens, bf16* y, bf16* qkv, bf16* ctx,
                                   bf16* act, int batch, int t_len, int dim, int heads,
                                   int layers, int pdl, void* stream_) {
  const bool use_pdl = pdl != 0;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int M = batch * t_len, D = dim;
  if (D % 64 || D / heads != vtt::ATT_HD) return (int)cudaErrorInvalidValue;
  if (out != x)
    VTT_TRY(cudaMemcpyAsync(out, x, sizeof(float) * M * D, cudaMemcpyDeviceToDevice, stream));

  Gemm g_qkv, g_wo, g_w13, g_w2;
  VTT_TRY(prepare(g_qkv, y, wqkv, layers * 3 * D, M, 3 * D, D));
  VTT_TRY(prepare(g_wo, ctx, wo, layers * D, M, D, D));
  VTT_TRY(prepare(g_w13, y, w13, layers * 6 * D, M, 6 * D, D));
  VTT_TRY(prepare(g_w2, act, w2, layers * D, M, D, 3 * D));

  EpiArgs rope{};
  rope.out = qkv;
  rope.cos = cos;
  rope.sin = sin;
  rope.t_len = t_len;
  rope.rope_cols = 2 * D;
  EpiArgs resid{};
  resid.resid = out;
  resid.ksplit = D;
  EpiArgs swiglu{};
  swiglu.out = act;

  vtt::AttnArgs att{};
  att.q = qkv;
  att.k = qkv + D;
  att.v = qkv + 2 * D;
  att.o = ctx;
  att.q_sb = att.k_sb = att.v_sb = t_len * 3 * D;
  att.q_sh = att.k_sh = att.v_sh = vtt::ATT_HD;
  att.q_st = att.k_st = att.v_st = 3 * D;
  att.o_sb = t_len * D;
  att.o_sh = vtt::ATT_HD;
  att.o_st = D;
  att.lens = lens;
  att.heads = heads;
  att.t_len = t_len;
  att.scale = 1.0f / sqrtf((float)vtt::ATT_HD);

  for (int l = 0; l < layers; ++l) {
    const float* wb_l = wb + (size_t)l * 4 * D;
    // the first launch follows the copy (or the caller's work) in full
    VTT_TRY(ada_rms(out, wb_l, y, M, D, stream, use_pdl && l > 0));
    VTT_TRY(gemm<EPI_QKV_ROPE>(g_qkv, l * 3 * D, rope, stream, use_pdl));
    VTT_TRY(vtt::launch_dit_attention_mma<vtt::MASK_LENS>(att, batch, stream, use_pdl));
    VTT_TRY(gemm<EPI_RESIDUAL>(g_wo, l * D, resid, stream, use_pdl));
    VTT_TRY(ada_rms(out, wb_l + 2 * D, y, M, D, stream, use_pdl));
    VTT_TRY(gemm<EPI_SWIGLU>(g_w13, l * 6 * D, swiglu, stream, use_pdl));
    VTT_TRY(gemm<EPI_RESIDUAL>(g_w2, l * D, resid, stream, use_pdl));
  }
  return (int)cudaSuccess;
}
