// bf16 masked full (non-causal) attention of the DiT on the tensor cores:
// the bf16 branch of K9 and K11.
//
// Replaces, for bf16 inputs, the attention of two TPU kernels:
//   K9  voice_tts_tpu/ops/attic/cfm_attention.py:64 `cfm_attention` (keys at
//       col >= lens[b] masked to -1e30),
//   K11 jax.experimental.pallas.ops.tpu.flash_attention as the DiT calls it
//       (voice_tts_tpu/models/s2mel/dit.py:122-148; query i sees key j only
//       where their segment ids are equal, others get -0.7 * FLT_MAX added).
//
// Bound: bf16 tensor-core operations, 4 * T_attended * hd a (query row,
// head) for QK^T and PV, against 1-10 MB of q, k, v and output at the DiT's
// shapes (B 2, H 8, hd 64, T 704-3104).  At T 896 that is about 3 us of the
// card's 989 TFLOP/s, so latency, the softmax and the copies set the pace.
//
// Design (the hopper-kernels guide, sections 1 and 4, and the cp.async
// section of the CUDA guide):
// - one block of 4 warps per (64 query rows, batch * head); a warp owns 16
//   rows.  The Q tile (64 x 64 bf16, 8 KB) is copied to shared memory with
//   cp.async once and loaded with ldmatrix.x4 into A-operand fragments that
//   stay in registers for the whole key loop (4 k-steps of 16 dims);
// - K and V tiles of 64 keys x 64 dims (8 KB each) go through a 2-stage
//   cp.async ring, 16 bytes a thread, a head's row being 128 bytes; the
//   16-byte chunks of row r are XOR-swizzled by r & 7, so the 8 rows an
//   ldmatrix reads fall in 8 distinct bank groups.  Tile j + 1's copy
//   starts before tile j's math; one barrier a tile.  Rows past T are
//   zero-filled by the copy (src-size 0), so no stale NaN meets a zero P;
// - S = Q K^T with mma.sync.m16n8k16 bf16 -> f32 (8 n-tiles x 4 k-steps a
//   warp, B fragments by ldmatrix on K rows); scale, mask and the ragged
//   edge (keys past T get -inf) applied in registers;
// - online softmax in f32 registers: a row's 64 scores live in one quad of
//   4 lanes (two __shfl_xor_sync for the max; the sum stays a per-lane
//   partial until the epilogue).  exp2f((s - m) * log2e) is taken AFTER the
//   subtraction: prescaling by log2e would turn K11's -0.7 * FLT_MAX into
//   -inf and a row that matches no key into NaN.  A row whose keys are all
//   masked keeps the finite mask value as its max (the uniform average over
//   every key, as the plain versions give); `m = -inf` is guarded for keys
//   past T;
// - P V without shared memory: the m16n8k16 accumulator layout of S is the
//   A-operand layout of the next product, so the unnormalized probabilities
//   are rounded to packed bf16 pairs in registers (as the CUDA-core kernel
//   and jax's flash kernel round them) and fed to the PV mma, whose B
//   fragments come from ldmatrix.trans on V rows; O (16 x 64 f32 a warp)
//   stays in registers, rescaled by alpha each tile;
// - epilogue: O / l rounded to bf16, staged through the warp's own rows of
//   the Q tile and written in 16-byte stores, rows >= T skipped;
// - K9 stops its key loop at ceil(lens[b] / 64) tiles when lens[b] >= 1:
//   once a valid key has set a finite max, exp(-1e30 - m) is 0 in f32, as
//   in the plain version.  lens[b] <= 0 walks every tile (the uniform row).
//   K11 walks every tile: a row that matches no key must still average all
//   T keys.
// Left for later: wgmma, TMA, warp specialisation, persistent blocks.
//
// f32 inputs keep the CUDA-core kernel of dit_attention.cuh: TF32 tensor
// cores would round q and k to 10 mantissa bits and break the f32
// tolerance (1e-4 against the plain version).  The K8 block chain
// (dit_blocks.cu) runs this tile as its attention stage, under
// programmatic dependent launch.
//
// The wrapper (ops/cfm_attention.py `check_qkv`) guarantees what the
// 16-byte copies need: 16-byte-aligned bases and (batch, head, time)
// strides that are multiples of 8 elements.
#pragma once

#include "dit_attention.cuh"

namespace vtt {
namespace {

constexpr int MMA_BQ = 64;          // query rows a block (16 a warp)
constexpr int MMA_BK = 64;          // keys a tile
constexpr int MMA_THREADS = 128;
constexpr int MMA_TILE = MMA_BK * ATT_HD;   // bf16 elements of one 8 KB tile
constexpr float MMA_LOG2E = 1.4426950408889634f;

struct MmaSmem {
  __nv_bfloat16 q[MMA_TILE];        // the Q tile, later the output staging
  __nv_bfloat16 k[2][MMA_TILE];
  __nv_bfloat16 v[2][MMA_TILE];
  int kv_seg[2][MMA_BK];            // MASK_SEG: the tile's key segment ids
};

// Element offset of 16-byte chunk `c` (8 bf16) of row `r` in a swizzled
// 64 x 64 bf16 tile.
__device__ __forceinline__ int swz(int r, int c) { return r * ATT_HD + ((c ^ (r & 7)) << 3); }

// cp.async of 16 bytes, zero-filling the destination when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + 63 of a (T, 64) bf16 view with time stride `st` into
// a swizzled tile: 512 chunks of 16 bytes, 4 a thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long st, int row0, int t_len, int tid) {
#pragma unroll
  for (int i = 0; i < MMA_TILE / 8 / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx >> 3, c = idx & 7, t = row0 + r;
    const bool ok = t < t_len;
    cp_async16_zfill(dst + swz(r, c), src + (ok ? (long)t * st + c * 8 : 0), ok);
  }
}

// Key tile j of K and V (and of the key segment ids) into ring stage j & 1.
template <int MASK>
__device__ __forceinline__ void load_kv(MmaSmem& sm, const __nv_bfloat16* kg,
                                        const __nv_bfloat16* vg, const int* kv_seg, long k_st,
                                        long v_st, int j, int t_len, int tid) {
  const int st = j & 1, k0 = j * MMA_BK;
  load_tile(sm.k[st], kg, k_st, k0, t_len, tid);
  load_tile(sm.v[st], vg, v_st, k0, t_len, tid);
  if (MASK == MASK_SEG && tid < MMA_BK) {
    const bool ok = k0 + tid < t_len;
    cp_async4_zfill(&sm.kv_seg[st][tid], kv_seg + (ok ? k0 + tid : 0), ok);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed, `lo` in the low half-word.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int MASK>
__global__ void __launch_bounds__(MMA_THREADS) dit_attention_mma_kernel(const AttnArgs a) {
  __shared__ __align__(128) MmaSmem sm;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * MMA_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row and column pair
  const int t_len = a.t_len;
  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(a.q) + (long)b * a.q_sb + (long)h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + (long)b * a.k_sb + (long)h * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + (long)b * a.v_sb + (long)h * a.v_sh;
  bf16* og = static_cast<bf16*>(a.o) + (long)b * a.o_sb + (long)h * a.o_sh;
  const int* kv_seg = MASK == MASK_SEG ? a.kv_seg + (long)b * t_len : nullptr;
  // q, k, v are the previous launch's output under programmatic dependent
  // launch (K8's chain); no-ops for a plain launch (K9, K11)
  grid_dependency_wait();
  launch_dependents();

  int n_tiles = (t_len + MMA_BK - 1) / MMA_BK;
  const int n_valid = MASK == MASK_LENS ? a.lens[b] : 0;
  if (MASK == MASK_LENS && n_valid >= 1) n_tiles = min(n_tiles, (n_valid + MMA_BK - 1) / MMA_BK);

  load_tile(sm.q, qg, a.q_st, q0, t_len, tid);
  load_kv<MASK>(sm, kg, vg, kv_seg, a.k_st, a.v_st, 0, t_len, tid);
  cp_async_commit();

  // segment ids of this lane's two rows (g and g + 8 of the warp's 16)
  int my_seg[2] = {0, 0};
  if (MASK == MASK_SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + warp * 16 + g + 8 * r;
      my_seg[r] = t < t_len ? a.q_seg[(long)b * t_len + t] : 0;
    }
  }

  unsigned qf[4][4];          // A fragments of Q, one a k-step of 16 dims
  float o[8][4];              // O: 8 n-tiles of 8 dims, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();    // tile j landed; every warp is done with tile j - 1's buffers
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qf[kk], sm.q + swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
    }
    if (j + 1 < n_tiles) {
      load_kv<MASK>(sm, kg, vg, kv_seg, a.k_st, a.v_st, j + 1, t_len, tid);
      cp_async_commit();
    }
    const bf16* ks = sm.k[j & 1];
    const bf16* vs = sm.v[j & 1];

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4];   // keys np*16 + 0..7 and + 8..15, dims kk*16 + 0..7 and + 8..15
        ldsm_x4(kf, ks + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, mask, ragged edge; s[n][e] is row g + 8 * (e >> 1), key
    // j * 64 + n * 8 + 2 * tq + (e & 1)
    const int k0 = j * MMA_BK;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        float v = s[n][e] * a.scale;
        if (col >= t_len) {
          v = -INFINITY;                   // past the sequence: no weight at all
        } else if (MASK == MASK_LENS) {
          if (col >= n_valid) v = LENS_MASK_VALUE;
        } else {
          v += my_seg[e >> 1] == sm.kv_seg[j & 1][col - k0] ? 0.0f : SEG_MASK_VALUE;
        }
        s[n][e] = v;
      }
    }

    // online softmax, one quad of lanes a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float mu = mn == -INFINITY ? 0.0f : mn;
      const float alpha = exp2f((m[r] - mu) * MMA_LOG2E);
      m[r] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f((s[n][e] - mu) * MMA_LOG2E);
          sum += s[n][e];
        }
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
      l[r] = l[r] * alpha + sum;         // this lane's share; the quad sums at the end
    }

    // O += P V: P's accumulators repacked as A fragments, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned vf[4];   // keys kk*16 + 0..7 and + 8..15, dims dp*16 + 0..7 and + 8..15
        ldsm_x4_trans(vf, vs + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   dp * 2 + (lane >> 4)));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: O / l as bf16 through this warp's own 16 rows of the Q tile
  // (no other warp reads them), then 16-byte stores of whole rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / l[r];
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<unsigned*>(sm.q + swz(row, n) + 2 * tq) =
          pack_bf16x2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, r = warp * 16 + (idx >> 3), c = idx & 7;
    const int t = q0 + r;
    if (t < t_len)
      *reinterpret_cast<uint4*>(og + (long)t * a.o_st + c * 8) =
          *reinterpret_cast<const uint4*>(sm.q + swz(r, c));
  }
}

// Launch on `stream`, under programmatic dependent launch if `pdl`;
// returns the launch's error.  41.5 KB of static shared memory a block,
// under the 48 KB default.
template <int MASK>
cudaError_t launch_dit_attention_mma(const AttnArgs& a, int batch, cudaStream_t stream,
                                     bool pdl = false) {
  const dim3 grid((a.t_len + MMA_BQ - 1) / MMA_BQ, batch * a.heads);
  if (pdl) return launch_pdl(dit_attention_mma_kernel<MASK>, grid, dim3(MMA_THREADS), 0, stream, a);
  dit_attention_mma_kernel<MASK><<<grid, MMA_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vtt
