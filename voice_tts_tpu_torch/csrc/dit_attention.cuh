// What the two DiT attention tiles share: the arguments, the masks, the
// cp.async copies, and the scale / mask / online-softmax step over one
// 64-key tile held in mma.sync accumulators.
//
// The tiles (each header holds its design and bound):
//   dit_attention_mma.cuh   bf16 on the tensor cores (m16n8k16 bf16), the
//                           bf16 branch of K9 and K11 and K8's attention stage;
//   dit_attention_tf32.cuh  f32 on the tensor cores as three split-TF32 passes
//                           (m16n8k8 tf32), the f32 branch of K9 and K11.
// Both replace the attention of these TPU kernels:
//   K9  voice_tts_tpu/ops/attic/cfm_attention.py:64 `cfm_attention` (keys at
//       col >= lens[b] masked to -1e30),
//   K11 jax.experimental.pallas.ops.tpu.flash_attention as the DiT calls it
//       (voice_tts_tpu/models/s2mel/dit.py:122-148; query i sees key j only
//       where their segment ids are equal, others get -0.7 * FLT_MAX added).
// The K9 TPU kernel holds one (T, T) f32 score tile in VMEM; at T = 3104 that
// is 38 MB, far past the 227 KB of shared memory a block may use, so both
// tiles are flash-style: one block per (64 query rows, batch * head) walks
// 64-key tiles of K and V with an f32 running max and sum per row.
#pragma once

#include "common.cuh"

namespace vtt {
namespace {

constexpr int ATT_HD = 64;        // head width (the DiT's 512 / 8)
constexpr int ATT_BK = 64;        // keys a tile
constexpr float ATT_LOG2E = 1.4426950408889634f;
// jax flash_attention's DEFAULT_MASK_VALUE, -0.7 * float32 max
constexpr float SEG_MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LENS_MASK_VALUE = -1e30f;

enum { MASK_LENS = 0, MASK_SEG = 1 };

// Element strides of q, k, v and the output over (batch, head, time); the
// head dim is contiguous.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int q_sb, q_sh, q_st;
  int k_sb, k_sh, k_st;
  int v_sb, v_sh, v_st;
  int o_sb, o_sh, o_st;
  const int* lens;     // (B,) valid keys, MASK_LENS
  const int* q_seg;    // (B, T) segment ids of the queries, MASK_SEG
  const int* kv_seg;   // (B, T) segment ids of the keys, MASK_SEG
  int heads;
  int t_len;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// Number of 64-key tiles a block walks: every tile of T, except that K9
// stops at ceil(lens[b] / 64) when lens[b] >= 1 (once a valid key has set a
// finite max, exp(-1e30 - m) is 0 in f32, as in the plain version; lens[b]
// <= 0 walks every tile for the uniform row).  K11 walks every tile: a row
// that matches no key must still average all T keys.
// n_valid: K9's lens[b].
template <int MASK>
__device__ __forceinline__ int key_tiles(int t_len, int n_valid) {
  const int n_tiles = (t_len + ATT_BK - 1) / ATT_BK;
  if (MASK == MASK_LENS && n_valid >= 1) return min(n_tiles, (n_valid + ATT_BK - 1) / ATT_BK);
  return n_tiles;
}

// Segment ids of a lane's two rows (fragment rows g and g + 8 of its warp's
// 16, from query row `row0`); 0 for K9.
template <int MASK>
__device__ __forceinline__ void query_segments(int (&my_seg)[2], const AttnArgs& a, int b,
                                               int row0) {
  my_seg[0] = my_seg[1] = 0;
  if (MASK == MASK_SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      my_seg[r] = t < a.t_len ? a.q_seg[(long)b * a.t_len + t] : 0;
    }
  }
}

// One 64-key tile of scores s (8 n-tiles of m16n8 accumulators: s[n][e] is
// row g + 8 * (e >> 1), key k0 + n * 8 + 2 * tq + (e & 1)) scaled, masked
// and turned into unnormalized probabilities, with the running max m, the
// lane's share of the running sum l (the quad sums it at the end) and the
// accumulators o (the same row layout) rescaled.  n_valid: K9's lens[b];
// tile_seg: K11's key segment ids of the tile.
//
// Keys past T get -inf (no weight at all).  exp2f((s - m) * log2e) is taken
// AFTER the subtraction: prescaling by log2e would turn K11's -0.7 * FLT_MAX
// into -inf and a row that matches no key into NaN.  A row whose keys are
// all masked keeps the finite mask value as its max (the uniform average
// over every key, as the plain versions give); `m = -inf` is guarded for
// keys past T.  A row's 64 scores live in one quad of 4 lanes.
template <int MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&o)[8][4], float (&m)[2],
                                             float (&l)[2], const AttnArgs& a, int n_valid,
                                             int k0, const int (&my_seg)[2],
                                             const int* tile_seg, int tq) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + n * 8 + 2 * tq + (e & 1);
      float v = s[n][e] * a.scale;
      if (col >= a.t_len) {
        v = -INFINITY;                   // past the sequence: no weight at all
      } else if (MASK == MASK_LENS) {
        if (col >= n_valid) v = LENS_MASK_VALUE;
      } else {
        v += my_seg[e >> 1] == tile_seg[col - k0] ? 0.0f : SEG_MASK_VALUE;
      }
      s[n][e] = v;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[r], mx);
    const float mu = mn == -INFINITY ? 0.0f : mn;
    const float alpha = exp2f((m[r] - mu) * ATT_LOG2E);
    m[r] = mn;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[n][e] = exp2f((s[n][e] - mu) * ATT_LOG2E);
        sum += s[n][e];
      }
      o[n][2 * r] *= alpha;
      o[n][2 * r + 1] *= alpha;
    }
    l[r] = l[r] * alpha + sum;         // this lane's share; the quad sums at the end
  }
}

// The quad's sum of a row's l, and its reciprocal.
__device__ __forceinline__ float inv_row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return 1.0f / l;
}

}  // namespace
}  // namespace vtt
