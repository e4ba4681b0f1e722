// Masked full (non-causal) attention of the DiT on the CUDA cores: the f32
// branch of K9 and K11 (bf16 runs the tensor-core tile of
// dit_attention_mma.cuh, as does the K8 block chain's attention stage).
//
// Replaces the attention of these TPU kernels:
//   K9  voice_tts_tpu/ops/attic/cfm_attention.py `cfm_attention` (keys at
//       col >= lens[b] masked to -1e30),
//   K11 jax.experimental.pallas.ops.tpu.flash_attention as the DiT calls it
//       (voice_tts_tpu/models/s2mel/dit.py:122-148; query i sees key j only
//       where their segment ids are equal, others get -0.7 * FLT_MAX added).
//
// The K9 TPU kernel holds one (T, T) f32 score tile in VMEM; at T = 3104 that
// is 38 MB, far past the 227 KB of shared memory a block may use.  This
// kernel is flash-style instead: one block per (batch, head, 32 query rows)
// walks 64-key tiles of K and V through shared memory with an f32 running
// max and sum per row, so no score leaves the SM.  Scores come from the
// f32-widened q and k (bf16 products are exact in f32), softmax is f32, and
// the unnormalized probabilities are rounded to the input type before the PV
// product (as the jax flash kernel does; K9 rounds the normalized ones, a
// difference of one bf16 rounding per probability), which accumulates in
// f32.  A row whose keys so far are all masked keeps the finite mask value
// as its max; the `m = -inf` guard only covers keys past the sequence end.
//
// Bound: at the DiT's shapes (B 2, H 8, T 704-3104, hd 64) it is operations
// (4 T^2 hd per (batch, head)), against about 1 MB to 10 MB of q, k, v and
// output.  This first version computes on the CUDA cores in f32 FMAs (q and
// the K tile read as float4 from shared memory, each lane owning two keys of
// a tile for QK^T and two head dims for PV); tensor-core tiles (mma.sync or
// wgmma) are later work.
#pragma once

#include "common.cuh"

namespace vtt {
namespace {

constexpr int ATT_HD = 64;        // head width (the DiT's 512 / 8)
constexpr int ATT_BQ = 32;        // query rows a block (8 a warp)
constexpr int ATT_BK = 64;        // keys a shared-memory tile
constexpr int ATT_KPAD = 68;      // K-tile row stride in floats: float4 loads without bank conflicts
constexpr int ATT_THREADS = 128;
constexpr int ATT_SMEM_BYTES =
    (ATT_BQ * ATT_HD + ATT_BK * ATT_KPAD + ATT_BK * ATT_HD + 4 * 8 * ATT_BK) * 4;
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

template <typename T, int MASK>
__global__ void __launch_bounds__(ATT_THREADS) dit_attention_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) float att_smem[];
  float* qs = att_smem;                       // [BQ][HD]
  float* ks = qs + ATT_BQ * ATT_HD;           // [BK][KPAD]
  float* vs = ks + ATT_BK * ATT_KPAD;         // [BK][HD]
  float* ps = vs + ATT_BK * ATT_HD;           // [4 warps][8 rows][BK]

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * ATT_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_len = a.t_len;
  const T* qg = static_cast<const T*>(a.q) + (long)b * a.q_sb + (long)h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + (long)b * a.k_sb + (long)h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + (long)b * a.v_sb + (long)h * a.v_sh;
  T* og = static_cast<T*>(a.o) + (long)b * a.o_sb + (long)h * a.o_sh;

  for (int i = tid; i < ATT_BQ * ATT_HD; i += ATT_THREADS) {
    const int t = q0 + i / ATT_HD;
    qs[i] = t < t_len ? to_f32(qg[(long)t * a.q_st + i % ATT_HD]) : 0.0f;
  }
  const int n_valid = MASK == MASK_LENS ? a.lens[b] : 0;
  int my_seg[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + warp * 8 + r;
    my_seg[r] = (MASK == MASK_SEG && t < t_len) ? a.q_seg[(long)b * t_len + t] : 0;
  }

  float m[8], l[8], o[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
    o[r][0] = o[r][1] = 0.0f;
  }
  const float* qw = qs + warp * 8 * ATT_HD;
  float* pw = ps + warp * 8 * ATT_BK;

  for (int k0 = 0; k0 < t_len; k0 += ATT_BK) {
    __syncthreads();   // the previous tile is consumed (and the q tile written)
    for (int i = tid; i < ATT_BK * ATT_HD; i += ATT_THREADS) {
      const int j = i / ATT_HD, d = i % ATT_HD, t = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (t < t_len) {
        kv = to_f32(kg[(long)t * a.k_st + d]);
        vv = to_f32(vg[(long)t * a.v_st + d]);
      }
      ks[j * ATT_KPAD + d] = kv;
      vs[j * ATT_HD + d] = vv;
    }
    __syncthreads();

    // scores of this warp's 8 rows against keys lane and lane + 32
    float s[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < ATT_HD; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ks + lane * ATT_KPAD + d);
      const float4 kb = *reinterpret_cast<const float4*>(ks + (lane + 32) * ATT_KPAD + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * ATT_HD + d);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = k0 + lane + 32 * c;
      const int kv_seg = (MASK == MASK_SEG && j < t_len) ? a.kv_seg[(long)b * t_len + j] : 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float v = s[r][c] * a.scale;
        if (j >= t_len) {
          v = -INFINITY;                   // past the sequence: no weight at all
        } else if (MASK == MASK_LENS) {
          if (j >= n_valid) v = LENS_MASK_VALUE;
        } else {
          v += my_seg[r] == kv_seg ? 0.0f : SEG_MASK_VALUE;
        }
        s[r][c] = v;
      }
    }

    // online softmax: f32 running max and sum, the same in every lane
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float mn = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float mu = mn == -INFINITY ? 0.0f : mn;
      const float alpha = expf(m[r] - mu);
      float p0 = expf(s[r][0] - mu), p1 = expf(s[r][1] - mu);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = mn;
      o[r][0] *= alpha;
      o[r][1] *= alpha;
      p0 = to_f32(from_f32<T>(p0));       // p in the type of v before PV
      p1 = to_f32(from_f32<T>(p1));
      pw[r * ATT_BK + lane] = p0;
      pw[r * ATT_BK + lane + 32] = p1;
    }
    __syncwarp();
    // PV: lane owns head dims lane and lane + 32
#pragma unroll 4
    for (int j = 0; j < ATT_BK; ++j) {
      const float v0 = vs[j * ATT_HD + lane], v1 = vs[j * ATT_HD + lane + 32];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = pw[r * ATT_BK + j];
        o[r][0] = fmaf(p, v0, o[r][0]);
        o[r][1] = fmaf(p, v1, o[r][1]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + warp * 8 + r;
    if (t < t_len) {
      const float inv = 1.0f / l[r];
      og[(long)t * a.o_st + lane] = from_f32<T>(o[r][0] * inv);
      og[(long)t * a.o_st + lane + 32] = from_f32<T>(o[r][1] * inv);
    }
  }
}

// Launch on `stream`; returns cudaGetLastError().  The dynamic shared memory
// (49 KB) is above the 48 KB default, so the kernel's limit is raised.
template <typename T, int MASK>
cudaError_t launch_dit_attention(const AttnArgs& a, int batch, cudaStream_t stream) {
  const cudaError_t e = vtt::allow_dynamic_smem((const void*)dit_attention_kernel<T, MASK>,
                                                ATT_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.t_len + ATT_BQ - 1) / ATT_BQ, batch * a.heads);
  dit_attention_kernel<T, MASK><<<grid, ATT_THREADS, ATT_SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vtt
