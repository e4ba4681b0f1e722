// K5: bounded-read decode attention, single-token queries over a time-minor
// KV cache that read only the live prefix.
//
// Replaces: voice_tts_tpu/ops/decode_attention.py `decode_attention` (the
// Pallas `_kernel`, pallas_call at :126).  Semantics (decode_attention.py:
// 27-92): s[t] = (q . k[:, t]) * scale + bias[t], in f32 from the widened q
// and k; s[t] = -inf for t >= length; an online softmax over key tiles; the
// f32 accumulator divided by l at the end; the output in q's dtype.
//
// Bound on the H100: device memory.  A call reads the K and V prefix once
// (2 * B * H * hd * length elements) for 4 operations an element, far below
// the ~295 operations a byte where the tensor cores would bind; at B 1 it
// moves under 2 MB, so launch latency sets its time.  Design (the simple
// version): one block per (row, head), 256 threads along t, so the
// time-minor cache reads coalesce for the scores (thread i reads k[d][t0+i]
// for every d); the tile's probabilities go to shared memory and each warp
// reduces P.V for its share of the head dims (lanes along t, a warp sum).
// Only tiles over [0, length) are read, and past `length` no value is
// loaded: walking the live prefix is the point of the kernel.  The TPU
// kernel's double-buffered DMA, run_scoped and scalar-prefetch grid are TPU
// machinery and are not carried over.  At B 1, H 20 the grid is 20 blocks
// for 132 SMs: splitting T across blocks is later work.
#include "common.cuh"

namespace {

constexpr int DA_THREADS = 256;
constexpr int DA_MAX_HD = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(DA_THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        T* __restrict__ out, int heads, int hd, int t_max,
                        int length, float scale) {
  __shared__ float qs[DA_MAX_HD];
  __shared__ float acc[DA_MAX_HD];
  __shared__ float ps[DA_THREADS];
  __shared__ float red[32];

  const int bh = blockIdx.x;                 // row * heads + head
  const int row = bh / heads;
  const T* kr = k + (size_t)bh * hd * t_max;
  const T* vr = v + (size_t)bh * hd * t_max;
  const float* br = bias + (size_t)row * t_max;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    qs[d] = to_f32(q[(size_t)bh * hd + d]);
    acc[d] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float m = -INFINITY, l = 0.0f;             // the same in every thread
  for (int t0 = 0; t0 < length; t0 += DA_THREADS) {
    const int t = t0 + threadIdx.x;
    float s = -INFINITY;
    if (t < length) {
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot += qs[d] * to_f32(kr[(size_t)d * t_max + t]);
      s = dot * scale + br[t];
    }
    const float m_new = fmaxf(m, vtt::block_max(s, red));
    const float alpha = expf(m - m_new);     // 0 on the first tile
    const float p = expf(s - m_new);         // 0 past `length`
    l = l * alpha + vtt::block_sum(p, red);
    ps[threadIdx.x] = p;
    __syncthreads();
    const int n = min(DA_THREADS, length - t0);
    for (int d = warp; d < hd; d += nwarps) {
      float pv = 0.0f;
      for (int i = lane; i < n; i += 32) pv += ps[i] * to_f32(vr[(size_t)d * t_max + t0 + i]);
      pv = vtt::warp_sum(pv);
      if (lane == 0) acc[d] = acc[d] * alpha + pv;
    }
    __syncthreads();
    m = m_new;
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    store(out + (size_t)bh * hd + d, acc[d] / l);
  }
}

}  // namespace

// q, out: (B, H, hd) contiguous; k, v: (B, H, hd, t_max) contiguous, all of
// one dtype, bf16 (is_bf16 = 1) or f32; bias: (B, t_max) f32 additive;
// 1 <= length <= t_max attendable positions; hd <= 128.
VTT_EXPORT int vtt_decode_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int is_bf16,
                                    int batch, int heads, int hd, int t_max,
                                    int length, float scale, void* stream) {
  if (hd < 1 || hd > DA_MAX_HD || length < 1 || length > t_max) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch * heads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    decode_attention_kernel<__nv_bfloat16><<<grid, DA_THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        bias, (__nv_bfloat16*)out, heads, hd, t_max, length, scale);
  } else {
    decode_attention_kernel<float><<<grid, DA_THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, bias, (float*)out,
        heads, hd, t_max, length, scale);
  }
  return (int)cudaGetLastError();
}
