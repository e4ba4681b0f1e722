// K1: batch-1 GPT-2 decode step of the int8 trunk, with the folded readout.
//
// Replaces: voice_tts_tpu/ops/fused_decode.py `fused_decode_step` (Pallas
// `_kernel_merged` + `_attend`), float-KV / int8-weight / readout branch.
//
// The Pallas kernel runs the whole trunk in one call because TPU grid steps
// run in order on one core and a residual can live in VMEM scratch across
// them.  A GPU grid gives no such order, so the step is a host-sequenced
// chain of launches, five per layer plus one for the readout:
//
//   dq_gemv  [LN1 prologue]          x   -> qkv (3D)
//   attend   [one block per head]    qkv -> ctx (D), kv_new rows (bf16)
//   dq_gemv  [residual epilogue]     ctx -> x += proj(ctx)
//   dq_gemv  [LN2 prologue, GELU]    x   -> h (4D)
//   dq_gemv  [residual epilogue]     h   -> x += fc2(h)   (K = 4D, 4 k-tiles)
//   dq_gemv  [final-LN prologue]     x   -> logits (12 * VT)
//
// Numerics reproduced from the Pallas kernel: the activation is rounded to
// bf16 before every product, f32 accumulation, then `* scale + bias`; the fc2
// bias is added once; q is scaled by hd^-0.5 in f32; cache rows are read as
// bf16 and widened; the current token's k/v enter attention unrounded while
// the kv_new rows are stored as bf16; the final LN runs in f32.
//
// Weight layout (see voice_tts_tpu_torch/ops/fused_decode.py `pack_gpt`):
// every (D, D) int8 tile of the JAX pack is stored transposed, (out, in), so
// one output column's weights are contiguous and a warp streams them with
// 16-byte loads.  A (F, K) matrix is `n_ktiles` such blocks, [kt][F][K/kt].
//
// Bound on the H100: device memory.  A step reads the whole int8 trunk once
// (12 D^2 bytes per layer, 472 MB at D = 1280, L = 24) plus the int8 readout
// and the live bf16 KV prefix; each weight byte feeds one multiply-add.  The
// GEMV gives one warp per output column (8 per block, hundreds of blocks per
// launch); a warp reads its column's weights as 4 bytes a lane, neighbouring
// lanes on neighbouring addresses (128-byte coalesced loads, four in flight),
// and the activation as float4 from shared memory, conflict-free.  The LN
// prologue is recomputed by each block from the D-float input, which costs D
// reads against F*K weight bytes.  Attention reads only the live [0, pos)
// prefix, one block per head: each cache row is read by hd/8 lanes as 16-byte
// loads (a warp covers 32*8/hd rows at once), scores of a chunk of positions
// go to shared memory for an online softmax, and the weighted sum of V is kept
// in registers across chunks and reduced across warps once at the end.
#include "common.cuh"

namespace {

constexpr int GEMV_WARPS = 8;
constexpr int ATT_WARPS = 8;
constexpr int ATT_CHUNK = 256;

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// out[f] = epi(sum_k bf16(ln(x))[k] * W[f, k] * scale[f] + bias[f])
// x, out, res: f32; W: [n_ktiles][F][ktile] int8; ln_w == nullptr -> no LN.
template <int EPI>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
dq_gemv_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, const int8_t* __restrict__ w,
               int n_ktiles, int ktile, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* res, float* out,
               int f_total) {
  extern __shared__ float4 xs4[];  // K = n_ktiles * ktile floats
  float* xs = reinterpret_cast<float*>(xs4);
  __shared__ float scratch[32];
  const int k_total = n_ktiles * ktile;

  for (int i = threadIdx.x; i < k_total; i += blockDim.x) xs[i] = x[i];
  __syncthreads();
  if (ln_w != nullptr) {
    float s = 0.0f;
    for (int i = threadIdx.x; i < k_total; i += blockDim.x) s += xs[i];
    const float mean = vtt::block_sum(s, scratch) / (float)k_total;
    float v = 0.0f;
    for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
      const float c = xs[i] - mean;
      v += c * c;
    }
    const float var = vtt::block_sum(v, scratch) / (float)k_total;
    const float rstd = rsqrtf(var + 1e-5f);
    for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
      xs[i] = vtt::round_bf16((xs[i] - mean) * rstd * ln_w[i] + ln_b[i]);
    }
  } else {
    for (int i = threadIdx.x; i < k_total; i += blockDim.x) {
      xs[i] = vtt::round_bf16(xs[i]);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * GEMV_WARPS + warp;
  if (col >= f_total) return;
  float acc = 0.0f;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int8_t* wrow = w + ((size_t)kt * f_total + col) * ktile;
    const float* xk = xs + kt * ktile;
#pragma unroll 4
    for (int c = lane * 4; c < ktile; c += 32 * 4) {
      const char4 q = *reinterpret_cast<const char4*>(wrow + c);
      const float4 xv = *reinterpret_cast<const float4*>(xk + c);
      acc += xv.x * (float)q.x;
      acc += xv.y * (float)q.y;
      acc += xv.z * (float)q.z;
      acc += xv.w * (float)q.w;
    }
  }
  acc = vtt::warp_sum(acc);
  if (lane == 0) {
    float y = acc * scale[col] + bias[col];
    if (EPI == EPI_GELU) y = gelu_tanh(y);
    if (EPI == EPI_RESIDUAL) y = res[col] + y;
    out[col] = y;
  }
}

// One block per head.  Lane layout: a cache row of hd bf16 is read by
// lpr = hd/8 lanes, 8 values (16 bytes) each; a warp covers 32/lpr rows at
// once.  Online softmax over the cached prefix [0, pos) in chunks of
// ATT_CHUNK positions (scores in shared memory, the running weighted sum of V
// in registers), then the current token's k/v from `qkv`, unrounded.
// qkv: (3D) f32 [q | k | v]; cache_k, cache_v: this layer's (Tmax, D) bf16
// rows; bias: (Tmax,) f32 additive mask; ctx: (D) f32; kv_new: (2, D) bf16.
// Needs hd % 8 == 0 and 32 % (hd / 8) == 0.
__global__ void __launch_bounds__(ATT_WARPS * 32)
attend_kernel(const float* __restrict__ qkv,
              const __nv_bfloat16* __restrict__ cache_k,
              const __nv_bfloat16* __restrict__ cache_v,
              const float* __restrict__ bias, int pos, int d, int hd,
              float q_scale, float* __restrict__ ctx,
              __nv_bfloat16* __restrict__ kv_new) {
  __shared__ float p[ATT_CHUNK];
  __shared__ float scratch[32];
  extern __shared__ float part[];  // ATT_WARPS * hd partial sums of V
  const int h = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = hd / 8, rows = 32 / lpr;
  const int g = lane / lpr, sub = lane % lpr;
  const size_t col = (size_t)h * hd + sub * 8;
  const float* k_cur = qkv + d + h * hd;
  const float* v_cur = qkv + 2 * d + h * hd;

  float q[8], acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    q[j] = qkv[col + j] * q_scale;
    acc[j] = 0.0f;
  }
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    kv_new[h * hd + i] = __float2bfloat16_rn(k_cur[i]);
    kv_new[d + h * hd + i] = __float2bfloat16_rn(v_cur[i]);
  }
  // the current token's score, from the lanes of warp 0's first row group
  float sc = 0.0f;
  if (warp == 0 && g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc += q[j] * k_cur[sub * 8 + j];
  }
  const float s_cur = vtt::block_sum(sc, scratch);

  float m = -INFINITY, l = 0.0f;
  for (int c0 = 0; c0 < pos; c0 += ATT_CHUNK) {
    const int n = min(ATT_CHUNK, pos - c0);
    for (int r0 = warp * rows; r0 < n; r0 += ATT_WARPS * rows) {
      const int tt = r0 + g;
      float s = 0.0f;
      if (tt < n) {
        float kr[8];
        vtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(
                               cache_k + (size_t)(c0 + tt) * d + col), kr);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += q[j] * kr[j];
      }
      for (int o = lpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tt < n && sub == 0) p[tt] = s + bias[c0 + tt];
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
      vtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(
                             cache_v + (size_t)(c0 + tt) * d + col), vr);
      const float pt = p[tt];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += pt * vr[j];
    }
    m = m_new;
    __syncthreads();  // p is rewritten by the next chunk
  }

  // sum the row groups of each warp (lanes sharing `sub`), then the warps
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    for (int o = lpr; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) part[warp * hd + sub * 8 + j] = acc[j];
  }
  __syncthreads();
  const float m_f = fmaxf(m, s_cur);
  const float alpha = expf(m - m_f);
  const float p_cur = expf(s_cur - m_f);
  const float l_f = l * alpha + p_cur;
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    float a = 0.0f;
    for (int w = 0; w < ATT_WARPS; ++w) a += part[w * hd + i];
    ctx[h * hd + i] = (a * alpha + p_cur * v_cur[i]) / l_f;
  }
}

template <int EPI>
cudaError_t launch_gemv(const float* x, const float* ln_w, const float* ln_b,
                        const int8_t* w, int n_ktiles, int ktile,
                        const float* scale, const float* bias, const float* res,
                        float* out, int f_total, cudaStream_t stream) {
  const size_t smem = (size_t)n_ktiles * ktile * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_gemv_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (f_total + GEMV_WARPS - 1) / GEMV_WARPS;
  dq_gemv_kernel<EPI><<<grid, GEMV_WARPS * 32, smem, stream>>>(
      x, ln_w, ln_b, w, n_ktiles, ktile, scale, bias, res, out, f_total);
  return cudaGetLastError();
}

}  // namespace

// Dequantizing GEMV with optional LN prologue and epilogue
// (epilogue: 0 none, 1 GELU-tanh, 2 residual add `res`).  ktile % 4 == 0,
// w 4-byte aligned.  ln_w / ln_b / res may be null where unused.
VTT_EXPORT int vtt_dq_gemv(const float* x, const float* ln_w, const float* ln_b,
                           const int8_t* w, int n_ktiles, int ktile,
                           const float* scale, const float* bias,
                           const float* res, float* out, int f_total,
                           int epilogue, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_NONE:
      return (int)launch_gemv<EPI_NONE>(x, ln_w, ln_b, w, n_ktiles, ktile,
                                        scale, bias, res, out, f_total, s);
    case EPI_GELU:
      return (int)launch_gemv<EPI_GELU>(x, ln_w, ln_b, w, n_ktiles, ktile,
                                        scale, bias, res, out, f_total, s);
    case EPI_RESIDUAL:
      return (int)launch_gemv<EPI_RESIDUAL>(x, ln_w, ln_b, w, n_ktiles, ktile,
                                            scale, bias, res, out, f_total, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// hd = d / heads with hd % 8 == 0 and 32 % (hd / 8) == 0; cache rows 16-byte
// aligned (d % 8 == 0).
VTT_EXPORT int vtt_decode_attend(const float* qkv, const void* cache_k,
                                 const void* cache_v, const float* bias,
                                 int pos, int d, int heads, float q_scale,
                                 float* ctx, void* kv_new, void* stream) {
  const int hd = d / heads;
  if (hd % 8 != 0 || 32 % (hd / 8) != 0 || d % heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)ATT_WARPS * hd * sizeof(float);
  attend_kernel<<<heads, ATT_WARPS * 32, smem, (cudaStream_t)stream>>>(
      qkv, reinterpret_cast<const __nv_bfloat16*>(cache_k),
      reinterpret_cast<const __nv_bfloat16*>(cache_v), bias, pos, d, hd,
      q_scale, ctx, reinterpret_cast<__nv_bfloat16*>(kv_new));
  return (int)cudaGetLastError();
}

VTT_EXPORT const char* vtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
