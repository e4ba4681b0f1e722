// K10: one late BigVGAN stage (the mean of its AMP resblocks) in one C call.
//
// Replaces: voice_tts_tpu/ops/attic/fused_vocoder.py `fused_resblock_stage`
// (the Pallas `_stage_kernel`, pallas_call at :226).  Semantics
// (fused_vocoder.py:49-78,126-187): the signal is zero outside [0, T); per
// block j and dilation d, xb += conv1(AA(conv_d(AA(xb)))) with SAME zero
// padding, every AA output and conv output taken on [0, T) only; the AA's
// polyphase up-phases and their snake values are computed on the
// zero-extended window and NOT masked (only the AA output is); the blocks'
// results sum in order and the stage output is acc * (1 / nk).  AA math is
// K2's (aa_snake.cu) without its replicate edges:
//   u_e[u] = 2 sum_a h[2a+1] x[u+2-a],  u_o[u] = 2 sum_a h[2a] x[u+3-a]
//   out[t] = sum_b h[2b+1] z_e[t-2+b] + h[2b] z_o[t-3+b].
//
// Bound on the H100: operations.  A stage is 2 C^2 T 6 sum_j k_j f32
// multiply-adds (each block's own 3 / 7 / 11 taps: the centre-embedded zero
// taps of the pack add exactly 0 and are skipped, 21/33 of the work) against
// one read of x, one write of the output and the weights.  Design (the simple
// version, f32 on the CUDA cores): the C call loops over the 2 nk n_iter
// (AA-snake, conv) pairs on the stream, as K8's chain loops over layers; the
// signal and its intermediates (xb, y, out) stay in global memory (11 MB at
// each fused stage of a 448-frame vocode, inside the 50 MB L2).  Each pair
// is one direct-convolution kernel tiled over (32 output channels, 128
// samples): for each chunk of 16 input channels the block loads the input
// window with the conv's halo plus the AA's 6-sample halo, computes the AA
// snake of that window in its prologue (so the activation never goes back
// to global memory; each channel tile recomputes it), stages the chunk's
// weights, and accumulates 4 x 4 outputs a thread.  Bias, the [0, T) mask,
// the residual add and the block accumulation are the epilogue.  The TPU
// kernel's 128-lane margins, per-tap rolls and chunk DMA are Mosaic
// workarounds and are not carried over; TF32 tensor cores would change the
// numerics and are later work.
#include "common.cuh"

namespace {

constexpr int FV_THREADS = 256;   // 32 (time) x 8 (channel) threads
constexpr int FV_TO = 32;         // output channels a block
constexpr int FV_TT = 128;        // output samples a block
constexpr int FV_CI = 16;         // input channels a shared-memory chunk
constexpr int FV_MAX_HALO = 64;   // d * (k - 1) / 2
constexpr int FV_MAX_TAPS = 15;

struct FVTaps {
  float odd[6];   // h[1], h[3], ..., h[11]
  float even[6];  // h[0], h[2], ..., h[10]
};

__device__ __forceinline__ float snake(float u, float alpha, float beta_recip) {
  const float s = sinf(u * alpha);
  return u + beta_recip * s * s;
}

size_t smem_bytes(int halo, int k) {
  const int win = FV_TT + 2 * halo;
  return sizeof(float) * ((size_t)FV_CI * ((win + 12) + 2 * (win + 6) + win)
                          + (size_t)k * FV_TO * FV_CI);
}

// out[o, t] = scale * (acc_in[o, t] + (res[o, t] + conv(AA(in))[o, t] + bias[o]))
// for t in [0, T), with res and acc_in optional (null).  in (C, T); w points
// at the pair's (k_max, C, C) [tap][out][in] taps, of which the k centred
// ones are read.
__global__ void __launch_bounds__(FV_THREADS)
stage_pair_kernel(const float* __restrict__ in, const float* __restrict__ alpha,
                  const float* __restrict__ beta_recip, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* res,
                  const float* acc_in, float* out, int c, int t_len, int k_max,
                  int k, int dil, float scale, FVTaps taps) {
  extern __shared__ float smem[];
  const int halo = dil * (k - 1) / 2;
  const int win = FV_TT + 2 * halo;     // AA outputs the conv reads
  const int xw = win + 12, pw = win + 6;
  float* xs = smem;                     // [FV_CI][xw]  x at t0 - halo - 6 + p
  float* ze = xs + FV_CI * xw;          // [FV_CI][pw]  phases at t0 - halo - 3 + q
  float* zo = ze + FV_CI * pw;
  float* zs = zo + FV_CI * pw;          // [FV_CI][win] AA at t0 - halo + r
  float* ws = zs + FV_CI * win;         // [k][FV_TO][FV_CI]

  const int t0 = blockIdx.x * FV_TT;
  const int o0 = blockIdx.y * FV_TO;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tap0 = (k_max - k) / 2;
  // acc[jo][jt]: output channel o0 + ty + 8 jo, sample t0 + tx + 32 jt
  float acc[4][4];
#pragma unroll
  for (int jo = 0; jo < 4; ++jo)
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) acc[jo][jt] = 0.0f;

  for (int c0 = 0; c0 < c; c0 += FV_CI) {
    const int nci = min(FV_CI, c - c0);
    for (int i = threadIdx.x; i < FV_CI * xw; i += FV_THREADS) {
      const int ci = i / xw, pos = t0 - halo - 6 + i % xw;
      xs[i] = (ci < nci && pos >= 0 && pos < t_len)
                  ? in[(size_t)(c0 + ci) * t_len + pos] : 0.0f;
    }
    for (int i = threadIdx.x; i < k * FV_TO * FV_CI; i += FV_THREADS) {
      const int ci = i % FV_CI, o = (i / FV_CI) % FV_TO, tap = i / (FV_CI * FV_TO);
      ws[i] = (ci < nci && o0 + o < c)
                  ? w[((size_t)(tap0 + tap) * c + o0 + o) * c + c0 + ci] : 0.0f;
    }
    __syncthreads();
    // both snake phases over the zero-extended window (not masked)
    for (int i = threadIdx.x; i < FV_CI * pw; i += FV_THREADS) {
      const int ci = i / pw, q = i % pw;
      const float* xr = xs + ci * xw;
      float ue = 0.0f, uo = 0.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        ue += taps.odd[a] * xr[q + 5 - a];
        uo += taps.even[a] * xr[q + 6 - a];
      }
      const float al = ci < nci ? alpha[c0 + ci] : 0.0f;
      const float br = ci < nci ? beta_recip[c0 + ci] : 0.0f;
      ze[i] = snake(2.0f * ue, al, br);
      zo[i] = snake(2.0f * uo, al, br);
    }
    __syncthreads();
    // the AA output, taken on [0, T)
    for (int i = threadIdx.x; i < FV_CI * win; i += FV_THREADS) {
      const int ci = i / win, r = i % win, pos = t0 - halo + r;
      const float* er = ze + ci * pw;
      const float* orr = zo + ci * pw;
      float e = 0.0f, o = 0.0f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        e += er[r + 1 + b] * taps.odd[b];
        o += orr[r + b] * taps.even[b];
      }
      zs[i] = (pos >= 0 && pos < t_len) ? e + o : 0.0f;
    }
    __syncthreads();
    // the conv over this chunk: output t0 + i reads zs[i + tap * dil]
    for (int ci = 0; ci < nci; ++ci) {
      const float* zr = zs + ci * win + tx;
      for (int tap = 0; tap < k; ++tap) {
        const float* wr = ws + (tap * FV_TO + ty) * FV_CI + ci;
        float wv[4];
#pragma unroll
        for (int jo = 0; jo < 4; ++jo) wv[jo] = wr[8 * jo * FV_CI];
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          const float z = zr[32 * jt + tap * dil];
#pragma unroll
          for (int jo = 0; jo < 4; ++jo) acc[jo][jt] += wv[jo] * z;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jo = 0; jo < 4; ++jo) {
    const int o = o0 + ty + 8 * jo;
    if (o >= c) continue;
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      const int t = t0 + tx + 32 * jt;
      if (t >= t_len) continue;
      const size_t i = (size_t)o * t_len + t;
      float v = acc[jo][jt] + bias[o];
      if (res != nullptr) v = res[i] + v;
      if (acc_in != nullptr) v = acc_in[i] + v;
      out[i] = v * scale;
    }
  }
}

}  // namespace

// x, xb, y, out: (C, T) f32 contiguous (xb and y scratch); w: (n, k_max, C, C)
// f32 [pair][tap][out][in]; bias, alpha, beta_recip: (n, C) f32, with
// n = 2 * n_blocks * n_iter pairs ordered block-major, then (convs1_m,
// convs2_m) per iteration.  Host arrays: kernel_sizes (n_blocks, odd, each
// block's own taps centred in k_max), dilations (n_iter), taps (12 floats
// [h_odd(6), h_even(6)]).  inv_nk = f32(1 / n_blocks).
VTT_EXPORT int vtt_fused_resblock_stage(
    const float* x, const float* w, const float* bias, const float* alpha,
    const float* beta_recip, float* xb, float* y, float* out, int c, int t_len,
    int k_max, int n_blocks, int n_iter, const int* kernel_sizes,
    const int* dilations, const float* taps_host, float inv_nk, void* stream) {
  const size_t max_smem = smem_bytes(FV_MAX_HALO, FV_MAX_TAPS);
  const cudaError_t attr = vtt::allow_dynamic_smem((const void*)stage_pair_kernel, max_smem);
  if (attr != cudaSuccess) return (int)attr;
  if (c < 1 || t_len < 1 || n_blocks < 1 || n_iter < 1) return (int)cudaErrorInvalidValue;
  FVTaps taps;
  for (int i = 0; i < 6; ++i) {
    taps.odd[i] = taps_host[i];
    taps.even[i] = taps_host[6 + i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((t_len + FV_TT - 1) / FV_TT, (c + FV_TO - 1) / FV_TO);
  const size_t cc = (size_t)c * c;
  for (int j = 0; j < n_blocks; ++j) {
    const int k = kernel_sizes[j];
    if (k < 1 || k % 2 == 0 || k > k_max || k > FV_MAX_TAPS) return (int)cudaErrorInvalidValue;
    for (int m = 0; m < n_iter; ++m) {
      const int d = dilations[m];
      if (d < 1 || d * (k - 1) / 2 > FV_MAX_HALO) return (int)cudaErrorInvalidValue;
      const int p = j * 2 * n_iter + 2 * m;
      const float* src = m == 0 ? x : xb;
      stage_pair_kernel<<<grid, FV_THREADS, smem_bytes(d * (k - 1) / 2, k), s>>>(
          src, alpha + (size_t)p * c, beta_recip + (size_t)p * c, w + p * k_max * cc,
          bias + (size_t)p * c, nullptr, nullptr, y, c, t_len, k_max, k, d, 1.0f, taps);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      // the second conv adds into xb, or, after the last dilation, into the
      // blocks' running sum (scaled by 1 / nk after the last block)
      const bool last = m == n_iter - 1;
      stage_pair_kernel<<<grid, FV_THREADS, smem_bytes((k - 1) / 2, k), s>>>(
          y, alpha + (size_t)(p + 1) * c, beta_recip + (size_t)(p + 1) * c,
          w + (p + 1) * k_max * cc, bias + (size_t)(p + 1) * c, src,
          last && j > 0 ? out : nullptr, last ? out : xb, c, t_len, k_max, k, 1,
          last && j == n_blocks - 1 ? inv_nk : 1.0f, taps);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaSuccess;
}
