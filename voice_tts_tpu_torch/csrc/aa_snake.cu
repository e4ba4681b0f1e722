// K2: anti-aliased snake-beta activation (BigVGAN AMP activation).
//
// Replaces: voice_tts_tpu/ops/aa_activation.py `_aa_snake_pallas` (the
// `_aa_kernel_small` / `_aa_kernel_chunked` Pallas kernels).  The semantics
// are `_aa_core`'s (aa_activation.py:108-120) for the whole signal, including
// the phase-edge rule (left pads take z_even[0], right pads take z_odd[-1]);
// NOT the chunked TPU kernel's, which departs at the outermost ~3 samples.
//
// Math (polyphase form, 12-tap kaiser-sinc h, x replicate-padded 3 | 4):
//   u_e[t] = 2 sum_a h[2a+1] x[t+2-a],  u_o[t] = 2 sum_a h[2a] x[t+3-a]
//   z = u + (1/beta) sin^2(alpha u)            (both phases)
//   out[t] = sum_b h[2b+1] ZE(t-2+b) + h[2b] ZO(t-3+b)      (a, b = 0..5)
//
// Bound on the H100: device memory.  Each sample is read once and written
// once (8 bytes) for ~50 FLOPs and one sinf per phase, far below the ~295
// FLOP/byte ridge, so the kernel is a stream.  Design: one block per
// (batch*channel row, time tile of AA_TILE outputs).  The block stages its
// x tile plus a 6-sample halo on each side in shared memory (coalesced
// loads, clamped at the signal ends), computes both snake phases once for
// the tile plus a 3-sample halo, then applies the down filter from shared
// memory: x is read from device memory once, the 2x-upsampled signal never
// leaves the SM.  `sinf` (not `__sinf`) keeps full f32 accuracy for large
// alpha*u arguments.
#include "common.cuh"

namespace {

constexpr int AA_TILE = 512;
constexpr int AA_THREADS = 256;

struct AATaps {
  float odd[6];   // h[1], h[3], ..., h[11]
  float even[6];  // h[0], h[2], ..., h[10]
};

__device__ __forceinline__ float snake(float u, float alpha, float beta_recip) {
  const float s = sinf(u * alpha);
  return u + beta_recip * s * s;
}

__global__ void __launch_bounds__(AA_THREADS)
aa_snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                const float* __restrict__ beta_recip, float* __restrict__ out,
                int channels, int t_len, AATaps taps) {
  __shared__ float xs[AA_TILE + 12];
  __shared__ float ze[AA_TILE + 6];
  __shared__ float zo[AA_TILE + 6];
  __shared__ float edge[2];

  const int row = blockIdx.y;
  const int t0 = blockIdx.x * AA_TILE;
  const int n = min(AA_TILE, t_len - t0);
  const float* xr = x + (size_t)row * t_len;
  const float a = alpha[row % channels];
  const float br = beta_recip[row % channels];
  const int last = t_len - 1;

  // xs[i] = x[clamp(t0 - 6 + i)] covers every tap of phases t0-3 .. t0+n+2
  for (int i = threadIdx.x; i < n + 12; i += blockDim.x) {
    xs[i] = xr[min(max(t0 - 6 + i, 0), last)];
  }
  if (threadIdx.x == 0) {
    // the two values the phase edges replicate: z_e[0] and z_o[T-1]
    float ue = 0.0f, uo = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      ue += taps.odd[k] * xr[min(max(2 - k, 0), last)];
      uo += taps.even[k] * xr[min(max(last + 3 - k, 0), last)];
    }
    edge[0] = snake(2.0f * ue, a, br);
    edge[1] = snake(2.0f * uo, a, br);
  }
  __syncthreads();

  // phases u = t0-3+i for i in [0, n+6): x[u+d] lives at xs[i+3+d]
  for (int i = threadIdx.x; i < n + 6; i += blockDim.x) {
    const int u = t0 - 3 + i;
    float ue = 0.0f, uo = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      ue += taps.odd[k] * xs[i + 5 - k];
      uo += taps.even[k] * xs[i + 6 - k];
    }
    float ve = snake(2.0f * ue, a, br);
    float vo = snake(2.0f * uo, a, br);
    if (u < 0) {
      ve = vo = edge[0];
    } else if (u > last) {
      ve = vo = edge[1];
    }
    ze[i] = ve;
    zo[i] = vo;
  }
  __syncthreads();

  // out[t0+i] reads ZE(t-2+b) = ze[i+1+b] and ZO(t-3+b) = zo[i+b]
  float* orow = out + (size_t)row * t_len + t0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      acc += ze[i + 1 + b] * taps.odd[b] + zo[i + b] * taps.even[b];
    }
    orow[i] = acc;
  }
}

}  // namespace

// x, out: (rows, t_len) f32 contiguous, rows = batch * channels;
// alpha, beta_recip: (channels,) f32; taps_host: 12 host floats
// [h_odd(6), h_even(6)].
VTT_EXPORT int vtt_aa_snake(const float* x, const float* alpha,
                            const float* beta_recip, float* out, int rows,
                            int channels, int t_len, const float* taps_host,
                            void* stream) {
  AATaps taps;
  for (int k = 0; k < 6; ++k) {
    taps.odd[k] = taps_host[k];
    taps.even[k] = taps_host[6 + k];
  }
  dim3 grid((t_len + AA_TILE - 1) / AA_TILE, rows);
  aa_snake_kernel<<<grid, AA_THREADS, 0, (cudaStream_t)stream>>>(
      x, alpha, beta_recip, out, channels, t_len, taps);
  return (int)cudaGetLastError();
}
