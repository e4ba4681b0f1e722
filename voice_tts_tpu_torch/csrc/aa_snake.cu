// K2: anti-aliased snake-beta activation (BigVGAN AMP activation).
//
// Replaces: voice_tts_tpu/ops/aa_activation.py `_aa_snake_pallas` (the
// `_aa_kernel_small` / `_aa_kernel_chunked` Pallas kernels).  The semantics
// are `_aa_core`'s (aa_activation.py:108-120) for the whole signal, including
// the phase-edge rule (left pads take z_even[0], right pads take z_odd[-1]);
// NOT the chunked TPU kernel's, which departs at the outermost ~3 samples.
// The math (aa_math.cuh) on x replicate-padded 3 | 4.
//
// Bound on the H100: device memory.  Each sample is read once and written
// once (8 bytes) for ~56 FLOPs and one sine per phase, far below the ~295
// FLOP/byte ridge; but the two sines make it close to issue-bound.
// Design: one block per (row, tile of `tile` outputs), tile / 8 threads
// (`plan_aa_snake` in ops/aa_activation.py picks the tile: 512, 1024 or
// 2048).  Three passes between two barriers, each on runs of 4 samples:
// x (tile + 16 samples, clamped at the row ends) into shared memory as
// 16-byte loads where T % 4 == 0 (a ragged row takes scalar loads); both
// snake phases once a sample, from three 16-byte shared loads a run, stored
// as float4; the down filter from three 16-byte loads of each phase into a
// register window, stored as float4.  Only a row's first tile and a tile
// ending within 3 samples of T touch the phase edges: there the window's
// entries past the signal take the phase z_e[0] or z_o[T-1] that the tile
// already holds in shared memory (computed from the clamped x like every
// other phase), so no thread waits on a serial edge computation.  The
// snake's sine is aa_math.cuh's `sin_mod_pi`: the accurate `sinf` was most
// of the phase loop's instructions.
#include "aa_math.cuh"

namespace {

__global__ void __launch_bounds__(256)
aa_snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                const float* __restrict__ beta_recip, float* __restrict__ out,
                int channels, int t_len, int tile, int vec, vtt::AATaps taps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [tile + 16]: x at t0 - 8 + p
  float* ze = xs + tile + 16;                     // [tile + 8]: phases at t0 - 4 + s
  float* zo = ze + tile + 8;

  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int n = min(tile, t_len - t0);
  const int runs = (n + 3) >> 2;                  // runs of 4 outputs
  const float* xr = x + (size_t)row * t_len;
  const float a = alpha[row % channels];
  const float br = beta_recip[row % channels];
  const int last = t_len - 1;

  for (int f = threadIdx.x; f < runs + 4; f += blockDim.x) {
    const int g = t0 - 8 + 4 * f;
    float4 v;
    if (vec && g >= 0 && g + 3 <= last) {
      v = *reinterpret_cast<const float4*>(xr + g);
    } else {
      v.x = xr[min(max(g, 0), last)];
      v.y = xr[min(max(g + 1, 0), last)];
      v.z = xr[min(max(g + 2, 0), last)];
      v.w = xr[min(max(g + 3, 0), last)];
    }
    reinterpret_cast<float4*>(xs)[f] = v;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < runs + 2; q += blockDim.x) {
    float e[4], o[4];
    vtt::aa_phases4(xs + 4 * q, taps, a, br, e, o);
    reinterpret_cast<float4*>(ze)[q] = make_float4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<float4*>(zo)[q] = make_float4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  // the phase-edge rule: phases before 0 take z_e[0] (s = 4 - t0), after
  // T - 1 take z_o[T-1] (s = T + 3 - t0).  A tile reads the phases 3
  // samples past its ends: only a row's first tile, and a tile that ends
  // within 3 samples of T, reach past the signal.
  const bool at_left = t0 == 0, at_right = t0 + tile + 3 > t_len;
  const bool edge = at_left || at_right;
  const float left = at_left ? ze[4] : 0.0f;
  const float right = at_right ? zo[last + 4 - t0] : 0.0f;
  float* orow = out + (size_t)row * t_len + t0;
  for (int j = threadIdx.x; j < runs; j += blockDim.x) {
    float e[12], o[12], y[4];
    vtt::load12(ze + 4 * j, e);
    vtt::load12(zo + 4 * j, o);
    if (edge) {
#pragma unroll
      for (int m = 0; m < 12; ++m) {
        const int u = t0 - 4 + 4 * j + m;
        if (u < 0) {
          e[m] = o[m] = left;
        } else if (u > last) {
          e[m] = o[m] = right;
        }
      }
    }
    vtt::aa_down4<true>(e, o, taps, y);
    if (vec && 4 * j + 4 <= n) {
      *reinterpret_cast<float4*>(orow + 4 * j) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * j + i < n) orow[4 * j + i] = y[i];
    }
  }
}

}  // namespace

// x, out: (rows, t_len) f32 contiguous, rows = batch * channels;
// alpha, beta_recip: (channels,) f32; taps_host: 12 host floats
// [h_odd(6), h_even(6)]; tile (512, 1024 or 2048 outputs a block, tile / 8
// threads) and vec (16-byte loads and stores: t_len % 4 == 0 and x, out
// 16-byte aligned) from `plan_aa_snake`.
VTT_EXPORT int vtt_aa_snake(const float* x, const float* alpha,
                            const float* beta_recip, float* out, int rows,
                            int channels, int t_len, int tile, int vec,
                            const float* taps_host, void* stream) {
  if (rows < 1 || rows > 65535 || channels < 1 || t_len < 1 ||
      (tile != 512 && tile != 1024 && tile != 2048))
    return (int)cudaErrorInvalidValue;
  if (vec && (t_len % 4 != 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((t_len + tile - 1) / tile, rows);
  const size_t smem = sizeof(float) * (3 * (size_t)tile + 32);
  aa_snake_kernel<<<grid, tile / 8, smem, (cudaStream_t)stream>>>(
      x, alpha, beta_recip, out, channels, t_len, tile, vec, vtt::aa_taps(taps_host));
  return (int)cudaGetLastError();
}

// out[i] = sin^2(x[i]) as the kernels compute it (aa_math.cuh
// `sin_mod_pi`, squared), n
// values: a check of the sine's accuracy, off the kernels' path.
namespace {
__global__ void sin2_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float s = vtt::sin_mod_pi(x[i]);
    out[i] = s * s;
  }
}
}  // namespace

VTT_EXPORT int vtt_sin2(const float* x, float* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  sin2_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
