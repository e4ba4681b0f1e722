// The anti-aliased snake's arithmetic, shared by K2 (aa_snake.cu) and K10's
// prologue (fused_vocoder.cu).
//
// Polyphase form of the 2x FIR up (12-tap kaiser-sinc h), the snake of both
// phases and the 2x FIR down, on a run of 4 samples at a time from 16-byte
// windows in shared memory.  Both kernels lay out a run of outputs that
// starts at sample o0 the same way:
//   xs[p] = x at o0 - 8 + p           (p in [0, n + 16))
//   ze[s], zo[s] = the phases at u = o0 - 4 + s   (s in [0, n + 8))
// so the phases s = 4q .. 4q + 3 read xs[4q .. 4q + 12) and the outputs
// r = 4j .. 4j + 3 read ze / zo[4j .. 4j + 12): three float4 loads each.
//   u_e[u] = 2 sum_a h[2a+1] x[u+2-a],  u_o[u] = 2 sum_a h[2a] x[u+3-a]
//   z = u + (1/beta) sin^2(alpha u)
//   out[t] = sum_b h[2b+1] z_e[t-2+b] + h[2b] z_o[t-3+b]      (a, b = 0..5)
#pragma once

#include "common.cuh"

namespace vtt {

struct AATaps {
  float odd[6];   // h[1], h[3], ..., h[11]
  float even[6];  // h[0], h[2], ..., h[10]
};

inline AATaps aa_taps(const float* host) {
  AATaps taps;
  for (int i = 0; i < 6; ++i) {
    taps.odd[i] = host[i];
    taps.even[i] = host[6 + i];
  }
  return taps;
}

// +-sin(x) (the sign of sin(x - k pi)) for the snake's sin^2, in about 13
// FMA-pipe instructions where the accurate `sinf` (its Cody-Waite path, and
// the Payne-Hanek one inlined beside it) set the pace of both kernels'
// phase loops: sin^2 has period pi, so x is reduced by k = rint(x / pi)
// with a two-part pi in FMAs (each rounds once; r within 6e-8 of x - k pi),
// and sin(r), |r| <= pi / 2, is its Taylor series to r^13 (truncation under
// 7e-10).  Its square is within 2e-7 of sin^2 (f64) where the accurate
// `sinf`'s is within 1e-7, for |x| < SIN_FAST_MAX; beyond, `sinf` is taken.
// chip_smoke.py holds the square against torch.sin in f64 over |x| <= 1e4
// (`vtt_sin2`).
constexpr float SIN_FAST_MAX = 131072.0f;   // 2^17

__device__ __forceinline__ float sin_mod_pi_fast(float x) {
  const float k = rintf(x * 0.31830987334251404f);
  float r = fmaf(-k, 3.1415927410125732f, x);
  r = fmaf(-k, -8.742277657347586e-08f, r);
  const float r2 = r * r;
  float p = 1.6059044372074283e-10f;
  p = fmaf(p, r2, -2.5052107943679403e-08f);
  p = fmaf(p, r2, 2.7557318844628753e-06f);
  p = fmaf(p, r2, -0.00019841270113829523f);
  p = fmaf(p, r2, 0.008333333767950535f);
  p = fmaf(p, r2, -0.1666666716337204f);
  return fmaf(r * r2, p, r);
}

// `sinf` out of line: the rare path stays out of the hot loops' code
static __device__ __noinline__ float sinf_large(float x) { return sinf(x); }

__device__ __forceinline__ float sin_mod_pi(float x) {
  return fabsf(x) < SIN_FAST_MAX ? sin_mod_pi_fast(x) : sinf_large(x);
}

__device__ __forceinline__ void load12(const float* p, float* w) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Both snake phases at s = 4q .. 4q + 3 from xs + 4q (16-byte aligned): the
// phase s = 4q + j reads x[u + 2 - a] = w[j + 6 - a] and x[u + 3 - a] =
// w[j + 7 - a].  The 8 sines are independent chains, computed without a
// branch so that they interleave; an argument past SIN_FAST_MAX (none in a
// vocoder's range) is redone with `sinf` afterwards, as `sin_mod_pi` does.
__device__ __forceinline__ void aa_phases4(const float* xw, const AATaps& taps, float alpha,
                                           float beta_recip, float* ze, float* zo) {
  float w[12], u[8], s[8];
  load12(xw, w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float ue = 0.0f, uo = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      ue += taps.odd[a] * w[j + 6 - a];
      uo += taps.even[a] * w[j + 7 - a];
    }
    u[j] = 2.0f * ue;
    u[4 + j] = 2.0f * uo;
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = sin_mod_pi_fast(u[j] * alpha);
    amax = fmaxf(amax, fabsf(u[j] * alpha));
  }
  if (!(amax < SIN_FAST_MAX)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = sin_mod_pi(u[j] * alpha);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ze[j] = u[j] + beta_recip * s[j] * s[j];
    zo[j] = u[4 + j] + beta_recip * s[4 + j] * s[4 + j];
  }
}

// The down filter at r = 4j + i (i = 0..3) from the phase windows e, o
// (e[m] = z_e at s = 4j + m): output i reads z_e at 4j + i + 2 + b and z_o
// at 4j + i + 1 + b.  PAIRED sums the two phases' terms tap by tap (K2's
// plain order), otherwise the z_e terms, then the z_o terms (K10's).
template <bool PAIRED>
__device__ __forceinline__ void aa_down4(const float* e, const float* o, const AATaps& taps,
                                         float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (PAIRED) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < 6; ++b) acc += e[i + 2 + b] * taps.odd[b] + o[i + 1 + b] * taps.even[b];
      out[i] = acc;
    } else {
      float se = 0.0f, so = 0.0f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        se += e[i + 2 + b] * taps.odd[b];
        so += o[i + 1 + b] * taps.even[b];
      }
      out[i] = se + so;
    }
  }
}

}  // namespace vtt
