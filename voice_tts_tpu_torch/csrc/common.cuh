// Shared helpers for the hand-written Hopper kernels of voice_tts_tpu_torch.
//
// Every kernel file exposes plain C entry points (bound with ctypes by
// voice_tts_tpu_torch/ops/build.py).  Each entry launches on the stream it is
// given and returns cudaGetLastError() as an int, so a launch that CUDA
// refuses (too many threads, too much shared memory) is reported to Python
// instead of silently never running.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VTT_EXPORT extern "C" __attribute__((visibility("default")))

namespace vtt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions: every thread of the block gets the result.
// `scratch` holds at least 32 floats of shared memory; the block size is a
// multiple of 32.  Ends with a barrier, so `scratch` may be reused at once.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : 0.0f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : -INFINITY;
  t = warp_max(t);
  __syncthreads();
  return t;
}

// Asynchronous 16-byte copy from device to shared memory (Ampere's
// cp.async, kept on Hopper), with its commit and wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Round an f32 value to bf16 precision (round-to-nearest-even) and widen it
// back: the JAX kernels cast each activation to bf16 before a product.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Widen the 8 bf16 values of one 16-byte load to f32 (f[j] is element j;
// bf16 is the high half of an f32, and the lower address the low half-word).
__device__ __forceinline__ void bf16x8_to_f32(const uint4 raw, float* f) {
  const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

}  // namespace vtt
