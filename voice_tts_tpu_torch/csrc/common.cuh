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

#include <map>
#include <mutex>
#include <utility>

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
// The 8-byte form (cached in L1: .cg takes 16 bytes only).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(addr), "l"(gmem));
}
// The 4-byte form, zero-filling the destination where `valid` is false (the
// source is then not read).
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// int8 byte j of a word, biased by 0x80 (word ^ 0x80808080, so 0..255), to
// its signed value as f32 without an I2F: the bits 0x4B0000bb are 2^23 + bb
// exactly for bb < 256, and 2^23 + 128 is subtracted.
__device__ __forceinline__ float byte_to_f32(unsigned biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
}

// Programmatic dependent launch (sm_90).  A kernel launched with
// `launch_pdl` may start while the previous kernel on its stream still
// runs: before `grid_dependency_wait` it may only read what no earlier
// launch of the sequence writes (weights, constants) and stage that in
// shared memory; the wait returns once the previous grid has completed and
// its writes are visible.  `launch_dependents` lets the next such kernel's
// blocks start once every block of this grid has called it or exited.
// Both are no-ops for a kernel launched without the attribute.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// d += a b over one m16n8k8 TF32 tile: a is the lane's A quad (rows g, g + 8
// at column t, then at t + 4), (b0, b1) its B pair (rows t and t + 4 of
// column g), both already in fragment order and TF32 values.  A three-pass
// split product takes hi = tf32(v) and lo = tf32(v - hi) of each operand
// and accumulates lo.hi + hi.lo + hi.hi in f32: f32-class numerics on the
// TF32 tensor cores (K10, and the f32 DiT attention tile; ops/tf32.py
// models both splits)
__device__ __forceinline__ void mma_tf32(float* d, const float4& a, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default 48
// KB).  The attribute is set once per kernel, device and size, not at every
// launch: each cudaFuncSetAttribute costs host time on a chain of launches.
inline cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{kernel, dev}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

// Launch `kernel` on `stream` with programmatic stream serialization (see
// grid_dependency_wait); returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace vtt
