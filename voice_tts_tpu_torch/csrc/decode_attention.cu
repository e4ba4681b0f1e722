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
// moves under 2 MB, so launch latency and the chain of dependent steps in a
// block set its time.
//
// Design (flash-decoding over the live prefix):
// - the grid is (head, row, split): split s covers positions [s * W,
//   (s + 1) * W) of [0, length), W a power of two in 32..512 chosen by
//   `plan_decode_splits` (ops/decode_attention.py) so that the grid holds
//   up to four blocks an SM.  No position >= length is read: the 16-byte
//   vector that straddles `length` is read element by element;
// - a block's dependent steps are few: its first k and v rows, its bias
//   and q are loaded together before the first barrier;
// - the cache is time-minor, so a thread owns POS = 16 / sizeof(T)
//   consecutive positions (8 bf16, 4 f32) and reads them as one 16-byte
//   vector from each head-dim row it owns; the W / POS threads of a row
//   read W contiguous positions (512 contiguous bytes at W 256 bf16).  The
//   block's R = 256 / (W / POS) row groups split the hd rows;
// - scores: each thread accumulates its positions' q . k over its rows in
//   f32 registers; the row groups' partials meet through warp shuffles and
//   shared memory once a split; then one block max, p = exp(s - m) and
//   one block sum;
// - P.V keeps the ownership: each thread multiplies its positions' p into
//   each v row it reads, and the partial sums of a row meet once a split
//   (shuffles, then shared memory);
// - the live length is a host int, or (`length_dev`) an int the kernel reads
//   from device memory: the decode step of a device loop, whose position
//   no host code reads (JAX prefetches it as a traced scalar,
//   decode_attention.py:104-131).  Then the grid is a fixed plan for the
//   whole cache (`plan_decode_splits(b, h, t_max)`): a block whose split
//   starts at or past the length writes nothing and only arrives, and the
//   combine takes the live splits alone, so the result is the host-int
//   form's at the same split width, bit for bit;
// - the combine is in-kernel: each block writes its split's (o, m, l) to
//   `work` and counts itself on its (row, head) arrival counter; the last
//   block to arrive resets the counter for the next launch and combines
//   the splits in split order (the largest m first, then sum_s l_s e^(m_s
//   - M) and sum_s o_s e^(m_s - M), each in split order, read with __ldcg
//   after a __threadfence), so two calls are bit-equal whichever block
//   comes last.  No second launch.  A split wholly under the -1e30 bias
//   has m_s = -1e30 and adds e^(-1e30 - M) = 0 unless every live position
//   is masked, where all splits tie and the average is uniform, as in the
//   plain version.
// The TPU kernel's double-buffered DMA, run_scoped and scalar-prefetch grid
// are TPU machinery and are not carried over.
#include "common.cuh"

namespace {

constexpr int DA_THREADS = 256;
constexpr int DA_MAX_HD = 128;
constexpr int AHEAD = 2;            // k and v rows a thread loads before q lands

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The POS values at p as f32; only the first `live` are read (the rest are
// 0): a full vector is one 16-byte load.
template <typename T, int POS>
__device__ __forceinline__ void load_vec(const T* p, int live, float (&f)[POS]) {
  if (live >= POS) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (POS == 8) {
      vtt::bf16x8_to_f32(raw, f);
    } else {
      f[0] = __uint_as_float(raw.x);
      f[1] = __uint_as_float(raw.y);
      f[2] = __uint_as_float(raw.z);
      f[3] = __uint_as_float(raw.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < POS; ++j) f[j] = j < live ? to_f32(p[j]) : 0.0f;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(DA_THREADS)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ bias,
                              T* __restrict__ out, int hd, int t_max, int length_arg,
                              const int* __restrict__ length_dev, float scale,
                              float* __restrict__ work, int* __restrict__ arrivals) {
  constexpr int POS = 16 / sizeof(T);        // positions a thread owns
  constexpr int G = W / POS;                 // threads along a row of W positions
  constexpr int R = DA_THREADS / G;          // row groups
  constexpr int SLOTS = G <= 32 ? DA_THREADS / 32 : R;   // score partials a position
  constexpr int OW = G <= 32 ? 1 : G / 32;   // P.V partials a head-dim row
  static_assert(G >= 4 && G <= DA_THREADS && DA_THREADS % G == 0, "split width");
  __shared__ float qs[DA_MAX_HD];
  __shared__ float red[SLOTS][W];            // score partials of the row groups
  __shared__ float ps[W];                    // scores, then p
  __shared__ float opart[OW][DA_MAX_HD];     // P.V partials
  __shared__ float scratch[32];
  __shared__ int last;

  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int heads = gridDim.x, n_splits = gridDim.z;
  const size_t bh = (size_t)b * heads + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = tid % G, dr = tid / G;
  // a device length is clamped to [1, t_max]: no read past the cache
  const int length =
      length_dev != nullptr ? min(max(__ldg(length_dev), 1), t_max) : length_arg;
  const int n_live = (length + W - 1) / W;   // the splits that hold live positions
  const int t0 = sp * W;
  const int n = min(W, length - t0);         // live positions of the split
  const int tp = t0 + pg * POS;              // this thread's first position
  const int live = length - tp;              // its live positions (<= 0: none)
  const T* kr = k + bh * hd * t_max + tp;
  const T* vr = v + bh * hd * t_max + tp;
  const int rows = (hd + R - 1) / R;         // uniform across the block

  const int stride = hd + 2;
  if (sp < n_live) {                         // uniform across the block
    // everything the first steps need, in flight together: the bias of the
    // positions this thread scores, its first AHEAD k and v rows, and q
    float bias_p[(W + DA_THREADS - 1) / DA_THREADS];
#pragma unroll
    for (int i = 0; i < (W + DA_THREADS - 1) / DA_THREADS; ++i) {
      const int p = tid + i * DA_THREADS;
      bias_p[i] = p < n ? bias[(size_t)b * t_max + t0 + p] : 0.0f;
    }
    float k_ahead[AHEAD][POS], v_ahead[AHEAD][POS];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int d = dr + i * R;
#pragma unroll
      for (int j = 0; j < POS; ++j) k_ahead[i][j] = v_ahead[i][j] = 0.0f;
      if (i < rows && d < hd) {
        load_vec<T, POS>(kr + (size_t)d * t_max, live, k_ahead[i]);
        load_vec<T, POS>(vr + (size_t)d * t_max, live, v_ahead[i]);
      }
    }
    for (int d = tid; d < hd; d += DA_THREADS) qs[d] = to_f32(q[bh * hd + d]);
    __syncthreads();

    // scores: this thread's POS positions over its head-dim rows
    float s[POS];
#pragma unroll
    for (int j = 0; j < POS; ++j) s[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int d = dr + i * R;
      if (i < rows && d < hd) {
        const float qd = qs[d];
#pragma unroll
        for (int j = 0; j < POS; ++j) s[j] = fmaf(qd, k_ahead[i][j], s[j]);
      }
    }
#pragma unroll 4
    for (int i = AHEAD; i < rows; ++i) {
      const int d = dr + i * R;
      if (d < hd) {
        float kf[POS];
        load_vec<T, POS>(kr + (size_t)d * t_max, live, kf);
        const float qd = qs[d];
#pragma unroll
        for (int j = 0; j < POS; ++j) s[j] = fmaf(qd, kf[j], s[j]);
      }
    }
    if constexpr (G < 32) {                    // the warp's row groups first
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < POS; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      if (lane < G) {
#pragma unroll
        for (int j = 0; j < POS; ++j) red[warp][pg * POS + j] = s[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < POS; ++j) red[dr][pg * POS + j] = s[j];
    }
    __syncthreads();
    float cm = -INFINITY;
#pragma unroll
    for (int i = 0; i < (W + DA_THREADS - 1) / DA_THREADS; ++i) {
      const int p = tid + i * DA_THREADS;
      float sc = -INFINITY;
      if (p < n) {
        float a = red[0][p];
#pragma unroll
        for (int r = 1; r < SLOTS; ++r) a += red[r][p];
        sc = a * scale + bias_p[i];
      }
      if (p < W) ps[p] = sc;
      cm = fmaxf(cm, sc);
    }
    const float m = vtt::block_max(cm, scratch);
    float ls = 0.0f;
    for (int p = tid; p < W; p += DA_THREADS) {   // the entries this thread wrote
      const float e = p < n ? expf(ps[p] - m) : 0.0f;
      ps[p] = e;
      ls += e;
    }
    const float l = vtt::block_sum(ls, scratch);  // ends with a barrier: ps complete

    // P.V: this thread's positions' p into each v row it reads (the first
    // AHEAD rows were loaded with the k rows)
    float pj[POS];
#pragma unroll
    for (int j = 0; j < POS; ++j) pj[j] = ps[pg * POS + j];
    auto pv_row = [&](int d, const float (&vf)[POS]) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < POS; ++j) a = fmaf(pj[j], vf[j], a);
      if constexpr (G <= 32) {                 // the row's G threads share a warp
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (pg == 0 && d < hd) opart[0][d] = a;
      } else {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0 && d < hd) opart[pg / 32][d] = a;
      }
    };
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (i < rows) pv_row(dr + i * R, v_ahead[i]);
    }
#pragma unroll 4
    for (int i = AHEAD; i < rows; ++i) {
      const int d = dr + i * R;
      float vf[POS];
      if (d < hd) {
        load_vec<T, POS>(vr + (size_t)d * t_max, live, vf);
      } else {
#pragma unroll
        for (int j = 0; j < POS; ++j) vf[j] = 0.0f;
      }
      pv_row(d, vf);
    }
    __syncthreads();

    // this split's (o, m, l), then the arrival count (a dead split, past a
    // device length, only arrives)
    float* mine = work + (bh * n_splits + sp) * stride;
    for (int d = tid; d < hd; d += DA_THREADS) {
      float a = opart[0][d];
#pragma unroll
      for (int w = 1; w < OW; ++w) a += opart[w][d];
      mine[d] = a;
    }
    if (tid == 0) {
      mine[hd] = m;
      mine[hd + 1] = l;
    }
  }
  __threadfence();                           // the partial before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                           // the other splits' partials after it
  if (tid == 0) arrivals[bh] = 0;

  // the combine of the live splits, in split order
  const float* all = work + bh * n_splits * stride;
  float mx = -INFINITY;
  for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, __ldcg(all + (size_t)i * stride + hd));
  for (int d = tid; d < hd; d += DA_THREADS) {
    float lt = 0.0f, ot = 0.0f;
    for (int i = 0; i < n_live; ++i) {
      const float* part = all + (size_t)i * stride;
      const float c = expf(__ldcg(part + hd) - mx);   // 0 for an empty split
      lt += __ldcg(part + hd + 1) * c;
      ot += __ldcg(part + d) * c;
    }
    store(out + bh * hd + d, ot / lt);
  }
}

template <typename T, int W>
cudaError_t launch_split(const void* q, const void* k, const void* v, const float* bias,
                         void* out, int batch, int heads, int hd, int t_max, int length,
                         const int* length_dev, int n_splits, float scale, float* work,
                         int* arrivals, cudaStream_t stream) {
  const dim3 grid(heads, batch, n_splits);
  decode_attention_split_kernel<T, W><<<grid, DA_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, hd, t_max, length, length_dev,
      scale, work, arrivals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int split_t, const void* q, const void* k, const void* v,
                         const float* bias, void* out, int batch, int heads, int hd,
                         int t_max, int length, const int* length_dev, int n_splits,
                         float scale, float* work, int* arrivals, cudaStream_t s) {
#define VTT_K5_WIDTH(W)                                                                 \
  case W:                                                                               \
    return launch_split<T, W>(q, k, v, bias, out, batch, heads, hd, t_max, length,      \
                              length_dev, n_splits, scale, work, arrivals, s);
  switch (split_t) {
    VTT_K5_WIDTH(32)
    VTT_K5_WIDTH(64)
    VTT_K5_WIDTH(128)
    VTT_K5_WIDTH(256)
    VTT_K5_WIDTH(512)
    default:
      return cudaErrorInvalidValue;
  }
#undef VTT_K5_WIDTH
}

}  // namespace

// q, out: (B, H, hd) contiguous; k, v: (B, H, hd, t_max) contiguous, all of
// one dtype, bf16 (is_bf16 = 1) or f32, 16-byte aligned, t_max a multiple
// of the positions in 16 bytes; bias: (B, t_max) f32 additive; the
// attendable positions: `length` (1..t_max) when length_dev is null, else
// the int at length_dev, read on the device and clamped to [1, t_max];
// hd <= 128; split_t (32, 64, ..., 512) the positions a block; n_splits
// the grid's splits, ceil(length / split_t) for a host length, at least
// ceil(t_max / split_t) for a device one; work: >= B * H * n_splits *
// (hd + 2) f32; arrivals: B * H int32, zero (each launch leaves them zero).
VTT_EXPORT int vtt_decode_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int is_bf16,
                                    int batch, int heads, int hd, int t_max,
                                    int length, const int* length_dev, int n_splits,
                                    float scale, int split_t, float* work,
                                    int* arrivals, void* stream) {
  const int pos = is_bf16 ? 8 : 4;
  const long long cover = (long long)n_splits * split_t;
  if (hd < 1 || hd > DA_MAX_HD || t_max % pos || split_t < 1
      || (length_dev == nullptr && (length < 1 || length > t_max
                                    || n_splits != (length + split_t - 1) / split_t))
      || (length_dev != nullptr && cover < t_max)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      is_bf16 ? launch_width<__nv_bfloat16>(split_t, q, k, v, bias, out, batch, heads, hd,
                                            t_max, length, length_dev, n_splits, scale, work,
                                            arrivals, s)
              : launch_width<float>(split_t, q, k, v, bias, out, batch, heads, hd, t_max,
                                    length, length_dev, n_splits, scale, work, arrivals, s);
  return (int)e;
}
