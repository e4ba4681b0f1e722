// K10: one late BigVGAN stage (the mean of its AMP resblocks) in one C call.
//
// Replaces: voice_tts_tpu/ops/attic/fused_vocoder.py `fused_resblock_stage`
// (the Pallas `_stage_kernel`, pallas_call at :226).  Semantics
// (fused_vocoder.py:49-78,126-187): the signal is zero outside [0, T); per
// block j and dilation d, xb += conv1(AA(conv_d(AA(xb)))) with SAME zero
// padding, every AA output and conv output taken on [0, T) only; the AA's
// polyphase up-phases and their snake values are computed on the
// zero-extended window and NOT masked (only the AA output is); the blocks'
// results sum in order and the stage output is acc * (1 / nk).  The AA math
// is K2's (aa_math.cuh) without its replicate edges.
//
// Bound on the H100: operations.  A stage is 2 C^2 T n_iter sum_j k_j
// multiply-adds (each block's own 3 / 7 / 11 taps) against one read of x,
// one write of the output and the weights: 3.73 ms in f32 on the CUDA
// cores at a 448-frame vocode's four stages, 1.51 ms as three TF32 passes
// on the tensor cores.  Design: the C call loops over the 2 nk n_iter
// (AA-snake, conv) pairs on the stream; the signal and its intermediates
// (xb, y, out) stay in global memory.  Each pair is one implicit GEMM,
//   out[o, t] = sum_{tap, ci} W[tap][o][ci] Z[ci, t + tap d - halo],
// with M every output channel (so the AA prologue runs once per (input
// channel, sample) of a block's time tile and its halo), N a tile of BN
// samples and K the input channels times the block's own k taps.
// `mma.sync` m16n8k8 TF32 (`wgmma` takes its B from shared memory through
// descriptors that cannot start at an arbitrary row, and each tap shifts
// Z by tap * d rows) with f32-class numerics by a three-pass split: each
// operand v is hi = tf32(v) and lo = tf32(v - hi) (round to nearest), and
// a block accumulates lo.hi + hi.lo + hi.hi in f32.  The weights are split
// once, when the stage is packed (`KernelPack`, ops/fused_vocoder.py), per
// (tap, 8 input channels) into a slab of the lanes' A quads, hi and lo, in
// fragment order: one 16-byte shared load is an HMMA operand.  The
// activations are split once, when the prologue writes them to shared
// memory ([row][16] per 8 channels: a lane's hi and lo B pairs for a row
// are one 16-byte load), and a tap's shift is an address offset.  Per
// chunk of 16 input channels the prologue stages x with the halo (zero
// outside [0, T), by cp.async, in Z's space), computes both snake phases
// once a sample and the down filter into Z, while the weights stream
// through a 3-stage cp.async ring across the chunks, a stage one tap's two
// slabs (one barrier a tap).  Warps tile M x N
// (`plan_fused_stage`, mirrored here by `plan_stage`); bias, the [0, T)
// mask, the residual add and the block accumulation are the epilogue,
// straight from the accumulators in 8-byte pairs along time.  The 18 pair
// launches run under programmatic dependent launch: a block puts its first
// weight stages in flight before it waits for the previous pair.
#include "aa_math.cuh"

namespace {

constexpr int FV_THREADS = 256;   // 8 warps
constexpr int FV_CI = 16;         // input channels a prologue chunk (two 8-channel slabs)
constexpr int FV_STAGES = 3;      // ring stages (one tap of a chunk each)
constexpr int FV_MAX_HALO = 64;   // d * (k - 1) / 2 (25 at the flagship config)
constexpr int FV_MAX_TAPS = 15;
constexpr int FV_MAX_C = 192;

// span: a measurement arm that runs only one part of each pair kernel (the
// output is then not the stage's): the prologue; the MMA loop; the MMA loop
// without its weight stream (on whatever the ring holds); neither (the
// weight stream, the barriers and the epilogue)
constexpr int SPAN_ALL = 0, SPAN_PROLOGUE = 1, SPAN_MMA = 2, SPAN_MMA_NO_WEIGHTS = 3,
              SPAN_SKELETON = 4;

struct StagePlan {
  int bn, wm, mt, nt, ci, stages, threads, smem;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Z rows of a tile: BN + 2 halo rounded to runs of 4
__host__ __device__ inline int z_rows(int bn, int halo) { return bn + round_up(2 * halo, 4); }

// a phase row's stride in floats: 4 mod 8, so 8 channels' 16-byte loads at
// one offset fall in distinct banks
__host__ __device__ inline int phase_stride(int rows) {
  const int s = rows + 8;
  return s % 8 == 0 ? s + 4 : s;
}

// the ring (stages of two 8-channel slabs of CP x 16), Z's two planes
// (which x shares) and the two phases
size_t smem_floats(int cp, int bn, int halo) {
  const int rows = z_rows(bn, halo);
  return (size_t)FV_STAGES * 2 * cp * 16 + 2 * (size_t)rows * 16 +
         2 * (size_t)FV_CI * phase_stride(rows);
}

// The warps' split of the output channels: wm warp rows of mt 16-channel
// tiles, the fewest that hold C (the padded channels have zero weights).
void channel_tiles(int c, int* wm, int* mt) {
  static const int opts[7][2] = {{1, 1}, {1, 2}, {1, 3}, {2, 2}, {2, 3}, {4, 2}, {4, 3}};
  const int m16 = (c + 15) / 16;
  for (const auto& o : opts) {
    if (o[0] * o[1] >= m16) {
      *wm = o[0];
      *mt = o[1];
      return;
    }
  }
  *wm = *mt = 0;
}

// The launch of one (AA, conv) pair: `plan_fused_stage` in
// ops/fused_vocoder.py is the same rule.  M is every output channel (wm
// warp rows of mt 16-row tiles), N a time tile of bn = (8 / wm) warp
// columns of nt = 4 8-sample tiles.
bool plan_stage(int c, int t, int k, int d, StagePlan* p) {
  if (c < 8 || c > FV_MAX_C || c % 8 != 0 || t < 1 || k < 1 || k % 2 == 0 ||
      k > FV_MAX_TAPS || d < 1 || d * (k - 1) / 2 > FV_MAX_HALO)
    return false;
  channel_tiles(c, &p->wm, &p->mt);
  p->nt = 4;
  p->bn = 8 / p->wm * p->nt * 8;
  p->ci = FV_CI;
  p->stages = FV_STAGES;
  p->threads = FV_THREADS;
  p->smem = (int)(sizeof(float) * smem_floats(16 * p->wm * p->mt, p->bn, d * (k - 1) / 2));
  return true;
}

__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// out[o, t] = scale * (acc_in[o, t] + (res[o, t] + conv(AA(in))[o, t] + bias[o]))
// for t in [0, T), with res and acc_in optional (null).  in (C, T); wk the
// pair's (k_max, C / 8) slabs of CP x 16 split weights in fragment order,
// of which the k centred taps (from tap0) are read.
template <int WM, int MT>
__global__ void __launch_bounds__(FV_THREADS, 2)
stage_pair_mma_kernel(const float* __restrict__ in, const float* __restrict__ alpha,
                      const float* __restrict__ beta_recip, const float* __restrict__ wk,
                      const float* __restrict__ bias, const float* res, const float* acc_in,
                      float* out, int c, int t_len, int k, int tap0, int dil, float scale,
                      int span, int vec2, vtt::AATaps taps) {
  constexpr int NT = 4, WN = 8 / WM, BN = WN * NT * 8, CP = WM * MT * 16;
  constexpr int SLAB = CP * 16;                    // floats of a weight slab (8 channels)
  constexpr int STAGE = 2 * SLAB;                  // a ring stage: one tap of a chunk
  const int halo = dil * (k - 1) / 2;
  const int rows = z_rows(BN, halo);
  const int xw = rows + 16, ps = phase_stride(rows);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [FV_STAGES][STAGE]
  float* zs = ring + FV_STAGES * STAGE;            // [2][rows][16]: Z hi / lo
  float* xs = zs;                                  // [FV_CI][xw]: x at o0 - 8 + p, in Z's
                                                   // space until the phases are done
  float* ze = zs + 2 * rows * 16;                  // [FV_CI][ps]: phases at o0 - 4 + s
  float* zo = ze + FV_CI * ps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int t0 = blockIdx.x * BN;
  const int o0 = t0 - halo;                        // the sample of Z row 0
  const int slabs = c / 8;                         // 8-channel slabs of the input

  // the next ring stage to put in flight, in the MMA loop's order: chunk,
  // then tap; a stage holds the tap's two slabs of the chunk (one in a
  // last chunk of 8 channels), adjacent in wk
  int ld_q = 0, ld_tap = 0, ld_c0 = 0;
  auto load_stage = [&]() {
    if (ld_c0 < c && span != SPAN_PROLOGUE && span != SPAN_MMA_NO_WEIGHTS) {
      const float* src = wk + ((size_t)(tap0 + ld_tap) * slabs + ld_c0 / 8) * SLAB;
      float* dst = ring + (ld_q % FV_STAGES) * STAGE;
      const int n = min(FV_CI, c - ld_c0) / 8 * (SLAB / 4);
      for (int i = tid; i < n; i += FV_THREADS) vtt::cp_async16(dst + 4 * i, src + 4 * i);
    }
    vtt::cp_async_commit();
    ++ld_q;
    if (++ld_tap == k) {
      ld_tap = 0;
      ld_c0 += FV_CI;
    }
  };
  // the weights are no launch's output: in flight before the wait for the
  // previous pair (programmatic dependent launch), which wrote in, res and
  // acc_in or still reads what this one writes
#pragma unroll
  for (int s = 0; s < FV_STAGES - 1; ++s) load_stage();
  vtt::grid_dependency_wait();
  const bool prologue = span == SPAN_ALL || span == SPAN_PROLOGUE;
  // x of the input channels [cc0, cc0 + 16) over the tile, the conv's halo
  // and the AA's, zero outside [0, T): every load in flight at once
  auto stage_x = [&](int cc0) {
    const int n = min(FV_CI, c - cc0);
    for (int ch = tid / xw, p = tid % xw; ch < n;) {
      const int pos = o0 - 8 + p;
      const bool inside = pos >= 0 && pos < t_len;
      vtt::cp_async4_zfill(xs + ch * xw + p, in + (size_t)(cc0 + ch) * t_len + (inside ? pos : 0),
                           inside);
      for (p += FV_THREADS; p >= xw; p -= xw) ++ch;
    }
    vtt::cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // one k8 step: the lane's hi and lo A quads of each of its m tiles from
  // the weight slab w, and its B pairs from Z rows g + 8 j of the warp's
  // time columns shifted by the tap ({hi(t), hi(t+4), lo(t), lo(t+4)});
  // three passes (lo.hi, hi.lo, hi.hi), so that consecutive MMAs update
  // different accumulators
  auto mma_step = [&](const float* w, int sub, int tap) {
    const float* wa = w + (warp_m * MT * 64 + lane) * 4;
    const float* zb = zs + ((size_t)sub * rows + warp_n * NT * 8 + tap * dil + g) * 16 + 4 * tq;
    float4 ahi[MT], alo[MT], b[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      ahi[i] = *reinterpret_cast<const float4*>(wa + i * 256);
      alo[i] = *reinterpret_cast<const float4*>(wa + i * 256 + 128);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = *reinterpret_cast<const float4*>(zb + j * 128);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) vtt::mma_tf32(acc[i][j], alo[i], b[j].x, b[j].y);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) vtt::mma_tf32(acc[i][j], ahi[i], b[j].z, b[j].w);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) vtt::mma_tf32(acc[i][j], ahi[i], b[j].x, b[j].y);
  };

  int q = 0;
  for (int c0 = 0; c0 < c; c0 += FV_CI) {
    const int nch = min(FV_CI, c - c0);
    if (prologue) {
      // x shares Z's space: every warp is past the last chunk's MMAs
      if (c0 > 0) __syncthreads();
      stage_x(c0);
      vtt::cp_async_wait<0>();
      __syncthreads();
      // both snake phases once a sample, on the zero-extended window (not
      // masked); two runs a thread at a time, for independent chains (a
      // thread without a second run repeats the last: the same values to
      // the same place).  i / nq by a float product: exact for these sizes.
      const int nq = rows / 4 + 2, nq_items = nch * nq;
      const float inv_nq = 1.0f / nq;
      for (int i0 = tid; i0 < nq_items; i0 += 2 * FV_THREADS) {
        const int i1 = min(i0 + FV_THREADS, nq_items - 1);
        const int ch0 = (int)((i0 + 0.5f) * inv_nq), ch1 = (int)((i1 + 0.5f) * inv_nq);
        const int r0 = i0 - ch0 * nq, r1 = i1 - ch1 * nq;
        float e0[4], f0[4], e1[4], f1[4];
        vtt::aa_phases4(xs + ch0 * xw + 4 * r0, taps, alpha[c0 + ch0], beta_recip[c0 + ch0],
                        e0, f0);
        vtt::aa_phases4(xs + ch1 * xw + 4 * r1, taps, alpha[c0 + ch1], beta_recip[c0 + ch1],
                        e1, f1);
        *reinterpret_cast<float4*>(ze + ch0 * ps + 4 * r0) = make_float4(e0[0], e0[1], e0[2], e0[3]);
        *reinterpret_cast<float4*>(zo + ch0 * ps + 4 * r0) = make_float4(f0[0], f0[1], f0[2], f0[3]);
        *reinterpret_cast<float4*>(ze + ch1 * ps + 4 * r1) = make_float4(e1[0], e1[1], e1[2], e1[3]);
        *reinterpret_cast<float4*>(zo + ch1 * ps + 4 * r1) = make_float4(f1[0], f1[1], f1[2], f1[3]);
      }
      // x is dead: Z may be written
      __syncthreads();
      // the AA output on [0, T), split, into Z in fragment order: channel ch
      // of a slab at 4 (ch & 3) + (ch >> 2), its lo plane 2 further; a warp
      // takes 8 channels x 4 runs, a thread two runs at a time
      const int nj = rows / 4, nj_items = nch / 8 * nj;
      const float inv_nj = 1.0f / nj;
      auto down_run = [&](int item) {
        const int sub = (int)((item + 0.5f) * inv_nj), j = item - sub * nj;
        const int ch8 = tid & 7, ch = sub * 8 + ch8;
        float e[12], o[12], v[4];
        vtt::load12(ze + ch * ps + 4 * j, e);
        vtt::load12(zo + ch * ps + 4 * j, o);
        vtt::aa_down4<false>(e, o, taps, v);
        float* zr = zs + ((size_t)sub * rows + 4 * j) * 16 + 4 * (ch8 & 3) + (ch8 >> 2);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pos = o0 + 4 * j + r;
          const float val = pos >= 0 && pos < t_len ? v[r] : 0.0f;
          const float hi = tf32_rna(val);
          zr[16 * r] = hi;
          zr[16 * r + 2] = tf32_rna(val - hi);
        }
      };
      for (int i0 = tid >> 3; i0 < nj_items; i0 += 2 * (FV_THREADS / 8)) {
        down_run(i0);
        down_run(min(i0 + FV_THREADS / 8, nj_items - 1));
      }
    }
    for (int tap = 0; tap < k; ++tap, ++q) {
      vtt::cp_async_wait<FV_STAGES - 2>();
      __syncthreads();
      load_stage();
      if (span == SPAN_PROLOGUE || span == SPAN_SKELETON) continue;
      const float* st = ring + (q % FV_STAGES) * STAGE;
      if (nch == FV_CI) {
        mma_step(st, 0, tap);
        mma_step(st + SLAB, 1, tap);
      } else {
        mma_step(st, 0, tap);
      }
    }
  }

  // the next pair may launch and put its weights in flight
  vtt::launch_dependents();

  // the epilogue: lane (g, tq) holds channels g, g + 8 of each m tile and
  // samples 2 tq, 2 tq + 1 of each n tile.  out may be res or acc_in (the
  // update is in place, each element read and written by its own lane), so
  // an m tile's loads are all issued before its stores: otherwise every
  // load would wait for the store before it.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float2 r[2][NT], a[2][NT];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (warp_m * MT + i) * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int t = t0 + (warp_n * NT + j) * 8 + 2 * tq;
        const size_t idx = (size_t)o * t_len + t;
        r[h][j] = a[h][j] = make_float2(0.0f, 0.0f);
        if (o >= c || t >= t_len) continue;
        if (vec2) {
          if (res != nullptr) r[h][j] = *reinterpret_cast<const float2*>(res + idx);
          if (acc_in != nullptr) a[h][j] = *reinterpret_cast<const float2*>(acc_in + idx);
        } else {
          if (res != nullptr) r[h][j].x = res[idx];
          if (acc_in != nullptr) a[h][j].x = acc_in[idx];
          if (t + 1 < t_len) {
            if (res != nullptr) r[h][j].y = res[idx + 1];
            if (acc_in != nullptr) a[h][j].y = acc_in[idx + 1];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (warp_m * MT + i) * 16 + g + 8 * h;
      if (o >= c) continue;
      const float bo = bias[o];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int t = t0 + (warp_n * NT + j) * 8 + 2 * tq;
        if (t >= t_len) continue;
        float v0 = acc[i][j][2 * h] + bo, v1 = acc[i][j][2 * h + 1] + bo;
        if (res != nullptr) {
          v0 = r[h][j].x + v0;
          v1 = r[h][j].y + v1;
        }
        if (acc_in != nullptr) {
          v0 = a[h][j].x + v0;
          v1 = a[h][j].y + v1;
        }
        const size_t idx = (size_t)o * t_len + t;
        if (vec2) {
          *reinterpret_cast<float2*>(out + idx) = make_float2(v0 * scale, v1 * scale);
        } else {
          out[idx] = v0 * scale;
          if (t + 1 < t_len) out[idx + 1] = v1 * scale;
        }
      }
    }
  }
}

using PairKernel = void (*)(const float*, const float*, const float*, const float*,
                            const float*, const float*, const float*, float*, int, int, int,
                            int, int, float, int, int, vtt::AATaps);

PairKernel pair_kernel(const StagePlan& p) {
#define FV_CASE(W, M) \
  if (p.wm == W && p.mt == M) return stage_pair_mma_kernel<W, M>;
  FV_CASE(1, 1) FV_CASE(1, 2) FV_CASE(1, 3) FV_CASE(2, 2) FV_CASE(2, 3) FV_CASE(4, 2)
  FV_CASE(4, 3)
#undef FV_CASE
  return nullptr;
}

}  // namespace

// The plan of one pair launch: out[8] = {bn, wm, mt, nt, ci, stages,
// threads, smem} (`plan_fused_stage`'s fields, in order).
VTT_EXPORT int vtt_fused_stage_plan(int c, int t, int k, int d, int* out) {
  StagePlan p;
  if (!plan_stage(c, t, k, d, &p)) return (int)cudaErrorInvalidValue;
  const int v[8] = {p.bn, p.wm, p.mt, p.nt, p.ci, p.stages, p.threads, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

// x, xb, y, out: (C, T) f32 contiguous (xb and y scratch); wk: (n, k_max,
// C / 8, CP / 16, 2, 32, 4) f32, the split slabs of `KernelPack` (CP the
// plan's padded channels); bias, alpha, beta_recip: (n, C) f32, with n = 2
// * n_blocks * n_iter pairs ordered block-major, then (convs1_m, convs2_m)
// per iteration.  Host arrays: kernel_sizes (n_blocks, odd, each block's
// own taps centred in k_max), dilations (n_iter), taps (12 floats
// [h_odd(6), h_even(6)]).  inv_nk = f32(1 / n_blocks).  span: SPAN_ALL, or
// a measurement arm.
VTT_EXPORT int vtt_fused_resblock_stage(
    const float* x, const float* wk, const float* bias, const float* alpha,
    const float* beta_recip, float* xb, float* y, float* out, int c, int t_len,
    int k_max, int n_blocks, int n_iter, const int* kernel_sizes,
    const int* dilations, const float* taps_host, float inv_nk, int span, void* stream) {
  if (c < 1 || t_len < 1 || n_blocks < 1 || n_iter < 1 || span < SPAN_ALL || span > SPAN_SKELETON)
    return (int)cudaErrorInvalidValue;
  const vtt::AATaps taps = vtt::aa_taps(taps_host);
  const cudaStream_t s = (cudaStream_t)stream;
  // 8-byte epilogue loads and stores: every row starts 8-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xb) |
                          reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out);
  const int vec2 = t_len % 2 == 0 && bases % 8 == 0;
  for (int j = 0; j < n_blocks; ++j) {
    const int k = kernel_sizes[j];
    if (k < 1 || k % 2 == 0 || k > k_max) return (int)cudaErrorInvalidValue;
    for (int m = 0; m < n_iter; ++m) {
      const int p = j * 2 * n_iter + 2 * m;
      const float* src = m == 0 ? x : xb;
      // the first conv (dilation d) writes y; the second adds into xb, or,
      // after the last dilation, into the blocks' running sum (scaled by
      // 1 / nk after the last block)
      const bool last = m == n_iter - 1;
      for (int h = 0; h < 2; ++h) {
        const int d = h == 0 ? dilations[m] : 1;
        StagePlan plan;
        if (!plan_stage(c, t_len, k, d, &plan)) return (int)cudaErrorInvalidValue;
        const PairKernel kernel = pair_kernel(plan);
        if (kernel == nullptr) return (int)cudaErrorInvalidValue;
        cudaError_t e = vtt::allow_dynamic_smem((const void*)kernel, plan.smem);
        if (e != cudaSuccess) return (int)e;
        const int q = p + h;
        const size_t pair_floats = (size_t)k_max * (c / 8) * (16 * plan.wm * plan.mt) * 16;
        e = vtt::launch_pdl(
            kernel, dim3((t_len + plan.bn - 1) / plan.bn), dim3(plan.threads), plan.smem, s,
            h == 0 ? src : y, alpha + (size_t)q * c, beta_recip + (size_t)q * c,
            wk + q * pair_floats, bias + (size_t)q * c, h == 0 ? nullptr : src,
            h == 1 && last && j > 0 ? out : nullptr, h == 0 ? y : last ? out : xb, c, t_len,
            k, (k_max - k) / 2, d, h == 1 && last && j == n_blocks - 1 ? inv_nk : 1.0f, span,
            vec2, taps);
        if (e != cudaSuccess) return (int)e;
      }
    }
  }
  return (int)cudaSuccess;
}
