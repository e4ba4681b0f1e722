// f32 masked full (non-causal) attention of the DiT on the tensor cores: the
// f32 branch of K9 and K11, as three split-TF32 passes.  What it replaces,
// the masks and the shared softmax step: dit_attention.cuh.
//
// Numerics: f32-class.  TF32 alone keeps 10 mantissa bits of q and k, which
// would break the f32 tolerance (1e-4 of max|ref| against the plain
// version).  So each f32 operand v is split into hi = tf32(v) and lo =
// tf32(v - hi), and a product accumulates lo.hi + hi.lo + hi.hi in f32, as
// K10 does (fused_vocoder.cu).  Here both parts are truncated to TF32 (the
// 13 low mantissa bits cleared, `split_tf32`): hi + lo is v within 2^-20 of
// |v|, and what lo.lo would add is below 2^-20 of the product.  Both
// products are split: S = Q K^T, and P V with the unnormalized
// probabilities kept in f32, as the plain versions keep them for f32 v.
// ops/cfm_attention.py `cfm_attention_split_plain` and
// ops/flash_attention.py `flash_attention_split_plain` model this
// arithmetic on the CPU.
//
// Bound: operations.  QK^T and PV are 4 * T_attended * hd operations a
// (query row, head); three TF32 passes of them at 495 TFLOP/s, against
// 2-20 MB of f32 q, k, v and output at the DiT's shapes (B 2, H 8, hd 64,
// T 704-3104): at T 3104 with K9's lens (3000, 2100) 0.197 ms as three
// passes (0.484 ms for the same work in f32 on the CUDA cores).
//
// Design (the hopper-kernels guide, sections 1 and 4):
// - one block of 4 warps per (64 query rows, batch * head); a warp owns 16
//   rows.  mma.sync m16n8k8 tf32 (wgmma's TF32 form wants both operands
//   K-major, and V's rows are not: later work);
// - the k index of each product is renumbered so that no operand needs a
//   shuffle or a transpose.  QK^T: k-step 2p + s takes head dims 16p + 4t
//   + 2s (k index t) and 16p + 4t + 2s + 1 (k index t + 4), so one 16-byte
//   load of a Q or K row (dims 16p + 4t .. + 3) holds a lane's operands for
//   two k-steps.  The Q tile is loaded from device memory once, split into
//   hi and lo and kept in registers as A fragments for the whole key loop
//   (64 registers).  PV: S's accumulator holds keys 2t and 2t + 1 of each
//   8-key n-tile, so PV's k index t is key 2t and t + 4 is key 2t + 1: S's
//   accumulators are P's A fragment as they lie.  PV's n index g of n-tile
//   nd is head dim 8g + nd, so a lane's B operands for all 8 n-tiles are
//   two 16-byte loads of each of its two V rows, and its accumulators hold
//   dims 16t .. 16t + 15 of its two rows: the epilogue writes them to
//   device memory as four 16-byte stores a row;
// - K and V tiles of 64 keys x 64 dims f32 (16 KB each) go through a
//   2-stage cp.async ring (16 bytes a thread, rows past T zero-filled, so
//   no stale NaN meets a zero P); tile j + 1's copy starts before tile j's
//   math, one barrier a tile.  The 16-byte chunks of each row are
//   XOR-swizzled (`swz_k`, `swz_v`) so that each quarter-warp's B-fragment
//   reads fall in 8 distinct bank groups;
// - K and V are split into hi and lo on the way into registers, not once
//   into shared memory: the ring then holds one copy of each tile (66 KB a
//   block), and the reads stay at 32 16-byte loads a lane a tile, where
//   split copies would double them and the ring (to 128 KB, one block a
//   SM).  The price is the split done by each of the 4 warps, 3
//   instructions an element by truncation; `cvt.rna.tf32.f32` (K10's
//   rounding) takes a slower pipe, and its two an element cost more than
//   the two extra passes' MMAs (K9 at T 3104 on an H100: 0.85 ms with it,
//   0.55 with the truncating split);
// - 2 blocks a SM (217-220 registers a thread, no spills).  Q's fragments
//   in shared memory instead of registers (180 registers), or 32-key tiles
//   at 3 blocks a SM (137 registers), ran no faster on the H100: the 384
//   mma.sync a warp and tile (~6.5 cycles each at the margin) and the
//   softmax, which does not overlap them, set the pace;
// - `softmax_tile` (dit_attention.cuh): scale, mask, the ragged edge and
//   the online softmax in f32 registers; K9 stops its key loop at
//   ceil(lens[b] / 64) tiles (`key_tiles`).
// Left for later: wgmma (V transposed), softmax overlapped with the next
// tile's MMAs across warps, TMA, persistent blocks.
//
// The wrapper (ops/cfm_attention.py `check_qkv`) guarantees what the
// 16-byte copies and loads need: 16-byte-aligned bases and (batch, head,
// time) strides that are multiples of 4 elements.
#pragma once

#include "dit_attention.cuh"

namespace vtt {
namespace {

constexpr int TF_BQ = 64;          // query rows a block (16 a warp)
constexpr int TF_THREADS = 128;
constexpr int TF_TILE = ATT_BK * ATT_HD;   // floats of one 16 KB tile

struct Tf32Smem {
  float k[2][TF_TILE];
  float v[2][TF_TILE];
  int kv_seg[2][ATT_BK];            // MASK_SEG: the tile's key segment ids
};

// Float offset of 16-byte chunk `c` (0..15) of row `r` in a K tile: a
// quarter-warp reads rows 2i and 2i + 1 at 4 consecutive chunks, so odd
// rows swap their halves of 4 chunks.
__device__ __forceinline__ int swz_k(int r, int c) {
  return r * ATT_HD + ((c ^ ((r & 1) << 2)) << 2);
}
// In a V tile: a quarter-warp reads rows 8kk + 2t (or + 1), t = 0..3, at
// chunks 2g + (0 or 1) for two consecutive g, so the four rows take the
// XOR masks 0, 1, 4, 5.
__device__ __forceinline__ int swz_v(int r, int c) {
  return r * ATT_HD + ((c ^ ((r & 4) | ((r >> 1) & 1))) << 2);
}

// Rows row0 .. row0 + 63 of a (T, 64) f32 view with time stride `st` into a
// swizzled tile (`swz_v` for V, else `swz_k`): 1024 chunks of 16 bytes, 8
// a thread.
template <bool IS_V>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long st, int row0,
                                              int t_len, int tid) {
#pragma unroll
  for (int i = 0; i < TF_TILE / 4 / TF_THREADS; ++i) {
    const int idx = tid + i * TF_THREADS;
    const int r = idx >> 4, c = idx & 15, t = row0 + r;
    const bool ok = t < t_len;
    cp_async16_zfill(dst + (IS_V ? swz_v(r, c) : swz_k(r, c)),
                     src + (ok ? (long)t * st + c * 4 : 0), ok);
  }
}

// Key tile j of K and V (and of the key segment ids) into ring stage j & 1.
template <int MASK>
__device__ __forceinline__ void load_kv_f32(Tf32Smem& sm, const float* kg, const float* vg,
                                            const int* kv_seg, long k_st, long v_st, int j,
                                            int t_len, int tid) {
  const int st = j & 1, k0 = j * ATT_BK;
  load_tile_f32<false>(sm.k[st], kg, k_st, k0, t_len, tid);
  load_tile_f32<true>(sm.v[st], vg, v_st, k0, t_len, tid);
  if (MASK == MASK_SEG && tid < ATT_BK) {
    const bool ok = k0 + tid < t_len;
    cp_async4_zfill(&sm.kv_seg[st][tid], kv_seg + (ok ? k0 + tid : 0), ok);
  }
}

// hi: v truncated to TF32's bits (the 13 low mantissa bits cleared); lo: v -
// hi (exact in f32) truncated alike.  hi + lo is v within 2^-20 of |v|, and
// the dropped lo.lo is below 2^-20 of the product.  Two logic ops and one
// FP32 subtraction: `cvt.rna.tf32.f32` runs on a slower pipe, and two of
// them an element cost more than the three passes' MMAs.
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
  lo = __uint_as_float(__float_as_uint(__fsub_rn(v, hi)) & 0xFFFFE000u);
}

__device__ __forceinline__ void split_tf32(const float4& v, float4& hi, float4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

// Component i (0..3, a constant after unrolling) of v.
__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d[n] += a b[n] over 8 n-tiles in three TF32 passes (lo.hi, hi.lo,
// hi.hi): a = (ah, al) one A quad, b[n] = (bh[n], bl[n]) the B pairs, each
// split.  A pass covers the 8 n-tiles before the next, so a chain of
// dependent mma.sync on one accumulator is 8 instructions apart.
__device__ __forceinline__ void mma_tf32x3(float (&d)[8][4], const float4& ah, const float4& al,
                                           const float (&bh)[8][2], const float (&bl)[8][2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) mma_tf32(d[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
}

template <int MASK>
__global__ void __launch_bounds__(TF_THREADS, 2) dit_attention_tf32_kernel(const AttnArgs a) {
  extern __shared__ float4 tf32_smem[];
  Tf32Smem& sm = *reinterpret_cast<Tf32Smem*>(tf32_smem);
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * TF_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row and column
  const int t_len = a.t_len;
  const float* qg = static_cast<const float*>(a.q) + (long)b * a.q_sb + (long)h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + (long)b * a.k_sb + (long)h * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + (long)b * a.v_sb + (long)h * a.v_sh;
  float* og = static_cast<float*>(a.o) + (long)b * a.o_sb + (long)h * a.o_sh;
  const int* kv_seg = MASK == MASK_SEG ? a.kv_seg + (long)b * t_len : nullptr;

  const int n_valid = MASK == MASK_LENS ? a.lens[b] : 0;
  const int n_tiles = key_tiles<MASK>(t_len, n_valid);

  load_kv_f32<MASK>(sm, kg, vg, kv_seg, a.k_st, a.v_st, 0, t_len, tid);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;      // this lane's rows: row0, row0 + 8
  int my_seg[2];
  query_segments<MASK>(my_seg, a, b, row0);

  // Q's A fragments, hi and lo: k-step 2p + s is (rows g, g + 8) x (dims
  // 16p + 4t + 2s, + 1); rows past T are zero
  float4 qh[8], ql[8];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float4 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      x[r] = t < t_len ? *reinterpret_cast<const float4*>(qg + (long)t * a.q_st + 16 * p + 4 * tq)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    split_tf32(make_float4(x[0].x, x[1].x, x[0].y, x[1].y), qh[2 * p], ql[2 * p]);
    split_tf32(make_float4(x[0].z, x[1].z, x[0].w, x[1].w), qh[2 * p + 1], ql[2 * p + 1]);
  }

  float o[8][4];              // O: n-tile nd, column n is dim 8n + nd; rows g, g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();    // tile j landed; every warp is done with tile j - 1's buffers
    if (j + 1 < n_tiles) {
      load_kv_f32<MASK>(sm, kg, vg, kv_seg, a.k_st, a.v_st, j + 1, t_len, tid);
      cp_async_commit();
    }
    const float* ks = sm.k[j & 1];
    const float* vs = sm.v[j & 1];

    // S = Q K^T: 16 rows x 64 keys a warp; n-tile n's B pair is key 8n + g.
    // Each pass runs over the 8 n-tiles before the next, so that a chain of
    // dependent mma.sync on one accumulator is 8 instructions apart
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float4 kr[8];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        kr[n] = *reinterpret_cast<const float4*>(ks + swz_k(8 * n + g, 4 * p + tq));
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {     // k-step 2p + hs: dims (x, y), then (z, w)
        float bh[8][2], bl[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          split_tf32(hs ? kr[n].z : kr[n].x, bh[n][0], bl[n][0]);
          split_tf32(hs ? kr[n].w : kr[n].y, bh[n][1], bl[n][1]);
        }
        mma_tf32x3(s, qh[2 * p + hs], ql[2 * p + hs], bh, bl);
      }
    }

    softmax_tile<MASK>(s, o, m, l, a, n_valid, j * ATT_BK, my_seg, sm.kv_seg[j & 1], tq);

    // O += P V: k-step kk is keys 8kk + 2t (k index t) and + 1 (t + 4), so
    // S's n-tile kk is the A quad (rows g, g + 8 at t, then at t + 4)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float4 ph, pl;
      split_tf32(make_float4(s[kk][0], s[kk][2], s[kk][1], s[kk][3]), ph, pl);
      const int r = 8 * kk + 2 * tq;
      float4 v[2][2];     // rows r and r + 1, dims 8g .. 8g + 3 and 8g + 4 .. 8g + 7
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[e][c] = *reinterpret_cast<const float4*>(vs + swz_v(r + e, 2 * g + c));
      float bh[8][2], bl[8][2];
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(lane_of(v[e][nd >> 2], nd & 3), bh[nd][e], bl[nd][e]);
      mma_tf32x3(o, ph, pl, bh, bl);
    }
  }

  // epilogue: a lane holds dims 16t .. 16t + 15 of its two rows: O / l in
  // four 16-byte stores a row, rows >= T skipped
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = inv_row_sum(l[r]);
    const int t = row0 + 8 * r;
    if (t < t_len) {
      float4* dst = reinterpret_cast<float4*>(og + (long)t * a.o_st + 16 * tq);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 2 * r + (c >> 1), n0 = 4 * (c & 1);
        dst[c] = make_float4(o[n0][e] * inv, o[n0 + 1][e] * inv, o[n0 + 2][e] * inv,
                             o[n0 + 3][e] * inv);
      }
    }
  }
}

// Launch on `stream`; returns the launch's error.  66 KB of dynamic shared
// memory a block, above the 48 KB default, so the kernel's limit is raised.
template <int MASK>
cudaError_t launch_dit_attention_tf32(const AttnArgs& a, int batch, cudaStream_t stream) {
  const cudaError_t e =
      allow_dynamic_smem((const void*)dit_attention_tf32_kernel<MASK>, sizeof(Tf32Smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.t_len + TF_BQ - 1) / TF_BQ, batch * a.heads);
  dit_attention_tf32_kernel<MASK><<<grid, TF_THREADS, sizeof(Tf32Smem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vtt
