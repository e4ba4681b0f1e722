// K8: the whole DiT block trunk of one velocity evaluation, one C call.
//
// Replaces voice_tts_tpu/ops/attic/dit_blocks.py `dit_block_chain` (all 13
// blocks in one pallas_call over a sequential (depth, 5) grid, the residual
// resident in VMEM).  On Hopper blocks run in no order on 132 SMs and the
// residual (B*T*D f32, 2.9 MB at B 2, T 704, D 512) does not fit one SM, so
// `vtt_dit_block_chain` loops over the layers on the given stream and
// launches, per layer:
//   1. adaRMS of the residual -> bf16 (`ada_rms_kernel`);
//   2. the QKV GEMM with RoPE in its epilogue -> bf16 q | k | v;
//   3. attention: the K9 device code (dit_attention.cuh) on the bf16 q, k, v;
//   4. the Wo GEMM adding into the residual;
//   5. adaRMS -> bf16, then the W1 | W3 GEMM with SiLU(gate) * up in its
//      epilogue -> bf16;
//   6. the W2 GEMM adding into the residual, its three 512-row contraction
//      tiles added one after another as the TPU kernel's SwiGLU partials.
// The residual stays in global memory (in the 50 MB L2 at these sizes); one
// ctypes call replaces the ~260 torch ops of an eager trunk evaluation.
//
// Numerics are the TPU kernel's: f32 residual, adaRMS as x_hat * w' + b'
// (RMSNorm scale folded into w', eps 1e-5), every product's left operand
// rounded to bf16 and accumulated in f32, q, k, v, the attention context and
// the FFN input stored in bf16.  RoPE rotates each interleaved (even, odd)
// pair in f32 with f32 cos / sin; the TPU kernel's `(q @ P) * sin` lane-swap
// matmul (a Mosaic workaround) saw bf16-rounded q and bf16 tables.
//
// Bound: operations.  Per layer 2 * B*T * D * 13 D multiply-adds in the
// GEMMs (about 125 GFLOP a trunk at B 2, T 704) against 17 MB of bf16
// weights.  The GEMM is a simple tensor-core tile: 64 x 64 output tiles of 4
// warps, mma.sync m16n8k16 bf16 with f32 accumulators, 32-deep K slices in
// a two-stage cp.async ring; wgmma and TMA are later work.
#include "dit_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int G_BM = 64, G_BN = 64, G_BK = 32;
constexpr int G_LD = G_BK + 8;   // smem row stride in bf16 (80 bytes): conflict-free fragments
constexpr int G_THREADS = 128;

enum { EPI_QKV_ROPE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

struct EpiArgs {
  bf16* out;            // QKV_ROPE: (M, N) bf16; SWIGLU: (M, N / 2) bf16
  float* resid;         // RESIDUAL: (M, N) f32, updated in place
  const float* cos;     // QKV_ROPE: (T, 64) f32, expanded per pair
  const float* sin;
  int t_len;            // QKV_ROPE: rows are (batch, time), time = row % t_len
  int rope_cols;        // QKV_ROPE: columns [0, rope_cols) are rotated (q | k)
  int ksplit;           // RESIDUAL: partial sums of this many K rows are added in order
};

using vtt::cp_async16;
using vtt::cp_async_commit;
using vtt::cp_async_wait;

__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// C[M, N] = A[M, K] W[N, K]^T with the epilogue EPI.  A: bf16 rows of `lda`;
// W: bf16 (N, K) row-major (a Linear's (out, in) layout).  N % 64 == 0,
// K % 32 == 0; rows past M are read clamped and never written.
template <int EPI>
__global__ void __launch_bounds__(G_THREADS)
    gemm_bf16_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W,
                     int M, int N, int K, const EpiArgs ep) {
  __shared__ __align__(16) bf16 As[2][G_BM][G_LD];
  __shared__ __align__(16) bf16 Ws[2][G_BN][G_LD];
  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.x * G_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tq = lane & 3;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int c = tid; c < G_BM * (G_BK / 8); c += G_THREADS) {
      const int row = c >> 2, col = (c & 3) * 8;
      const int src = min(m0 + row, M - 1);
      cp_async16(&As[stage][row][col], A + (size_t)src * lda + k0 + col);
      cp_async16(&Ws[stage][row][col], W + (size_t)(n0 + row) * K + k0 + col);
    }
  };

  float acc[2][4][4];
  float res[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = res[i][j][e] = 0.0f;
  if (EPI == EPI_RESIDUAL) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + wm + mi * 16 + g + 8 * hh;
          const int col = n0 + wn + ni * 8 + 2 * tq;
          if (row < M) {
            const float2 r = *reinterpret_cast<const float2*>(ep.resid + (size_t)row * N + col);
            res[mi][ni][2 * hh] = r.x;
            res[mi][ni][2 * hh + 1] = r.y;
          }
        }
  }

  const int nk = K / G_BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * G_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < G_BK; kk += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = ld32(&As[s][r][kk + 2 * tq]);
        a[mi][1] = ld32(&As[s][r + 8][kk + 2 * tq]);
        a[mi][2] = ld32(&As[s][r][kk + 2 * tq + 8]);
        a[mi][3] = ld32(&As[s][r + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        b[ni][0] = ld32(&Ws[s][n][kk + 2 * tq]);
        b[ni][1] = ld32(&Ws[s][n][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[ni][0], b[ni][1]);
    }
    __syncthreads();
    if (EPI == EPI_RESIDUAL && ((kt + 1) * G_BK) % ep.ksplit == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            res[i][j][e] += acc[i][j][e];
            acc[i][j][e] = 0.0f;
          }
    }
  }

  // accumulator (mi, ni, 2*hh + {0, 1}): row g + 8*hh, columns 2*tq and
  // 2*tq + 1 of the 16 x 8 tile: an (even, odd) column pair
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + mi * 16 + g + 8 * hh;
        const int col = n0 + wn + ni * 8 + 2 * tq;
        if (row >= M) continue;
        if (EPI == EPI_QKV_ROPE) {
          float x0 = acc[mi][ni][2 * hh], x1 = acc[mi][ni][2 * hh + 1];
          if (col < ep.rope_cols) {
            const int idx = (row % ep.t_len) * vtt::ATT_HD + (col % vtt::ATT_HD);
            const float c = ep.cos[idx], sn = ep.sin[idx];
            const float r0 = x0 * c - x1 * sn;
            const float r1 = x1 * c + x0 * sn;
            x0 = r0;
            x1 = r1;
          }
          store_bf16x2(ep.out + (size_t)row * N + col, x0, x1);
        } else if (EPI == EPI_RESIDUAL) {
          float2 r;
          r.x = res[mi][ni][2 * hh];
          r.y = res[mi][ni][2 * hh + 1];
          *reinterpret_cast<float2*>(ep.resid + (size_t)row * N + col) = r;
        } else {   // SWIGLU: (gate, up) of FFN column col / 2
          const float gate = acc[mi][ni][2 * hh], up = acc[mi][ni][2 * hh + 1];
          const float silu = gate / (1.0f + expf(-gate));
          ep.out[(size_t)row * (N / 2) + col / 2] = __float2bfloat16_rn(silu * up);
        }
      }
}

// adaRMS of the residual, one warp a row: y = bf16(x * rsqrt(mean(x^2) +
// eps) * w + b) with w, b the step's folded (D,) halves.
__global__ void __launch_bounds__(128)
    ada_rms_kernel(const float* __restrict__ x, const float* __restrict__ wb,
                   bf16* __restrict__ y, int M, int D) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float ss = 0.0f;
  for (int j = lane; j < D; j += 32) ss = fmaf(xr[j], xr[j], ss);
  ss = vtt::warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + 1e-5f);
  for (int j = lane; j < D; j += 32)
    y[(size_t)row * D + j] = __float2bfloat16_rn((xr[j] * r) * wb[j] + wb[D + j]);
}

template <int EPI>
cudaError_t gemm(const bf16* A, int lda, const bf16* W, int M, int N, int K,
                 const EpiArgs& ep, cudaStream_t stream) {
  const dim3 grid(N / G_BN, (M + G_BM - 1) / G_BM);
  gemm_bf16_kernel<EPI><<<grid, G_THREADS, 0, stream>>>(A, lda, W, M, N, K, ep);
  return cudaGetLastError();
}

}  // namespace

#define VTT_TRY(expr)                          \
  do {                                         \
    const cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// x: (B*T, D) f32 trunk input; out: (B*T, D) f32, the residual and result;
// wqkv: (L, 3D, D), wo: (L, D, D), w13: (L, 6D, D) with rows (w1[i], w3[i])
// interleaved, w2: (L, D, 3D), all bf16 (out, in); wb: (L, 2, 2D) f32 one
// step's folded adaRMS halves; cos, sin: (T, 64) f32; lens: (B,) int32 valid
// keys; y: (B*T, D), qkv: (B*T, 3D), ctx: (B*T, D), act: (B*T, 3D) bf16
// scratch.  D % 64 == 0, head width 64.
VTT_EXPORT int vtt_dit_block_chain(const float* x, float* out, const bf16* wqkv,
                                   const bf16* wo, const bf16* w13, const bf16* w2,
                                   const float* wb, const float* cos, const float* sin,
                                   const int* lens, bf16* y, bf16* qkv, bf16* ctx,
                                   bf16* act, int batch, int t_len, int dim, int heads,
                                   int layers, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int M = batch * t_len, D = dim;
  if (out != x)
    VTT_TRY(cudaMemcpyAsync(out, x, sizeof(float) * M * D, cudaMemcpyDeviceToDevice, stream));

  EpiArgs rope{};
  rope.out = qkv;
  rope.cos = cos;
  rope.sin = sin;
  rope.t_len = t_len;
  rope.rope_cols = 2 * D;
  EpiArgs wo_ep{};
  wo_ep.resid = out;
  wo_ep.ksplit = D;
  EpiArgs swiglu{};
  swiglu.out = act;
  EpiArgs w2_ep{};
  w2_ep.resid = out;
  w2_ep.ksplit = D;

  vtt::AttnArgs att{};
  att.q = qkv;
  att.k = qkv + D;
  att.v = qkv + 2 * D;
  att.o = ctx;
  att.q_sb = att.k_sb = att.v_sb = t_len * 3 * D;
  att.q_sh = att.k_sh = att.v_sh = vtt::ATT_HD;
  att.q_st = att.k_st = att.v_st = 3 * D;
  att.o_sb = t_len * D;
  att.o_sh = vtt::ATT_HD;
  att.o_st = D;
  att.lens = lens;
  att.heads = heads;
  att.t_len = t_len;
  att.scale = 1.0f / sqrtf((float)vtt::ATT_HD);

  const int rms_blocks = (M + 3) / 4;
  for (int l = 0; l < layers; ++l) {
    const float* wb_l = wb + (size_t)l * 4 * D;
    ada_rms_kernel<<<rms_blocks, 128, 0, stream>>>(out, wb_l, y, M, D);
    VTT_TRY(cudaGetLastError());
    VTT_TRY(gemm<EPI_QKV_ROPE>(y, D, wqkv + (size_t)l * 3 * D * D, M, 3 * D, D, rope, stream));
    VTT_TRY((vtt::launch_dit_attention<bf16, vtt::MASK_LENS>(att, batch, stream)));
    VTT_TRY(gemm<EPI_RESIDUAL>(ctx, D, wo + (size_t)l * D * D, M, D, D, wo_ep, stream));
    ada_rms_kernel<<<rms_blocks, 128, 0, stream>>>(out, wb_l + 2 * D, y, M, D);
    VTT_TRY(cudaGetLastError());
    VTT_TRY(gemm<EPI_SWIGLU>(y, D, w13 + (size_t)l * 6 * D * D, M, 6 * D, D, swiglu, stream));
    VTT_TRY(gemm<EPI_RESIDUAL>(act, 3 * D, w2 + (size_t)l * 3 * D * D, M, D, 3 * D, w2_ep,
                               stream));
  }
  return (int)cudaSuccess;
}
