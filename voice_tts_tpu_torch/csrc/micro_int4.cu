// K13: the int4 tile-stream micro-benchmark with a row carried from tile to
// tile.
//
// Replaces: scripts/micro_int4.py `run` (Pallas kernel `make_kernel`): x
// (8, D) f32, T int4-packed tiles w (T, D/2, D) int8 (byte k of a column
// holds contraction row k in its low nibble, row k + D/2 in its high one;
// 236 MB at 288 tiles of D 1280), group scales gs (2 per_half, D) f32.  For
// each tile in order acc[0] <- 0.5 acc[0] + 1e-6 y(acc[0], w[t]); rows 1-7
// stay x.  Each mode is one template instance (see
// voice_tts_tpu_torch/ops/micro_int4.py for the unpack and scaling of each).
//
// Bound on the H100: device memory, T * D * D / 2 weight bytes over 3.35
// TB/s (0.070 ms at the defaults); the unpack and dots are a few operations
// a byte.
//
// Design.  Tile t's product reads the whole row that tile t - 1 wrote, so
// the tiles cannot spread over the card as K12's do; one block walking all
// tiles would stream 236 MB through one SM.  One persistent cooperative
// launch instead: block (cs, ks) owns a 128-column slice and a 64-row slice
// of the packed contraction (100 blocks at D 1280; 64 divides every group,
// so a block's rows lie in one scale group in every mode).  It streams its
// (64, 128) slab of each tile through a 4-stage cp.async ring and issues
// the loads of later tiles before it waits for the carried row: the
// weights do not depend on x, so the stream overlaps the exchange.  A
// tile: the block's partial (its rows' scaled sub-dots, summed across
// warps) goes to the tile's slab of partials in device memory; then every
// block adds the partials of the rows it reads next, in ks order, and
// updates its own copy of those carried values (the same arithmetic in
// every block, so the copies agree).
//
// The exchange waits for that dependence and nothing more.  Block (cs, ks)
// reads rows k0..k0+63 and D/2+k0..: they lie in column slices k0 / 128 and
// (D/2 + k0) / 128, each the sum of the n_ks partials of that slice's
// blocks, so it waits for 2 n_ks producers (20 at D 1280), not for all 100
// blocks as a grid barrier would.  A partial travels with its own flag:
// one 64-bit word, the f32 bits and the tile number + 1 above them,
// written with one relaxed gpu-scope store and polled with relaxed
// gpu-scope loads (single-copy atomic, read at the L2, never a stale L1
// line), so no fence or counter round trip sits between a producer's
// store and a consumer seeing it.  A reader polls its n_ks words together,
// round after round, until all carry the tile (polling them one after
// another cost a round trip each; polling one flag word a producer made
// every warp of the card hammer the same few lines).
// Slabs: a ring of kSlots (the wrapper zeroes it at each call: tags start
// at 1).  Slab t % kSlots is rewritten at tile t while no block still reads
// tile t - kSlots: a block writes tile t after reading tile t - 1 from its
// producers, each of which read t - 2 from theirs; the producers of any
// one column slice span every ks, whose rows span every column slice, so
// by then every block has written t - 2 and so has finished reading t - 3:
// 3 slabs suffice, 4 are kept (`exchange_plan` in ops/micro_int4.py holds
// this for each width).  Waiting needs every block on the card at once:
// the launch stays cooperative (refused, and the wrapper raises, for a grid
// the card cannot hold), and a poll that outlasts a few seconds traps
// instead of hanging.  `dma` (y = the tile's raw first byte row) has no
// dependence across columns: it runs no exchange and is the stream floor.
#include "common.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;      // columns a block owns
constexpr int kK = 64;          // packed rows (bytes) a block owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;      // 8 KB slabs in flight a block
constexpr int kSlots = 4;       // slabs of partials, a ring over the tiles
constexpr int kBatch = 16;      // partials a reader polls at once
constexpr long long kMaxPolls = 1ll << 24;   // seconds of polling: a fault

// A partial with its tag: one 64-bit word, the f32 bits below the tag.
__device__ __forceinline__ void publish(unsigned long long* at, float v, unsigned tag) {
  const unsigned long long word = ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(at), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long poll(const unsigned long long* at) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(word) : "l"(at) : "memory");
  return word;
}

// The sum, in order, of the n partials at col, col + d, ... once each
// carries `tag`: every round polls all the words not yet there at once, so
// the wait is one L2 round trip after the last producer's store.
__device__ __forceinline__ float gather(const unsigned long long* col, int d, int n,
                                        unsigned tag) {
  float y = 0.0f;
  for (int q0 = 0; q0 < n; q0 += kBatch) {
    unsigned long long word[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (q0 + j < n) word[j] = poll(col + (size_t)(q0 + j) * d);
    for (long long polls = 0;; ++polls) {
      bool there = true;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (q0 + j < n && (unsigned)(word[j] >> 32) != tag) there = false;
      if (there) break;
      if (polls == kMaxPolls) __trap();
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (q0 + j < n && (unsigned)(word[j] >> 32) != tag)
          word[j] = poll(col + (size_t)(q0 + j) * d);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (q0 + j < n) y += __uint_as_float((unsigned)word[j]);
  }
  return y;
}

enum Mode { kDma = 0, kCur = 1, kI8sh = 2, kG2 = 3, kDense = 4, kExpand = 5, kXp8 = 6 };

// byte j of a word -> its signed nibbles, by each mode's own unpack
template <int kMode>
__device__ __forceinline__ void unpack(unsigned word, int j, int& lo, int& hi) {
  if (kMode == kI8sh || kMode == kXp8) {
    // int8 shifts: lo = (b << 4) >> 4, hi = b >> 4 (arithmetic)
    const int8_t b = (int8_t)(word >> (8 * j));
    lo = (int8_t)(int8_t)(b << 4) >> 4;
    hi = b >> 4;
  } else {
    // int32 mask / xor of the sign-extended byte, arithmetic shift
    const int b = (int)(word << (24 - 8 * j)) >> 24;
    lo = ((b & 15) ^ 8) - 8;
    hi = b >> 4;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
micro_int4_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ gs, unsigned long long* __restrict__ slots,
                  float* __restrict__ out, int n_tiles, int d, int per_half) {
  __shared__ __align__(16) int8_t ring[kStages][kK][kCols];
  __shared__ float red[kWarps][2][kCols];
  __shared__ float carried[2 * kK];    // acc[0] at the rows this block reads
  __shared__ float xb[2 * kK];         // the same rounded to bf16
  __shared__ float scale[2][kCols];    // this block's low / high scale rows

  const int half = d / 2, n_cs = d / kCols, n_ks = half / kK;
  const int cs = blockIdx.x % n_cs, ks = blockIdx.x / n_cs;
  const int col0 = cs * kCols, k0 = ks * kK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the block's scale rows: its rows lie in one group of every mode
  int i_lo, i_hi;
  if (kMode == kDense) {
    i_lo = i_hi = 0;
  } else {
    const int nph = kMode == kG2 ? 2 : per_half;       // expand: per_half groups
    const int g = k0 / (half / nph);
    const int i0 = (kMode == kExpand || kMode == kXp8) ? g : g * (per_half / nph);
    i_lo = i0;
    i_hi = per_half + i0;
  }
  if (tid < kCols) {
    scale[0][tid] = gs[(size_t)i_lo * d + col0 + tid];
    scale[1][tid] = gs[(size_t)i_hi * d + col0 + tid];
  }
  // carried row index of slot i: lo rows k0.., then hi rows half + k0..
  auto row_of = [&](int i) { return i < kK ? k0 + i : half + k0 + i - kK; };
  if (tid < 2 * kK) {
    carried[tid] = x[row_of(tid)];
    xb[tid] = vtt::round_bf16(carried[tid]);
  }
  float dma_acc = tid < kCols ? x[col0 + tid] : 0.0f;   // dma: ks == 0 blocks

  auto load = [&](int t) {
    if (t < n_tiles) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int seg = tid + q * kThreads;              // 512 16-byte pieces
        const int row = seg >> 3, off = (seg & 7) * 16;
        vtt::cp_async16(&ring[t % kStages][row][off],
                        w + ((size_t)t * half + k0 + row) * d + col0 + off);
      }
    }
    vtt::cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  for (int t = 0; t < n_tiles; ++t) {
    vtt::cp_async_wait<kStages - 2>();
    __syncthreads();
    load(t + kStages - 1);          // later tiles stream across the exchange
    const int8_t(*slab)[kCols] = ring[t % kStages];

    if (kMode == kDma) {
      if (ks == 0 && tid < kCols)
        dma_acc = __fadd_rn(__fmul_rn(dma_acc, 0.5f),
                            __fmul_rn((float)slab[0][tid], 1e-6f));
      continue;
    }

    // the warp's 8 rows, the lane's 4 columns: sub-dots of the low and the
    // high nibbles with bf16(acc[0]), f32 sums (the products are exact)
    float slo[4] = {0.0f, 0.0f, 0.0f, 0.0f}, shi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      const unsigned word = *reinterpret_cast<const unsigned*>(&slab[r][lane * 4]);
      const float xl = xb[r], xh = xb[kK + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int lo, hi;
        unpack<kMode>(word, j, lo, hi);
        if (kMode == kExpand || kMode == kXp8) {
          // dequantized in f32, cast to bf16, then the dense dot
          const float wl = vtt::round_bf16((float)lo * scale[0][lane * 4 + j]);
          const float wh = vtt::round_bf16((float)hi * scale[1][lane * 4 + j]);
          slo[j] = fmaf(xl, wl, slo[j]);
          shi[j] = fmaf(xh, wh, shi[j]);
        } else {
          slo[j] = fmaf(xl, (float)lo, slo[j]);
          shi[j] = fmaf(xh, (float)hi, shi[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[warp][0][lane * 4 + j] = slo[j];
      red[warp][1][lane * 4 + j] = shi[j];
    }
    __syncthreads();
    unsigned long long* parts = slots + (size_t)(t % kSlots) * n_ks * d;
    const unsigned tag = (unsigned)t + 1;
    if (tid < kCols) {
      float plo = 0.0f, phi = 0.0f;
      for (int g = 0; g < kWarps; ++g) {
        plo += red[g][0][tid];
        phi += red[g][1][tid];
      }
      float p;
      if (kMode == kDense) {
        p = (plo + phi) * scale[0][tid];
      } else if (kMode == kExpand || kMode == kXp8) {
        p = plo + phi;
      } else {
        p = plo * scale[0][tid] + phi * scale[1][tid];
      }
      publish(parts + (size_t)ks * d + col0 + tid, p, tag);
    }
    // y at the rows this block reads next: the partials in ks order, each
    // once its producer has written this tile's
    if (tid < 2 * kK) {
      const float y = gather(parts + row_of(tid), d, n_ks, tag);
      carried[tid] = __fadd_rn(__fmul_rn(carried[tid], 0.5f), __fmul_rn(y, 1e-6f));
      xb[tid] = vtt::round_bf16(carried[tid]);
    }
  }
  vtt::cp_async_wait<0>();

  // row 0: the carried values (dma: the column slices of the ks == 0
  // blocks; otherwise each row from the cs == 0 block that carries it);
  // rows 1-7: x, copied by the ks == 0 blocks
  if (kMode == kDma) {
    if (ks == 0 && tid < kCols) out[col0 + tid] = dma_acc;
  } else if (cs == 0 && tid < 2 * kK) {
    out[row_of(tid)] = carried[tid];
  }
  if (ks == 0) {
    for (int i = tid; i < (kRows - 1) * kCols; i += kThreads) {
      const size_t at = (size_t)(1 + i / kCols) * d + col0 + i % kCols;
      out[at] = x[at];
    }
  }
}

template <int kMode>
cudaError_t launch(const float* x, const int8_t* w, const float* gs,
                   unsigned long long* slots, float* out, int n_tiles, int d, int per_half,
                   cudaStream_t stream) {
  const int n_blocks = (d / kCols) * (d / 2 / kK);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, micro_int4_kernel<kMode>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (n_blocks > sms * per_sm) return cudaErrorCooperativeLaunchTooLarge;
  if (kMode != kDma) {
    // tags start at 1: the ring holds none before the first tile
    err = cudaMemsetAsync(slots, 0, sizeof(*slots) * kSlots * (d / 2 / kK) * d, stream);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {(void*)&x, (void*)&w, (void*)&gs, (void*)&slots, (void*)&out,
                  (void*)&n_tiles, (void*)&d, (void*)&per_half};
  return cudaLaunchCooperativeKernel((const void*)micro_int4_kernel<kMode>, dim3(n_blocks),
                                     dim3(kThreads), args, 0, stream);
}

}  // namespace

// x: (8, d) f32; w: (n_tiles, d / 2, d) int8, d % 256 == 0; gs:
// (2 per_half, d) f32; slots: (kSlots, d / 128, d) 64-bit scratch (zeroed
// here); out: (8, d) f32.  mode: 0 dma, 1 cur, 2 i8sh, 3 g2, 4 dense, 5
// expand, 6 xp8.
VTT_EXPORT int vtt_micro_int4(const float* x, const int8_t* w, const float* gs,
                              void* scratch, float* out, int mode, int n_tiles, int d,
                              int per_half, void* stream) {
  unsigned long long* slots = static_cast<unsigned long long*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (mode) {
    case kDma: err = launch<kDma>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    case kCur: err = launch<kCur>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    case kI8sh: err = launch<kI8sh>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    case kG2: err = launch<kG2>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    case kDense: err = launch<kDense>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    case kExpand: err = launch<kExpand>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    case kXp8: err = launch<kXp8>(x, w, gs, slots, out, n_tiles, d, per_half, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
