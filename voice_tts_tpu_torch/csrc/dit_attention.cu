// C entries of K9 (key-length-masked DiT attention) and K11 (segment-id
// masked DiT attention).  bf16 inputs run the tensor-core kernel of
// dit_attention_mma.cuh; f32 inputs the CUDA-core kernel of
// dit_attention.cuh.  Each header holds its kernel's design and bound; the
// K8 block chain (dit_blocks.cu) runs the tensor-core one.
#include "dit_attention_mma.cuh"

namespace {

vtt::AttnArgs make_args(const void* q, const void* k, const void* v, void* o,
                        const int* strides, int heads, int t_len, float scale) {
  vtt::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_st = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_st = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_st = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_st = strides[11];
  a.heads = heads;
  a.t_len = t_len;
  a.scale = scale;
  return a;
}

}  // namespace

// K9.  q, k, v, o: (B, H, T, 64) views, bf16 (is_bf16 = 1) or f32, head dim
// contiguous (bf16: 16-byte-aligned bases, strides multiples of 8 elements);
// `strides` (host, 12 ints): the (batch, head, time) element strides of q,
// k, v, o in that order; lens: (B,) int32 valid keys.
VTT_EXPORT int vtt_cfm_attention(const void* q, const void* k, const void* v, void* o,
                                 const int* strides, const int* lens, int is_bf16,
                                 int batch, int heads, int t_len, float scale,
                                 void* stream) {
  vtt::AttnArgs a = make_args(q, k, v, o, strides, heads, t_len, scale);
  a.lens = lens;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16
                   ? vtt::launch_dit_attention_mma<vtt::MASK_LENS>(a, batch, s)
                   : vtt::launch_dit_attention<float, vtt::MASK_LENS>(a, batch, s));
}

// K11.  As K9, with q_seg, kv_seg: (B, T) int32 segment ids instead of lens.
VTT_EXPORT int vtt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   const int* strides, const int* q_seg,
                                   const int* kv_seg, int is_bf16, int batch, int heads,
                                   int t_len, float scale, void* stream) {
  vtt::AttnArgs a = make_args(q, k, v, o, strides, heads, t_len, scale);
  a.q_seg = q_seg;
  a.kv_seg = kv_seg;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16
                   ? vtt::launch_dit_attention_mma<vtt::MASK_SEG>(a, batch, s)
                   : vtt::launch_dit_attention<float, vtt::MASK_SEG>(a, batch, s));
}
