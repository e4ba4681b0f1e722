"""The whole DiT block trunk of one velocity evaluation in one call, K8
(`voice_tts_tpu/ops/attic/dit_blocks.py`).

`dit_block_chain(x, pack, wb, cos, sin, x_lens, heads)` runs every block of
the trunk: x (B, T, D) f32; `pack` the bf16 block weights
(`pack_dit_blocks`); wb (L, 2, 2D) f32, one step's slice of
`pack_dit_tables`; cos / sin (T, hd) (`rope_tables`); x_lens (B,) the valid
KEY counts.  Returns (B, T, D) f32; rows at query positions >= x_lens are
junk, as on the einsum path.

Numerics are the JAX kernel's (`_kernel`): f32 residual; adaRMS as
x_hat * w' + b' with the RMSNorm scale folded into w' and eps 1e-5; every
product's left operand rounded to bf16 and accumulated in f32; q, k, v, the
attention context and the FFN input stored in bf16; keys masked at col >=
x_lens, p cast to bf16 before PV; SwiGLU over the three D-column tiles, each
partial added straight into the residual.  One departure: RoPE rotates each
interleaved pair in f32 with f32 tables, where the JAX kernel's `(q @ P) *
sin` permutation matmul (a lane swap Mosaic cannot express otherwise) sees
bf16-rounded q and bf16 cos / sin; that matmul and the zero-filled g1 tiles
are left out.

The packed layout is the CUDA kernel's, not the JAX (depth, 5, 3, D, D)
tile groups: `DiTPack` holds each block's Linear weights in their (out, in)
layout, bf16, with W1 and W3 rows interleaved so that one GEMM column pair
is (gate, up) of one FFN unit.

- `dit_block_chain_ref`: PyTorch ops (CPU; the reference on the card);
- `plan_dit_gemm`: the tile of each of the chain's GEMMs (the C launch
  applies the same rule, `vtt_dit_gemm_plan`);
- `csrc/dit_blocks.cu` (`vtt_dit_block_chain`): the hand-written chain of
  kernels, one C call per velocity evaluation, launched for CUDA tensors:
  per layer adaRMS, the QKV GEMM (RoPE epilogue), the tensor-core
  attention tile, Wo, adaRMS, W1 | W3 (SwiGLU epilogue), W2; the GEMMs on
  `wgmma` fed by TMA, the launches under programmatic dependent launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.cfm_attention import HEAD_DIM, cfm_attention_ref
from voice_tts_tpu_torch.ops.counters import LAUNCHES

EPS = 1e-5
GEMM_MIN_BLOCKS = 132   # the H100's SMs


class GemmTile(NamedTuple):
    bm: int
    bn: int
    blocks: int


def plan_dit_gemm(m: int, n: int, k: int) -> GemmTile:
    """The tile of one of the chain's (M, N, K) GEMMs: 128 x 128 (two
    warpgroups) where that launches at least GEMM_MIN_BLOCKS blocks, else
    64 x 64 (one warpgroup).  At B 2, T 704 (M 1408, D 512): QKV 128 x 128,
    132 blocks; W1 | W3 128 x 128, 264; Wo and W2 64 x 64, 176."""
    if n % 64 or k % 64 or m < 1:
        raise ValueError(f"plan_dit_gemm: N and K multiples of 64, got M {m}, N {n}, K {k}")
    if n % 128 == 0 and -(-m // 128) * (n // 128) >= GEMM_MIN_BLOCKS:
        return GemmTile(128, 128, -(-m // 128) * (n // 128))
    return GemmTile(64, 64, -(-m // 64) * (n // 64))


def dit_gemm_shapes(b: int, t: int, d: int) -> dict:
    """(M, N, K) of the chain's four GEMMs a layer at B rows of T frames."""
    m = b * t
    return {"qkv": (m, 3 * d, d), "wo": (m, d, d), "w13": (m, 6 * d, d),
            "w2": (m, d, 3 * d)}


class DiTPack(NamedTuple):
    """bf16 (out, in) weights of every block: wqkv (L, 3D, D), wo (L, D, D),
    w13 (L, 6D, D) with w13[:, 2i] = w1[:, i] and w13[:, 2i + 1] = w3[:, i],
    w2 (L, D, 3D)."""
    wqkv: torch.Tensor
    wo: torch.Tensor
    w13: torch.Tensor
    w2: torch.Tensor


def rope_tables(t_len: int, head_dim: int, base: float, device="cpu"):
    """Expanded interleaved RoPE tables cos, sin (T, head_dim) f32, shared by
    every head (the JAX `rope_tables`' first two; no pair-swap matrix).
    Cached per device: the CFM asks for the same tables at every step."""
    return _rope_tables(t_len, head_dim, float(base), str(torch.device(device)))


@functools.lru_cache(maxsize=32)
def _rope_tables(t_len: int, head_dim: int, base: float, device: str):
    half = head_dim // 2
    freqs = 1.0 / (base ** (np.arange(0, head_dim, 2)[:half] / head_dim))
    angles = np.outer(np.arange(t_len), freqs)
    cos = np.repeat(np.cos(angles), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(angles), 2, axis=1).astype(np.float32)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def can_fuse_dit(dcfg) -> bool:
    """The geometry the kernel takes: 64-wide heads and FFN inner width
    find_multiple(8D/3, 256) == 3D (D 256 and 512)."""
    d = dcfg.hidden_dim
    if d % dcfg.num_heads or d // dcfg.num_heads != HEAD_DIM:
        return False
    inner = d * 8 // 3
    inner = inner if inner % 256 == 0 else inner + 256 - inner % 256
    return inner == 3 * d


@torch.no_grad()
def pack_dit_blocks(dit) -> DiTPack:
    """Stack every block's matmul weights of the port's `DiT` into a
    `DiTPack` (bf16, on the module's device)."""
    blocks = [getattr(dit, f"block_{i}") for i in range(dit.cfg.depth)]
    d = dit.cfg.hidden_dim
    for blk in blocks:
        if blk.w1.weight.shape[0] != 3 * d:
            raise ValueError(f"dit_block_chain expects FFN inner == 3*D, got "
                             f"{blk.w1.weight.shape[0]}")

    def stack(fn):
        return torch.stack([fn(b).to(torch.bfloat16) for b in blocks]).contiguous()
    return DiTPack(
        wqkv=stack(lambda b: b.wqkv.weight),
        wo=stack(lambda b: b.wo.weight),
        w13=stack(lambda b: torch.stack([b.w1.weight, b.w3.weight], dim=1)
                  .reshape(6 * d, d)),
        w2=stack(lambda b: b.w2.weight))


@torch.no_grad()
def pack_dit_tables(dit, tables: dict) -> torch.Tensor:
    """Fold each block's inner RMSNorm scale into the step tables' adaLN
    weight halves: (S, depth, 2, 2D) f32, [..., 0, :] attention, [..., 1, :]
    FFN, each (w * rms_w | b).  `tables` is `DiT.step_tables(t_span)`."""
    per_block = []
    for i in range(dit.cfg.depth):
        blk = getattr(dit, f"block_{i}")
        out = []
        for norm, wb in zip((blk.attention_norm, blk.ffn_norm), tables["blocks"][i]):
            rms_w = norm.norm.weight.float()
            w, b = torch.chunk(wb[:, 0, :].float(), 2, dim=-1)
            out.append(torch.cat([w * rms_w, b], dim=-1))
        per_block.append(torch.stack(out))                         # (2, S, 2D)
    return torch.stack(per_block).permute(2, 0, 1, 3).contiguous()


def _bf(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ w^T for a bf16 (out, in) weight, accumulated in f32."""
    return _bf(a) @ w.float().t()


def _rope(z: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, b: int, t: int):
    """Rotate each interleaved (even, odd) pair of z (B*T, D) in f32."""
    zp = z.reshape(b, t, -1, 2)
    c = cos[None, :, 0::2].repeat(1, 1, z.shape[1] // cos.shape[1])
    s = sin[None, :, 0::2].repeat(1, 1, z.shape[1] // sin.shape[1])
    out = torch.stack([zp[..., 0] * c - zp[..., 1] * s,
                       zp[..., 1] * c + zp[..., 0] * s], dim=-1)
    return out.reshape(b * t, -1)


def dit_block_chain_ref(x: torch.Tensor, pack: DiTPack, wb: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor, x_lens: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """The kernel's function in PyTorch ops (see the module docstring)."""
    b, t, d = x.shape
    hd = d // heads
    h = x.reshape(b * t, d).float()
    lens = x_lens.to(x.device)

    def ada_rms(layer: int, kind: int) -> torch.Tensor:
        norm = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + EPS)
        return norm * wb[layer, kind, :d] + wb[layer, kind, d:]

    def heads_view(a: torch.Tensor) -> torch.Tensor:
        return a.to(torch.bfloat16).reshape(b, t, heads, hd).transpose(1, 2)

    for layer in range(pack.wqkv.shape[0]):
        qkv = _dot(ada_rms(layer, 0), pack.wqkv[layer])
        q, k, v = torch.split(qkv, d, dim=-1)
        ctx = cfm_attention_ref(heads_view(_rope(q, cos, sin, b, t)),
                                heads_view(_rope(k, cos, sin, b, t)),
                                heads_view(v), lens, hd ** -0.5)
        h = h + _dot(ctx.transpose(1, 2).reshape(b * t, d), pack.wo[layer])
        y = ada_rms(layer, 1)
        w13 = pack.w13[layer].reshape(3 * d, 2, d)
        for j in range(3):
            cols = slice(j * d, (j + 1) * d)
            gate = _dot(y, w13[cols, 0])
            gate = gate * torch.sigmoid(gate)
            up = _dot(y, w13[cols, 1])
            h = h + _dot(gate * up, pack.w2[layer][:, cols])
    return h.reshape(b, t, d)


def dit_block_chain_cuda(x, pack: DiTPack, wb, cos, sin, x_lens, heads: int,
                         pdl: bool = True):
    """Launch the chain; `pdl=False` launches every kernel in full stream
    order (a measurement arm: a profiler's kernel spans then do not
    overlap)."""
    b, t, d = x.shape
    n_layers = pack.wqkv.shape[0]
    if d % 64 or d // heads != HEAD_DIM:
        raise ValueError(f"dit_block_chain: D % 64 == 0 and head width {HEAD_DIM}, "
                         f"got D {d}, {heads} heads")
    want = {"wqkv": (n_layers, 3 * d, d), "wo": (n_layers, d, d),
            "w13": (n_layers, 6 * d, d), "w2": (n_layers, d, 3 * d)}
    for name, shape in want.items():
        w = getattr(pack, name)
        if tuple(w.shape) != shape or w.dtype != torch.bfloat16:
            raise ValueError(f"dit_block_chain: pack.{name} must be bf16 {shape}, "
                             f"got {w.dtype} {tuple(w.shape)}")
    if tuple(wb.shape) != (n_layers, 2, 2 * d) or tuple(cos.shape) != (t, HEAD_DIM):
        raise ValueError(f"dit_block_chain: wb {tuple(wb.shape)}, cos {tuple(cos.shape)}")
    dev = x.device
    x = x.float().contiguous()
    wb, cos, sin = (a.to(device=dev, dtype=torch.float32).contiguous()
                    for a in (wb, cos, sin))
    lens = x_lens.to(device=dev, dtype=torch.int32).contiguous()
    tensors = (x, *pack, wb, cos, sin, lens)
    for a in tensors:
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError(f"dit_block_chain: every input must be contiguous on {dev}")
        if a.data_ptr() % 16:
            raise ValueError("dit_block_chain: every input must be 16-byte aligned "
                             "(the weights are read by TMA)")
    m = b * t
    out = torch.empty_like(x)
    y = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    ctx = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    act = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    lib = build.kernels()
    LAUNCHES["dit_block_chain"] += 1
    lib.call("vtt_dit_block_chain", x.data_ptr(), out.data_ptr(),
             pack.wqkv.data_ptr(), pack.wo.data_ptr(), pack.w13.data_ptr(),
             pack.w2.data_ptr(), wb.data_ptr(), cos.data_ptr(), sin.data_ptr(),
             lens.data_ptr(), y.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
             act.data_ptr(), b, t, d, heads, n_layers, int(pdl), build.stream_handle(dev))
    return out


def dit_block_chain(x: torch.Tensor, pack: DiTPack, wb: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, x_lens: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D) f32 through every block (see the module
    docstring).  CPU tensors take the plain version; CUDA tensors launch the
    kernel chain."""
    if x.is_cuda:
        return dit_block_chain_cuda(x, pack, wb, cos, sin, x_lens, heads)
    if x.device.type != "cpu":
        raise ValueError(f"dit_block_chain: unsupported device {x.device}")
    return dit_block_chain_ref(x, pack, wb, cos, sin, x_lens, heads)
