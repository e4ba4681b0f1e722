"""Chip smoke test of the PyTorch + CUDA port (`voice_tts_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):

1. device check: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from `voice_tts_tpu_torch/csrc` (one
   nvcc per source, in parallel);
3. kernels: each hand-written kernel against its plain PyTorch version at
   the flagship shapes of the paths, with the tolerance printed, both timed
   with CUDA events, beside its bound (the bytes it must move over 3.35
   TB/s, or its operations over the peak rate, whichever is larger): K5,
   K10 (below), K2, K4 (a layer's four products on the unfused decode
   step at 1 and 3 rows, the entry's times that set at 1 row; and a grid
   of 1 / 8 / 32 rows at D 1280),
   K1 (bf16 cache; int8 KV at pos 300 and 1500), K3 (beam-3 through an
   ancestor table with int8 KV and with a bf16 cache, pos 1500; eight rows
   at their own positions, one of them 0), K7 (the int4 loader alone at the
   four GEMVs of a layer, beside `torch._weight_int4pack_mm`; the int4 K1
   chain at g128 and g640, pos 300; the int4 K3 chain at beam-3 through a
   table), K6 (the verify of K = 4 tokens at pos 300 and 1500);
4. micro-benchmark path: K12 (`micro_tile`, the int8 tile stream) and K13
   (`micro_int4`, the int4 stream with a carried row), every mode against
   its plain version at D 1280, 16 tiles (K12's dot8i with x past the int8
   range, K13 with scales at U(500, 2500)), then the entry points
   `voice_tts_tpu_torch.scripts.micro_tile` / `.micro_int4` at their
   defaults (D 1280, 288 tiles, 20 and 60 passes) with the counters from 0:
   one launch a pass, 160 a mode; then each plain version over 3 passes;
5. tiny engines: the tiny engine on the card against the same weights on
   the CPU, greedy, same CFM noise: one beam (K1), the production flags
   (beam-3 through K3, int8 KV, bf16 conditioning), spec decode with
   K = 4 (int4 drafts through K1 and K7, the verify through K6), the
   int4 decode pack (K1 with K7), K5 (below) and the vocoder flags;
6. production slice: the flagship engine (random weights) in the serving
   profile, the server default, behind the HTTP server in a background
   thread: GET /health, GET /debug/worker-info, three POST /tts, then one
   request under the CUDA profiler; the launch counters must show K3 once
   per beam decode step, K1 never, K2 109 times per vocode;
7. bench slice: the same with `--profile bench` (sampling, one beam): K1
   once per decode step, K3 never, K2 109 times per vocode;
8. spec slice: the bench configuration with `spec_decode_k = 4` (int4
   drafts, one int8 verify a round), three POST /tts and one profiled: K6
   once per round, three int4 K1 chains (K1 and K7) per round, K3 never,
   K2 109 times per vocode; prints the acceptance rate, the codes per round
   and the stage times beside the bench slice's.
9. DiT slice: the bench configuration with `use_bf16_s2mel`, the K8 trunk
   (`fused_blocks`) and K9 attention (`fused_attention`): a 2.5 s prompt
   twice (T 704: K8 once per velocity evaluation, 25 a request, no K9) and
   a 5 s prompt (T 896 > 768: K9 in every block, 325, no K8), K1 once per
   decode step, K2 109 times per vocode, one more request profiled at each
   T; prints the stage timers beside the bench slice's;
10. K11 engine: a second engine on the DiT slice's weights with
   `flash_attention` instead (K8 and K9 off): one request at the 5 s prompt,
   K11 325 times.
11. K5 slice: the bench configuration with `GPTConfig.pallas_decode_attention`
    (the unfused decode step: K5 attention, K4 projections) and
    `use_fused_vocoder` (stages 2-5 through K10), three POST /tts and one
    profiled: per request K5 24 and K4 96 times a decode step, K1 and K3
    never, K10 4 and K2 37 times a vocode; prints the stage timers beside
    the bench slice's;
12. K5 beam request: a second engine on the K5 slice's models in the
    production profile with `pallas_decode_attention` and a 512-code cap,
    one request (beam-3 through the eager arm, 511 steps): K5 24 and K4 96
    times a beam step, K3 and K1 never;
13. vocoder A/B: the production slice's BigVGAN vocodes one mel at 448 and
    2656 frames through the module path, packed, shared-activation and
    fused variants, each timed, with its difference from the module path.

The kernel phase also holds K9 and K11 (bf16 and f32, T 896 and 3104)
beside `F.scaled_dot_product_attention` with the same boolean mask, K8
(the 13-block trunk at B 2, T 704), K5 (bf16 and f32; B 1, Tmax 512,
length 343 and B 3, Tmax 2048, length 1571) beside
`F.scaled_dot_product_attention` on the live prefix, and K10 (the four
fused stages of the flagship BigVGAN at 448 frames); the tiny-engine phase
runs K9 and K11 whole requests, K8 on the s2mel stage with bf16 s2mel (D
256 DiT), `pallas_decode_attention` with one beam and with the production
flags (f32 GPT), the int8 + bf16 unfused step with K5 and with the einsum
attention (where the codes of card and CPU first differ), and each
vocoder flag.

The third-to-last stdout line repeats the card's name and power limit; the
second-to-last is the kernel JSON: under "kernels" every kernel, each with
its launch count from the path that runs it (K3 and K2 from the production
slice, K1 from the bench slice, K6 and K7 from the spec slice, K8 and K9
from the DiT slice, K11 from its engine, K5, K4 and K10 from the K5 slice,
K12 and K13 from the micro-benchmark path; `launches_by_path` has all
eight), its largest error against the plain version, both times, its bound
and `library_ms` (null where no one PyTorch call computes the function: K1,
K2, K3, K6, K8, K10, K12, K13; the K12 and K13 entries time one mode a
pass, `dot1` and `cur`, with every mode under `modes`; K4's is
`torch._weight_int8pack_mm` where the build has it, K7's
`torch._weight_int4pack_mm` at the loader's GEMVs, K5's, K9's and K11's
`F.scaled_dot_product_attention`).  The last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_check():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        import voice_tts_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable (run from the repo root): {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return torch, card


def cuda_time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_time_ms(torch, fn, iters: int):
    """CUDA-event time of one PyTorch library call that computes the same
    function as a kernel (a yardstick only: the port never calls it), or
    None where this PyTorch build has no CUDA implementation of it."""
    try:
        return cuda_time_ms(torch, fn, iters)
    except (NotImplementedError, RuntimeError) as e:
        print(f"library call unavailable: {str(e).splitlines()[0][:200]}")
        return None


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# H100 SXM data sheet: device memory rate and dense peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def bound(n_bytes: float, n_ops: float, op_type: str = "bf16") -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate for their type, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[op_type]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def pack_bytes(pack) -> int:
    """Bytes of a trunk pack that one step reads: the weight tiles, an int4
    pack's group scales, and of the (L, 28, D) f32 consts only the rows the
    chain reads: the biases 12-19 and 23, LN1/LN2 24-27, and beside int8
    tiles their dequant scales 0-8 (fc2's one scale is row 8).  Rows 9-11
    and 20-22 repeat fc2's scale or hold zeros, and an int4 pack's rows 0-11
    are zeros, kept for the JAX row layout."""
    n_layers, _, d = pack.consts.shape
    gscales = getattr(pack, "gscales", None)
    rows_read = 13 if gscales is not None else 22
    return (nbytes(pack.w, gscales)
            + n_layers * rows_read * d * pack.consts.element_size())


def readout_bytes(ro, nrows: int) -> int:
    """Bytes of the folded readout for the VOCAB real columns (the padded
    columns up to 12 tiles carry no logit): their int8 rows, scale and bias,
    the final LN, and nrows f32 logits written."""
    d = ro.w.shape[1]
    return VOCAB * (d + 8) + nbytes(ro.lnf) + nrows * VOCAB * 4


def decode_step_bound(torch, pack, ro, cache, scales, bias, pos, src=None,
                      rows=None, verify=False):
    """Bound of one decode step (K1, K3, K6, int8 or int4 pack): the pack's
    bytes a step reads (`pack_bytes`) and the readout's once, the cached k|v
    rows the step reads (one sequence's prefix for the verify; each row's
    own prefix, or through an ancestor table the distinct (cache row,
    position) pairs it names), their int8 scales, the bias and table entries
    read, the inputs and outputs; operations 2 per weight's multiply-add per
    row plus attention."""
    n_layers, _, cb, _, d = cache.shape
    nrows = rows if rows is not None else cb
    pos_b = [int(p) for p in (pos.tolist() if isinstance(pos, torch.Tensor)
                              else [pos] * (1 if verify else cb))]
    if verify:
        cached = pos_b[0]
    elif src is not None:
        p = pos_b[0]
        head = src[:, :p].sort(dim=0).values
        cached = int(((head[1:] != head[:-1]).sum(dim=0) + 1).sum()) if p else 0
    else:
        cached = sum(pos_b)
    # one cached k or v row: D values, plus its f32 scale beside an int8 cache
    per_row = cache.element_size() * d + (4 if scales is not None else 0)
    kv_out = 4 if scales is not None else cache.element_size()
    n_bytes = (pack_bytes(pack) + (readout_bytes(ro, nrows) if ro is not None else 0)
               + n_layers * 2 * cached * per_row
               + 4 * (pos_b[0] if verify else sum(pos_b))        # bias
               + (4 * sum(pos_b) if src is not None else 0)      # table
               + nrows * d * 4 * 2                               # x, hidden
               + n_layers * 2 * nrows * d * kv_out)              # kv_new
    macs = n_layers * 12 * d * d + (VOCAB * d if ro is not None else 0)
    # q.k and p.v: 4 operations per value of each attended position
    attended = (nrows * pos_b[0] + nrows * (nrows + 1) // 2 if verify
                else sum(pos_b) + nrows)
    return bound(n_bytes, 2 * nrows * macs + 4 * n_layers * d * attended)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def random_trunk(torch, dev, seed: int):
    """A random int8 pack and readout at the flagship widths (L 24, D 1280,
    vocab 8194), scaled like a quantized GPT-2."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    L, D, V = 24, 1280, 8194
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    w = torch.randint(-127, 128, (L, 12, D, D), generator=g, device=dev,
                      dtype=torch.int8)
    consts = torch.zeros((L, 28, D), device=dev)
    consts[:, 0:12] = 0.02 * 3 / 127 * (1 + 0.1 * randn(L, 12, D)).abs()
    consts[:, 9:12] = consts[:, 8:9]             # one fc2 scale (pack_gpt)
    consts[:, 12:23] = randn(L, 11, D, std=0.02)
    consts[:, 20:23] = 0.0                       # fc2 partial biases
    consts[:, 24] = 1 + randn(L, D, std=0.05)
    consts[:, 25] = randn(L, D, std=0.02)
    consts[:, 26] = 1 + randn(L, D, std=0.05)
    consts[:, 27] = randn(L, D, std=0.02)
    state = {"mel_head.weight": randn(V, D, std=0.02),
             "mel_head.bias": randn(V, std=0.02),
             "final_norm.weight": 1 + randn(D, std=0.05),
             "final_norm.bias": randn(D, std=0.02)}
    return fd.FusedDecodePack(w, consts), fd.pack_readout(state), g


# f32 sums in another order flip single bf16 roundings of the activations;
# across 24 layers that stays within 1e-2 of the largest magnitude (the chip
# run records the actual error)
DECODE_TOL = 1e-2
VOCAB = 8194


def compare_step(torch, tag, out, ref):
    """Hidden, kv_new and logits of a decode step against the plain version
    (tolerance DECODE_TOL * max|ref|), and the logits' argmax per row."""
    errs = {}
    for name, a, b in (("hidden", out[0], ref[0]), ("kv_new", out[1], ref[1]),
                       ("logits", out[2][:, :VOCAB], ref[2][:, :VOCAB])):
        scale = float(b.float().abs().max())
        errs[name] = max_err(torch, a, b)
        print(f"{tag} {name}: max_abs_err {errs[name]:.4g} (max|ref| {scale:.4g}, "
              f"tol {DECODE_TOL} * max|ref|)")
        if not errs[name] <= DECODE_TOL * scale:
            fail(f"{tag} {name} disagrees with the plain version")
    am = out[2][:, :VOCAB].argmax(-1).tolist()
    am_p = ref[2][:, :VOCAB].argmax(-1).tolist()
    print(f"{tag} argmax per row {am} vs plain {am_p}")
    if am != am_p:
        fail(f"{tag} logits argmax differs from the plain version")
    return max(errs.values())


def check_k1(torch, dev, results):
    """K1 at B = 1: the bf16 cache of the bench slice (pos 300, Tmax 512),
    and the int8-KV branch at pos 300 / Tmax 512 and pos 1500 / Tmax 1792."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    print(f"decode-step tolerance (K1, K3): {DECODE_TOL} * max|ref|, because f32 "
          f"sums in another order flip single bf16 roundings of the activations, "
          f"compounded over 24 layers")
    pack, ro, g = random_trunk(torch, dev, 1)
    L, _, _, D = pack.w.shape
    H = 20
    cases, worst = [], 0.0
    for int8_kv, t_max, pos in ((False, 512, 300), (True, 512, 300), (True, 1792, 1500)):
        cache = torch.randn(L, 2, 1, t_max, D, generator=g, device=dev).to(torch.bfloat16)
        scales = None
        if int8_kv:
            cache, scales = fd.quantize_kv_cache(cache)
        bias = torch.zeros((t_max, 1), device=dev)
        bias[70:82] = -1e30                      # invalid prompt pads
        x = torch.randn(1, D, generator=g, device=dev) * 0.5

        def run(fn):
            return fn(x, pack, cache, bias, pos, H, ro, scales)
        out = run(fd.fused_decode_step)
        torch.cuda.synchronize()
        tag = f"K1 {'int8' if int8_kv else 'bf16'}-KV pos={pos} Tmax={t_max}"
        worst = max(worst, compare_step(torch, tag, out, run(fd.fused_decode_step_plain)))
        ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step), 20)
        plain_ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step_plain), 3)
        b = decode_step_bound(torch, pack, ro, cache, scales, bias, pos)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        cases.append({"kv": "int8" if int8_kv else "bf16", "pos": pos,
                      "t_max": t_max, "ms": ms, "plain_ms": plain_ms, **b})
    results.append({
        "name": "fused_decode_step", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:555",
        "max_abs_err": worst, "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
        "bound_ms": cases[0]["bound_ms"], "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "ms_of": "one bf16-KV decode step at pos 300, Tmax 512", "cases": cases})


def check_k3(torch, dev, results):
    """K3 at the flagship widths: (a) B = 3 through a random ancestor table
    with int8 KV, pos 1500, Tmax 1792 (the production beam step); (b) the
    same with a bf16 cache; (c) B = 8 at per-row positions, one of them 0,
    no table, bf16.  All with the folded readout."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack, ro, g = random_trunk(torch, dev, 4)
    L, _, _, D = pack.w.shape
    H, T_MAX = 20, 1792
    rows8 = torch.tensor([0, 17, 300, 511, 800, 1024, 1400, 1500],
                         dtype=torch.int32, device=dev)
    cases, worst = [], 0.0
    for name, b, int8_kv, table, pos in (("a", 3, True, True, 1500),
                                         ("b", 3, False, True, 1500),
                                         ("c", 8, False, False, rows8)):
        cache = torch.randn(L, 2, b, T_MAX, D, generator=g, device=dev).to(torch.bfloat16)
        scales = src = None
        if int8_kv:
            cache, scales = fd.quantize_kv_cache_batch(cache)
        if table:
            src = torch.randint(0, b, (b, T_MAX), generator=g, device=dev,
                                dtype=torch.int32)
        bias = torch.zeros((b, T_MAX), device=dev)
        bias[:, 50:68] = -1e30                   # invalid prompt pads
        x = torch.randn(b, D, generator=g, device=dev) * 0.5

        def run(fn):
            return fn(x, pack, cache, bias, pos, H, scales, src, ro)
        out = run(fd.fused_decode_step_batch)
        torch.cuda.synchronize()
        tag = (f"K3 ({name}) B={b} {'int8' if int8_kv else 'bf16'}-KV "
               f"{'table' if table else 'no table'} pos="
               f"{pos if isinstance(pos, int) else pos.tolist()} Tmax={T_MAX}")
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        if not finite:
            fail(f"{tag}: non-finite output")
        worst = max(worst, compare_step(torch, tag, out,
                                        run(fd.fused_decode_step_batch_plain)))
        ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step_batch), 20)
        plain_ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_step_batch_plain), 3)
        bnd = decode_step_bound(torch, pack, ro, cache, scales, bias, pos, src=src)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        cases.append({"case": name, "rows": b, "kv": "int8" if int8_kv else "bf16",
                      "table": table, "ms": ms, "plain_ms": plain_ms, **bnd})
    results.append({
        "name": "fused_decode_step_batch", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:1098",
        "max_abs_err": worst, "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
        "bound_ms": cases[0]["bound_ms"], "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "ms_of": "one beam-3 step through the table, int8 KV, pos 1500, Tmax 1792",
        "cases": cases})


def random_trunk_int4(torch, dev, seed: int, group: int):
    """A random int4 pack at the flagship widths (L 24, D 1280) with scale
    groups of `group` contraction rows, scaled like `pack_gpt_int4` of a
    GPT-2 trunk, and the int8 readout of `random_trunk`."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack8, ro, g = random_trunk(torch, dev, seed)
    L, _, _, D = pack8.w.shape
    w = torch.randint(-128, 128, (L, 12, D, D // 2), generator=g, device=dev,
                      dtype=torch.int8)              # every byte: two nibbles
    gs = 0.02 * 3 / 7 * (1 + 0.1 * torch.randn(L, 12, D, D // group, generator=g,
                                                device=dev)).abs()
    consts = pack8.consts.clone()
    consts[:, 0:12] = 0.0                          # unused by the int4 pack
    return fd.FusedDecodePackInt4(w, consts, gs), ro, g


# one int4 GEMV alone: f32 sums of <= 5120 terms in another order (lanes,
# then a warp reduction) against the plain version's, with no bf16 rounding
# between them
GEMV4_TOL = 1e-4
# the library product rounds the group scales and its output to bf16 (8
# significant bits each)
GEMV4_LIB_TOL = 1e-2


def int4_library_call(torch, w, gs, gsz: int):
    """`torch._weight_int4pack_mm` on the nibbles of w (n_kt, F, D/2) and the
    scales gs (n_kt, F, G), as a function of a bf16 row block: the library's
    unsigned nibbles u = q + 8 with its zero at 0 dequantize to q * scale (its
    scales in bf16).  None where this PyTorch build has no CUDA version."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    qs = [torch.cat(fd._unpack_int4(w[kt]), dim=1) for kt in range(w.shape[0])]
    u = (torch.cat(qs, dim=1) + 8).to(torch.int32)                # (F, K)
    scale = torch.cat(list(gs), dim=1).t()                        # (K/gsz, F)
    sz = torch.stack([scale, torch.zeros_like(scale)], -1).to(torch.bfloat16)
    try:
        try:                                  # (F, K/2) bytes, PyTorch >= 2.5
            packed = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
        except RuntimeError:                  # (F, K) int32, earlier builds
            packed = torch._convert_weight_to_int4pack(u, 8)
    except (NotImplementedError, RuntimeError, AttributeError) as e:
        print(f"library call unavailable: {str(e).splitlines()[0][:200]}")
        return None
    sz = sz.contiguous()
    return lambda xb: torch._weight_int4pack_mm(xb, packed, gsz, sz)


def int4_gemv_cases(torch, dev, pack):
    """The K7 loader alone at the four int4 GEMVs of one layer of the int4
    K1 chain (B = 1; qkv 1280 -> 3840, proj 1280 -> 1280, fc 1280 -> 5120,
    fc2 5120 -> 1280 as four contraction tiles) with a zero bias, each
    against its plain version (`_dot4` a contraction tile, GEMV4_TOL), with
    its bound and the time of `torch._weight_int4pack_mm` on the same
    nibbles and scales (checked against the plain version, GEMV4_LIB_TOL)."""
    from voice_tts_tpu_torch.ops import build
    from voice_tts_tpu_torch.ops import fused_decode as fd

    lib, stream = build.kernels(), build.stream_handle(dev)
    _, _, d, half = pack.w.shape
    n_groups = pack.gscales.shape[-1]
    gsz = d // n_groups
    g = torch.Generator(device=dev).manual_seed(9)
    cases = []
    for name, t0, n_tiles, n_kt in (("qkv", 0, 3, 1), ("proj", 3, 1, 1),
                                    ("fc", 4, 4, 1), ("fc2", 8, 4, 4)):
        f, k = (d, n_kt * d) if n_kt > 1 else (n_tiles * d, d)
        w = pack.w[0, t0:t0 + n_tiles].reshape(n_kt, f, half)
        gs = pack.gscales[0, t0:t0 + n_tiles].reshape(n_kt, f, n_groups)
        x = torch.randn(1, k, generator=g, device=dev) * 0.5
        bias = torch.zeros(f, device=dev)
        out = torch.empty(1, f, device=dev)

        def kernel():
            lib.call("vtt_dq_gemv", x.data_ptr(), None, None, w.data_ptr(), n_kt,
                     d, gs.data_ptr(), gsz, bias.data_ptr(), None, out.data_ptr(),
                     f, 1, fd._EPI_NONE, stream)
            return out

        def plain():
            y = bias
            for kt in range(n_kt):
                y = y + fd._dot4(x[:, kt * d:(kt + 1) * d], w[kt], gs[kt], 0.0)
            return y
        y = kernel().clone()
        torch.cuda.synchronize()
        ref = plain()
        tag = f"K7 int4 GEMV {name} 1x{k}->{f} g{gsz}"
        err, scale = max_err(torch, y, ref), float(ref.abs().max())
        print(f"{tag}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, tol "
              f"{GEMV4_TOL} * max|ref|)")
        if not err <= GEMV4_TOL * scale:
            fail(f"{tag} disagrees with the plain version")
        ms = cuda_time_ms(torch, kernel, 50)
        plain_ms = cuda_time_ms(torch, plain, 20)
        lib_ms = lib_err = None
        lib_fn = int4_library_call(torch, w, gs, gsz)
        if lib_fn is not None:
            xb = x.to(torch.bfloat16)
            lib_err = max_err(torch, lib_fn(xb), ref)
            print(f"{tag} torch._weight_int4pack_mm: max_abs_err {lib_err:.4g} "
                  f"(tol {GEMV4_LIB_TOL} * max|ref|)")
            if lib_err <= GEMV4_LIB_TOL * scale:
                lib_ms = library_time_ms(torch, lambda: lib_fn(xb), 50)
            else:
                print(f"{tag}: the library call computes another function here; "
                      f"no library time")
        # the nibbles and their scales read once, x and the bias read, the
        # f32 output written; 2 K F operations
        bnd = bound(nbytes(w, gs, x, bias, out), 2 * k * f)
        print(f"{tag}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library {lib_ms} ms")
        cases.append({"gemv": name, "k": k, "f": f, "group": gsz, "ms": ms,
                      "plain_ms": plain_ms, "max_abs_err": err, "library_ms": lib_ms,
                      "library_max_abs_err": lib_err, **bnd})
    return cases


def check_k7(torch, dev, results):
    """K7, the int4 weight loader: alone at the four GEMVs of a layer of the
    int4 K1 chain (the entry's headline times, beside the library's int4
    product); then the int4 K1 chain (B = 1, bf16 cache, folded int8
    readout) at pos 300 / Tmax 512 with g128 and g640 scale groups, and the
    int4 K3 chain at B = 3 through an ancestor table with int8 KV at pos
    1500 / Tmax 1792."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    H, cases, gemvs, worst = 20, [], [], 0.0
    for name, group, b, t_max, pos in (("K1 g128", 128, 1, 512, 300),
                                       ("K1 g640", 640, 1, 512, 300),
                                       ("K3 g128", 128, 3, 1792, 1500)):
        pack, ro, g = random_trunk_int4(torch, dev, 7, group)
        L, _, D, _ = pack.w.shape
        if not gemvs and group == 128:
            gemvs = int4_gemv_cases(torch, dev, pack)
        cache = torch.randn(L, 2, b, t_max, D, generator=g, device=dev).to(torch.bfloat16)
        bias = torch.zeros((b, t_max), device=dev)
        bias[:, 70:82] = -1e30                   # invalid prompt pads
        x = torch.randn(b, D, generator=g, device=dev) * 0.5
        scales = src = None
        if b > 1:
            cache, scales = fd.quantize_kv_cache_batch(cache)
            src = torch.randint(0, b, (b, t_max), generator=g, device=dev,
                                dtype=torch.int32)
            kernel, plain = fd.fused_decode_step_batch, fd.fused_decode_step_batch_plain

            def run(fn):
                return fn(x, pack, cache, bias, pos, H, scales, src, ro)
        else:
            kernel, plain = fd.fused_decode_step, fd.fused_decode_step_plain
            bias = bias.reshape(t_max, 1)

            def run(fn):
                return fn(x, pack, cache, bias, pos, H, ro)
        out = run(kernel)
        torch.cuda.synchronize()
        tag = f"K7 int4 {name} B={b} pos={pos} Tmax={t_max}"
        worst = max(worst, compare_step(torch, tag, out, run(plain)))
        ms = cuda_time_ms(torch, lambda: run(kernel), 20)
        plain_ms = cuda_time_ms(torch, lambda: run(plain), 3)
        bnd = decode_step_bound(torch, pack, ro, cache, scales, bias, pos, src=src,
                                rows=b)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        cases.append({"case": name, "group": group, "rows": b, "pos": pos,
                      "t_max": t_max, "ms": ms, "plain_ms": plain_ms, **bnd})
    layer = bound(sum(c["bound_bytes"] for c in gemvs),
                  sum(c["bound_ops"] for c in gemvs))
    lib_times = [c["library_ms"] for c in gemvs]
    results.append({
        "name": "fused_decode_int4", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:137",
        "max_abs_err": max([worst] + [c["max_abs_err"] for c in gemvs]),
        "ms": sum(c["ms"] for c in gemvs),
        "plain_ms": sum(c["plain_ms"] for c in gemvs),
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "library_ms": None if None in lib_times else sum(lib_times),
        "library_call": "torch._weight_int4pack_mm",
        "ms_of": "the int4 loader alone at the four GEMVs of one layer of the "
                 "int4 (g128) K1 chain, summed; launches count int4 chains, "
                 "96 loader launches each; the chains' times under cases",
        "gemvs": gemvs, "cases": cases})


def check_k6(torch, dev, results):
    """K6, the speculative verify: K = 4 tokens of one sequence through the
    int8 trunk, bf16 cache, at pos 300 / Tmax 512 and pos 1500 / Tmax 1792
    (hidden rows and the bf16 kv rows against the plain version)."""
    from voice_tts_tpu_torch.ops import fused_decode as fd

    pack, _, g = random_trunk(torch, dev, 8)
    L, _, _, D = pack.w.shape
    H, K = 20, 4
    cases, worst = [], 0.0
    for t_max, pos in ((512, 300), (1792, 1500)):
        cache = torch.randn(L, 2, 1, t_max, D, generator=g, device=dev).to(torch.bfloat16)
        bias = torch.zeros((t_max, 1), device=dev)
        bias[70:82] = -1e30
        x = torch.randn(K, D, generator=g, device=dev) * 0.5

        def run(fn):
            return fn(x, pack, cache, bias, pos, H)
        out = run(fd.fused_decode_verify)
        torch.cuda.synchronize()
        ref = run(fd.fused_decode_verify_plain)
        tag = f"K6 verify K={K} pos={pos} Tmax={t_max}"
        if not all(bool(torch.isfinite(v).all()) for v in out):
            fail(f"{tag}: non-finite output")
        for name, a, r in (("hidden", out[0], ref[0]), ("kv_new", out[1], ref[1])):
            err, scale = max_err(torch, a, r), float(r.float().abs().max())
            print(f"{tag} {name}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, "
                  f"tol {DECODE_TOL} * max|ref|)")
            if not err <= DECODE_TOL * scale:
                fail(f"{tag} {name} disagrees with the plain version")
            worst = max(worst, err)
        ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_verify), 20)
        plain_ms = cuda_time_ms(torch, lambda: run(fd.fused_decode_verify_plain), 3)
        bnd = decode_step_bound(torch, pack, None, cache, None, bias, pos, rows=K,
                                verify=True)
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        cases.append({"k": K, "pos": pos, "t_max": t_max, "ms": ms,
                      "plain_ms": plain_ms, **bnd})
    results.append({
        "name": "fused_decode_verify", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:1322",
        "max_abs_err": worst, "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
        "bound_ms": cases[0]["bound_ms"], "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "ms_of": "one K = 4 verify, bf16 KV, pos 300, Tmax 512", "cases": cases})


# the (D, F) of a GPT layer's four int8 products on the unfused decode step
# (c_attn, attn c_proj, mlp c_fc, mlp c_proj at the flagship D 1280)
K4_LAYER_SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


def check_k4(torch, dev, results):
    """K4 at the shapes the K5 slice gives it (a layer's four products, N 1;
    N 3 on the beam-3 request with K5), and a grid of N 1 / 8 / 32 rows
    at D 1280; the entry's times are one layer's set at N 1, summed."""
    from voice_tts_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(2)
    # bf16 output: sums in another order may round one bf16 ulp apart
    tol = 2 ** -7

    def one(n, d, f):
        x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (d, f), generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(1, f, generator=g, device=dev) * 1e-3 + 1e-4
        y = im.int8_gemv(x, w, s)
        torch.cuda.synchronize()
        y_p = im.int8_gemv_plain(x, w, s)
        err = max_err(torch, y, y_p)
        scale = float(y_p.float().abs().max())
        print(f"K4 N={n} D={d} F={f}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, "
              f"tol {tol:.4g} * max|ref|)")
        if not err <= tol * scale:
            fail(f"K4 int8_gemv N={n} D={d} F={f} disagrees with the plain version")
        ms = cuda_time_ms(torch, lambda: im.int8_gemv(x, w, s), 50)
        plain_ms = cuda_time_ms(torch, lambda: im.int8_gemv_plain(x, w, s), 50)
        # the library's int8 weight-only product: the same function on the
        # same values, w as (F, D) and the scales in bf16
        w_t, s_b = w.t().contiguous(), s.reshape(-1).to(torch.bfloat16)
        lib_ms = library_time_ms(
            torch, lambda: torch._weight_int8pack_mm(x, w_t, s_b), 50)
        # x and s read, w read, the bf16 output written; 2 N D F operations
        b = bound(nbytes(x, w, s) + n * f * 2, 2 * n * d * f)
        print(f"K4 N={n} D={d} F={f}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b['bound_ms']:.4f} ms, library {lib_ms} ms")
        return {"n": n, "d": d, "f": f, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "max_abs_err": err, **b}

    def layer_set(cases):
        """One layer's four products summed: times, bound, library."""
        total = bound(sum(t["bound_bytes"] for t in cases),
                      sum(t["bound_ops"] for t in cases))
        lib = [t["library_ms"] for t in cases]
        return {"ms": sum(t["ms"] for t in cases),
                "plain_ms": sum(t["plain_ms"] for t in cases),
                "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
                "library_ms": None if None in lib else sum(lib)}

    path = {n: [one(n, d, f) for d, f in K4_LAYER_SHAPES] for n in (1, 3)}
    grid = [one(n, 1280, f) for n in (1, 8, 32) for f in (1280, 3840, 5120)]
    head, beam = layer_set(path[1]), layer_set(path[3])
    for tag, t in (("N=1 (K5 slice)", head), ("N=3 (K5 beam)", beam)):
        print(f"K4 a layer's four products, {tag}: {t['ms']:.4f} ms kernel, "
              f"{t['plain_ms']:.4f} ms plain, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), library {t['library_ms']} ms")
    results.append({
        "name": "int8_gemv", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/int8_gemv.cu",
        "replaces": "voice_tts_tpu/ops/int8_matmul.py:44",
        "max_abs_err": max(t["max_abs_err"] for t in path[1] + path[3] + grid),
        **head, "library_call": "torch._weight_int8pack_mm",
        "ms_of": "one layer's four products at N 1 (D, F) = "
                 + ", ".join(f"{d}x{f}" for d, f in K4_LAYER_SHAPES) + ", summed",
        "beam_layer_set": beam, "path_shapes": path[1] + path[3], "grid_shapes": grid})


def vocoder_shapes(frames: int):
    """(C, T) of every BigVGAN activation for `frames` mel frames."""
    ch, t, shapes = 1536, frames, []
    for i, u in enumerate((4, 4, 2, 2, 2, 2)):
        ch, t = 1536 // 2 ** (i + 1), t * u
        shapes.append((ch, t))
    return shapes


def check_k2(torch, dev, results):
    from voice_tts_tpu_torch.ops import aa_activation as aa

    g = torch.Generator(device=dev).manual_seed(3)
    worst, vocode_ms, vocode_plain_ms = 0.0, 0.0, 0.0
    vocode_bytes = vocode_ops = 0
    # ~5 s at 22.05 kHz: the slice's 256-code bucket -> 448 mel frames.  A
    # vocode runs 18 activations per stage (3 resblocks x 3 dilations x 2)
    # and one more at the last stage's shape; (24, 7) checks a short signal.
    shapes = vocoder_shapes(448)
    per_vocode = [18] * len(shapes) + [1]
    for (c, t), count in zip(shapes + [shapes[-1], (24, 7)], per_vocode + [0]):
        x = torch.randn(1, c, t, generator=g, device=dev)
        alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=dev))
        br = 1.0 / (torch.exp(0.3 * torch.randn(c, generator=g, device=dev)) + 1e-9)
        y = aa.aa_snake_activation(x, alpha, br)
        torch.cuda.synchronize()
        y_p = aa.aa_snake_plain(x, alpha, br)
        err = max_err(torch, y, y_p)
        # f32 FMA contraction vs separate multiply-add: a few ulp of the
        # output magnitude
        tol = 1e-5 * max(1.0, float(y_p.abs().max()))
        print(f"K2 C={c} T={t}: max_abs_err {err:.4g} (tol {tol:.4g})")
        if not err <= tol:
            fail(f"K2 aa_snake C={c} T={t} disagrees with the plain version")
        worst = max(worst, err)
        ms = cuda_time_ms(torch, lambda: aa.aa_snake_activation(x, alpha, br), 20)
        plain_ms = cuda_time_ms(torch, lambda: aa.aa_snake_plain(x, alpha, br), 20)
        print(f"K2 C={c} T={t}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
        vocode_ms += count * ms
        vocode_plain_ms += count * plain_ms
        # x read and y written in f32, alpha and beta read; per sample the
        # 12-tap upsampling (two outputs of 6 taps, 24), the snake of the two
        # (4 operations each) and the 12-tap downsampling (24): 56
        vocode_bytes += count * (2 * nbytes(x) + nbytes(alpha, br))
        vocode_ops += count * 56 * c * t
    b = bound(vocode_bytes, vocode_ops, "f32")
    print(f"K2 per vocode (109 activations, 448 frames): {vocode_ms:.4f} ms "
          f"kernel, {vocode_plain_ms:.4f} ms plain, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    results.append({
        "name": "aa_snake_activation", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/aa_snake.cu",
        "replaces": "voice_tts_tpu/ops/aa_activation.py:210",
        "max_abs_err": worst, "ms": vocode_ms, "plain_ms": vocode_plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
        "ms_of": "the 109 activations of one 448-frame vocode"})


# f32 attention: sums of up to 3104 products in another order, and one
# rescaling a 64-key tile in the kernel's online softmax
ATT_F32_TOL = 1e-4
# bf16 attention: the kernel rounds the unnormalized probabilities to bf16
# (as jax's flash kernel), the plain K9 version the normalized ones, and the
# output rounds to bf16: a few bf16 ulps (2^-8) of the largest magnitude
ATT_BF16_TOL = 2 ** -6


def attention_case(torch, dev, g, kind: str, dtype, t: int, lens: list):
    """One K9 or K11 case at B 2, H 8, hd 64: kernel against its plain
    version (valid query rows), CUDA-event times, bound, and the time of
    `F.scaled_dot_product_attention` with the boolean mask that computes the
    same function on valid rows (checked against the plain version)."""
    import torch.nn.functional as F
    from voice_tts_tpu_torch.ops import cfm_attention as k9
    from voice_tts_tpu_torch.ops import flash_attention as k11

    b, h, hd = 2, 8, 64
    q, k, v = (torch.randn(b, h, t, hd, generator=g, device=dev).to(dtype)
               for _ in range(3))
    lens_t = torch.tensor(lens, device=dev, dtype=torch.int32)
    keep = torch.arange(t, device=dev)[None, :] < lens_t[:, None]       # (B, T)
    if kind == "K9":
        args = (q, k, v, lens_t, hd ** -0.5)
        kernel, plain = k9.cfm_attention, k9.cfm_attention_ref
        mask = keep[:, None, None, :]
        # keys a query row attends to: lens[b] for each of the T rows
        attended = sum(t * n for n in lens)
    else:
        seg = keep.to(torch.int32)
        args = (q, k, v, seg, seg, hd ** -0.5)
        kernel, plain = k11.flash_attention, k11.flash_attention_ref
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]
        # a row of segment 1 sees lens[b] keys, one of segment 0 T - lens[b]
        attended = sum(n * n + (t - n) * (t - n) for n in lens)
        lens_t = seg
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    tol = ATT_F32_TOL if dtype == torch.float32 else ATT_BF16_TOL
    tag = f"{kind} {str(dtype).split('.')[-1]} B={b} H={h} T={t} lens={lens}"
    err = max(max_err(torch, out[i, :, :n], ref[i, :, :n]) for i, n in enumerate(lens))
    scale = max(1.0, float(ref.float().abs().max()))
    print(f"{tag}: max_abs_err {err:.4g} on valid rows (tol {tol:.4g} * "
          f"max(1, max|ref|) = {tol * scale:.4g})")
    if not torch.isfinite(out.float()).all() or not err <= tol * scale:
        fail(f"{tag} disagrees with the plain version")
    ms = cuda_time_ms(torch, lambda: kernel(*args), 10)
    plain_ms = cuda_time_ms(torch, lambda: plain(*args), 3)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=hd ** -0.5)
    lib_ms = None
    try:
        lib_err = max(max_err(torch, library()[i, :, :n], ref[i, :, :n])
                      for i, n in enumerate(lens))
    except (NotImplementedError, RuntimeError) as e:
        print(f"library call unavailable: {str(e).splitlines()[0][:200]}")
    else:
        print(f"{tag} F.scaled_dot_product_attention: max_abs_err {lib_err:.4g}")
        if lib_err <= 4 * tol * scale:
            lib_ms = library_time_ms(torch, library, 10)
    # q, k, v read, the output written, the mask's ints read; QK^T and PV
    # are 4 operations a (query, attended key, head dim)
    bnd = bound(nbytes(q, k, v, out, lens_t), 4 * h * hd * attended,
                "f32" if dtype == torch.float32 else "bf16")
    print(f"{tag}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library {lib_ms} ms")
    return {"dtype": str(dtype).split(".")[-1], "t": t, "lens": lens, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err, **bnd}


def check_attention(torch, dev, results):
    """K9 and K11 at B 2, H 8, hd 64, bf16 and f32, T 896 (the DiT slice's
    5 s prompt) and T 3104 (the production slice's mel bucket 2656 plus
    prompt bucket 448), lens below T; the entry's headline is bf16 at T 896,
    the shape the slice runs."""
    g = torch.Generator(device=dev).manual_seed(10)
    for kind, name, src in (("K9", "cfm_attention", "voice_tts_tpu/ops/attic/cfm_attention.py:64"),
                            ("K11", "flash_attention", "voice_tts_tpu/models/s2mel/dit.py:122")):
        print(f"{kind} tolerance: f32 {ATT_F32_TOL} (sums in another order), bf16 "
              f"{ATT_BF16_TOL} (probabilities rounded before the normalisation, "
              f"output rounded to bf16), times max(1, max|ref|)")
        cases = [attention_case(torch, dev, g, kind, dtype, t, lens)
                 for dtype in (torch.bfloat16, torch.float32)
                 for t, lens in ((896, [850, 600]), (3104, [3000, 2100]))]
        head = cases[0]
        results.append({
            "name": name, "route": "cuda", "source": "voice_tts_tpu_torch/csrc/dit_attention.cu",
            "replaces": src, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_call": "torch.nn.functional.scaled_dot_product_attention (boolean mask)",
            "ms_of": "one call, bf16, B 2, H 8, T 896, lens (850, 600)", "cases": cases})


# K8 on the card against its plain version: the same bf16 rounding points,
# but GEMM sums in another order, expf against torch's sigmoid, and the
# attention's probabilities rounded before the normalisation flip single bf16
# roundings, compounded over 13 blocks
K8_TOL = 2e-2


def check_k8(torch, dev, results):
    """K8 at the flagship trunk (13 blocks, D 512, 8 heads) with random DiT
    weights, B 2 (CFG), T 704 (the DiT slice's 2.5 s prompt), lens 650."""
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.models.layers import init_weights
    from voice_tts_tpu_torch.models.s2mel.dit import DiT
    from voice_tts_tpu_torch.ops import dit_blocks as k8

    cfg = TTSConfig().s2mel
    g = torch.Generator(device=dev).manual_seed(11)
    with torch.device(dev):
        dit = init_weights(DiT(cfg.dit, cfg.wavenet), g).eval()
    d, heads, depth = cfg.dit.hidden_dim, cfg.dit.num_heads, cfg.dit.depth
    b, t, n = 2, 704, 650
    with torch.no_grad():
        tables = dit.step_tables(torch.tensor([0.36], device=dev))
        wb = k8.pack_dit_tables(dit, tables)[0]
        pack = k8.pack_dit_blocks(dit)
    x = torch.randn(b, t, d, generator=g, device=dev)
    cos, sin = k8.rope_tables(t, d // heads, cfg.dit.rope_base, dev)
    lens = torch.tensor([n, n], device=dev, dtype=torch.int32)

    def run(fn):
        return fn(x, pack, wb, cos, sin, lens, heads)
    out = run(k8.dit_block_chain)
    torch.cuda.synchronize()
    ref = run(k8.dit_block_chain_ref)
    err = max_err(torch, out[:, :n], ref[:, :n])
    scale = float(ref[:, :n].abs().max())
    print(f"K8 tolerance: {K8_TOL} * max|ref| (bf16 roundings flipped by sums "
          f"in another order, compounded over {depth} blocks)")
    print(f"K8 L={depth} D={d} H={heads} B={b} T={t} lens={n}: max_abs_err "
          f"{err:.4g} on valid rows (max|ref| {scale:.4g})")
    if not torch.isfinite(out).all() or not err <= K8_TOL * scale:
        fail("K8 dit_block_chain disagrees with the plain version")
    ms = cuda_time_ms(torch, lambda: run(k8.dit_block_chain), 10)
    plain_ms = cuda_time_ms(torch, lambda: run(k8.dit_block_chain_ref), 3)
    # bytes: the bf16 weights once, x read and the output written in f32, the
    # tables; operations: 2 per multiply-add of the 13 D^2 weights a row, and
    # 4 a (query, valid key, head dim) of the attention, every layer
    ops = depth * (2 * b * t * 13 * d * d + 4 * d * b * t * n)
    bnd = bound(nbytes(*pack, x, out, wb, cos, sin, lens), ops)
    print(f"K8: {ms:.4f} ms kernel chain, {plain_ms:.4f} ms plain, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    results.append({
        "name": "dit_block_chain", "route": "cuda", "source": "voice_tts_tpu_torch/csrc/dit_blocks.cu",
        "replaces": "voice_tts_tpu/ops/attic/dit_blocks.py:243", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
        "bound_by": bnd["bound_by"], "library_ms": None,
        "ms_of": "one trunk evaluation (13 blocks), B 2, T 704, lens 650",
        "bound_bytes": bnd["bound_bytes"], "bound_ops": bnd["bound_ops"]})


# K5 against its plain version: f32 sums in another order (and over other
# tiles of the online softmax); bf16 inputs keep f32 sums, the output rounds
# to bf16 (8 significant bits), so one flipped rounding is one ulp, which
# near the largest magnitude m is up to 2^-7 * m
K5_F32_TOL = 1e-5
K5_BF16_TOL = 2 ** -7


def check_k5(torch, dev, results):
    """K5 at the flagged decode paths' shapes (GPT 20 heads of 64): B 1, Tmax
    512, length 343 (the bench configuration with the flag) and B 3, Tmax
    2048, length 1571 (beam-3 in the production profile with the flag), bf16
    and f32, beside `F.scaled_dot_product_attention` on the same live prefix
    with the bias as its additive mask.  The headline is bf16 at B 1."""
    import torch.nn.functional as F
    from voice_tts_tpu_torch.ops import decode_attention as k5

    print(f"K5 tolerance: f32 {K5_F32_TOL} * max|ref| (sums in another order), bf16 "
          f"{K5_BF16_TOL} * max|ref| (the bf16 output rounding)")
    g = torch.Generator(device=dev).manual_seed(12)
    h, hd, cases = 20, 64, []
    for dtype in (torch.bfloat16, torch.float32):
        for b, t_max, length in ((1, 512, 343), (3, 2048, 1571)):
            q = torch.randn(b, h, hd, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(b, h, hd, t_max, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            bias = torch.zeros(b, t_max, device=dev)
            bias[:, 40:52] = -1e30                  # padded prompt positions
            args = (q, k, v, bias, length)
            out = k5.decode_attention(*args)
            torch.cuda.synchronize()
            ref = k5.decode_attention_plain(*args)
            tol = K5_F32_TOL if dtype == torch.float32 else K5_BF16_TOL
            err, scale = max_err(torch, out, ref), float(ref.float().abs().max())
            tag = f"K5 {str(dtype).split('.')[-1]} B={b} H={h} Tmax={t_max} length={length}"
            print(f"{tag}: max_abs_err {err:.4g} (max|ref| {scale:.4g})")
            if not torch.isfinite(out.float()).all() or not err <= tol * scale:
                fail(f"{tag} disagrees with the plain version")
            ms = cuda_time_ms(torch, lambda: k5.decode_attention(*args), 50)
            plain_ms = cuda_time_ms(torch, lambda: k5.decode_attention_plain(*args), 20)
            kl = k[..., :length].transpose(-1, -2)  # (B, H, L, hd) views of the cache
            vl = v[..., :length].transpose(-1, -2)
            mask = bias[:, None, None, :length].to(dtype)

            def library():
                return F.scaled_dot_product_attention(q[:, :, None], kl, vl,
                                                      attn_mask=mask)[:, :, 0]
            lib_ms = None
            lib_err = max_err(torch, library(), ref)
            print(f"{tag} F.scaled_dot_product_attention: max_abs_err {lib_err:.4g}")
            if lib_err <= 4 * tol * scale:
                lib_ms = library_time_ms(torch, library, 50)
            # the K and V prefix read once, q, the bias prefix, the output
            # written; 4 operations a (head, dim, attended position)
            el = q.element_size()
            bnd = bound(2 * b * h * hd * length * el + nbytes(q, out) + 4 * b * length,
                        4 * b * h * hd * length, "f32" if dtype == torch.float32 else "bf16")
            print(f"{tag}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
                  f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), library {lib_ms} ms")
            cases.append({"dtype": str(dtype).split(".")[-1], "b": b, "t_max": t_max,
                          "length": length, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "max_abs_err": err, **bnd})
    head = cases[0]
    results.append({
        "name": "decode_attention", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "voice_tts_tpu/ops/decode_attention.py:104",
        "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention (additive mask)",
        "ms_of": "one call, bf16, B 1, H 20, Tmax 512, length 343", "cases": cases})


# K10 against its plain version (cuDNN f32 convs with TF32 off): f32 sums in
# another order through 18 convs of up to 192 x 11 terms
K10_TOL = 1e-4
VOC_HALO = 78            # a stage's stencil halo (the module path's edges differ)


def flagship_vocoder(torch, dev, seed: int):
    """The flagship BigVGAN (`TTSConfig().vocoder`) with random weights, its
    snake parameters moved off zero so the activations bend."""
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.models.layers import init_weights
    from voice_tts_tpu_torch.models.vocoder.bigvgan import BigVGAN

    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        voc = init_weights(BigVGAN(TTSConfig().vocoder), g).eval().requires_grad_(False)
        for name, p in voc.named_parameters():
            if name.endswith(("alpha", "beta")):
                p.add_(0.1 * torch.randn(p.shape, generator=g, device=dev))
    return voc


def check_k10(torch, dev, results):
    """K10 at the four fused stages of the flagship BigVGAN (C 192, 96, 48,
    24 at 32, 64, 128, 256 samples a frame) for a 448-frame mel, f32, random
    weights; the entry's times are the four summed (one vocode's fused
    stages)."""
    from voice_tts_tpu_torch.ops import fused_vocoder as k10

    # the plain reference's convs in full f32, as the engine runs them
    torch.backends.cudnn.allow_tf32 = False
    voc = flagship_vocoder(torch, dev, 13)
    cfg = voc.cfg
    packs = k10.pack_fused_stages(voc.state_dict(), cfg)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    sum_k = sum(cfg.resblock_kernel_sizes)
    n_iter = len(dil)
    g = torch.Generator(device=dev).manual_seed(14)
    print(f"K10 tolerance: {K10_TOL} * max|ref| (f32 sums in another order); "
          f"fused stages {sorted(packs)}")
    cases = []
    for (c, t), (i, pack) in zip(vocoder_shapes(448)[2:], sorted(packs.items())):
        x = torch.randn(1, c, t, generator=g, device=dev) * 0.3
        out = k10.fused_resblock_stage(x, pack, dil)
        torch.cuda.synchronize()
        ref = k10.fused_resblock_stage_plain(x, pack, dil)
        err, scale = max_err(torch, out, ref), float(ref.abs().max())
        tag = f"K10 stage {i} C={c} T={t}"
        print(f"{tag}: max_abs_err {err:.4g} (max|ref| {scale:.4g})")
        if not torch.isfinite(out).all() or not err <= K10_TOL * scale:
            fail(f"{tag} disagrees with the plain version")
        ms = cuda_time_ms(torch, lambda: k10.fused_resblock_stage(x, pack, dil), 5, warmup=1)
        plain_ms = cuda_time_ms(torch, lambda: k10.fused_resblock_stage_plain(x, pack, dil),
                                3, warmup=1)
        # x read and the output written once, each block's own taps (2 n_iter
        # convs of k_j x C x C) with their biases and snake values; 2
        # operations a multiply-add of 2 C^2 T n_iter sum_j k_j
        weights = 4 * (2 * n_iter * sum_k * c * c + 3 * pack.b.numel())
        bnd = bound(2 * nbytes(x) + weights, 2 * c * c * t * 2 * n_iter * sum_k, "f32")
        print(f"{tag}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        cases.append({"stage": i, "c": c, "t": t, "ms": ms, "plain_ms": plain_ms,
                      "max_abs_err": err, **bnd})
    total = bound(sum(c["bound_bytes"] for c in cases), sum(c["bound_ops"] for c in cases),
                  "f32")
    results.append({
        "name": "fused_resblock_stage", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_vocoder.cu",
        "replaces": "voice_tts_tpu/ops/attic/fused_vocoder.py:192",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["ms"] for c in cases), "plain_ms": sum(c["plain_ms"] for c in cases),
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"], "library_ms": None,
        "ms_of": "the four fused stages of one 448-frame vocode, summed", "cases": cases})
    del voc, packs


# ---------------------------------------------------------------------------
# the micro-benchmark path (K12, K13)
# ---------------------------------------------------------------------------

MICRO_CHECK_TILES = 16
# a benchmark run: the scripts' defaults (D 1280, 288 tiles, 20 and 60 passes)
MICRO_D, MICRO_TILES, MICRO_LO, MICRO_HI = 1280, 288, 20, 60
# the mode each entry's headline times: K12's one-row product (K4's case),
# K13's grouped int4 scheme (K7's)
MICRO_HEADLINE = {"micro_tile": "dot1", "micro_int4": "cur"}
MICRO_LIBRARY = ("no single PyTorch call streams int8 tiles through a per-tile "
                 "stage and sums the tiles' terms (or carries a row through "
                 "them): the function is a benchmark loop, not a library "
                 "operation")


def check_micro_tile(torch, dev):
    """K12's modes against the plain version at D 1280, 16 tiles (dot8i with
    x scaled past the int8 range, so the saturating cast shows).  Returns
    each mode's error."""
    from voice_tts_tpu_torch.ops import micro_tile as mt
    from voice_tts_tpu_torch.scripts import micro_tile as script

    n = MICRO_CHECK_TILES
    x, w = script.make_inputs(MICRO_D, n, dev)
    # the kernel adds its partials in another order: each of the n + 1
    # adds on either side rounds by at most 2^-24 of the absolute sum of the
    # terms; the dots' f32 sums of D products also run in another order
    # (4 standard deviations of that random walk, sqrt(D) 2^-24)
    c_int = 2 * (n + 1) * 2 ** -24
    c_dot = c_int + 4 * MICRO_D ** 0.5 * 2 ** -24
    errs = {}
    for mode in mt.MODES:
        xm = x * 100 if mode == "dot8i" else x
        out = mt.micro_tile(xm, w, mode)
        torch.cuda.synchronize()
        ref = mt.micro_tile_plain(xm, w, mode)
        if mode in ("dot1", "dot8"):
            terms = [mt.stage_plain(xm.abs(), w[t].abs(), mode) for t in range(n)]
        else:
            terms = [mt.stage_plain(xm, w[t], mode).abs() for t in range(n)]
        mag = float((xm.abs() + sum(terms)).max())
        tol = (c_dot if mode in ("dot1", "dot8") else c_int) * mag
        err = max_err(torch, out, ref)
        print(f"K12 {mode} D={MICRO_D} T={n}: max_abs_err {err:.4g} (tol {tol:.4g} = "
              f"{tol / mag:.3g} * {mag:.4g}, the largest absolute sum of the terms)")
        if not torch.isfinite(out).all() or not err <= tol:
            fail(f"K12 micro_tile {mode} disagrees with the plain version")
        errs[mode] = err
    return errs


def check_micro_int4(torch, dev):
    """K13's modes against the plain version at D 1280, scales at U(500,
    2500) so that the tile term moves the carried row: one tile from a
    bf16-exact x (the tile's arithmetic), then 16 tiles (the barriers and
    buffers that carry the row).  Returns each mode's larger error."""
    from voice_tts_tpu_torch.ops import micro_int4 as mi
    from voice_tts_tpu_torch.scripts import micro_int4 as script

    x, w, gs, per_half = script.make_inputs(MICRO_D, MICRO_CHECK_TILES, dev,
                                            gs_range=(500.0, 2500.0))
    x1 = x.to(torch.bfloat16).float()
    # dma: the same f32 operations in the same order.  One tile: the dots'
    # f32 sums in another order.  16 tiles: a carried value that differs in
    # its last bit may round to a neighbouring bf16 before the next tile's
    # product, and such flips compound from tile to tile (one bf16 step is
    # 2^-8 of a value; 2^-6 of max|row 0| bounds where the two land, while a
    # fault in a tile's arithmetic or in the carry moves row 0 by its size)
    tols = {1: 1e-5, MICRO_CHECK_TILES: 2 ** -6}
    errs = {}
    for mode in mi.MODES:
        errs[mode] = 0.0
        for n, xn in ((1, x1), (MICRO_CHECK_TILES, x)):
            out = mi.micro_int4(xn, w[:n].contiguous(), gs, mode, per_half)
            torch.cuda.synchronize()
            ref = mi.micro_int4_plain(xn, w[:n], gs, mode, per_half)
            scale = float(ref[0].abs().max())
            tol = 0.0 if mode == "dma" else tols[n] * scale
            err = max_err(torch, out, ref)
            moved = float((ref[0] - 0.5 ** n * xn[0]).abs().max())
            print(f"K13 {mode} D={MICRO_D} T={n}: max_abs_err {err:.4g} (tol {tol:.4g}; "
                  f"max|row 0| {scale:.4g}, moved by the tiles {moved:.4g}); rows 1-7 "
                  f"equal: {bool(torch.equal(out[1:], ref[1:]))}")
            if (not torch.isfinite(out).all() or not err <= tol
                    or not torch.equal(out[1:], ref[1:])):
                fail(f"K13 micro_int4 {mode} T={n} disagrees with the plain version")
            errs[mode] = max(errs[mode], err)
    return errs


def micro_bound(name: str, mode: str, x, w, gs=None) -> dict:
    """The weight stream (each byte read once), x and gs read, the (8, D)
    output written; the products' operations at their type's peak."""
    d = x.shape[1]
    rows = {"dot1": 1, "dot8": 8, "dot8i": 8}.get(mode, 0) if name == "micro_tile" \
        else (0 if mode == "dma" else 1)
    ops = 2 * rows * d * d * w.shape[0]
    return bound(nbytes(w, gs, x) + nbytes(x), ops, "int8" if mode == "dot8i" else "bf16")


def run_micro_path(torch, dev, counters, results):
    """The micro-benchmark path: both entry points at their defaults with
    the launch counters from 0 (one launch a pass: 2 (lo + hi) a mode),
    then each plain version's time over 3 passes at the same shapes."""
    from voice_tts_tpu_torch.ops import micro_int4 as mi
    from voice_tts_tpu_torch.ops import micro_tile as mt
    from voice_tts_tpu_torch.scripts import micro_int4 as int4_script
    from voice_tts_tpu_torch.scripts import micro_tile as tile_script

    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' dots in f32
    errs = {"micro_tile": check_micro_tile(torch, dev),
            "micro_int4": check_micro_int4(torch, dev)}
    args = ["--dim", str(MICRO_D), "--tiles", str(MICRO_TILES),
            "--lo", str(MICRO_LO), "--hi", str(MICRO_HI)]
    counters.reset()
    timed = {"micro_tile": tile_script.main(args), "micro_int4": int4_script.main(args)}
    launches = counters.snapshot()
    per_mode = 2 * (MICRO_LO + MICRO_HI)
    for name, mods in (("micro_tile", mt.MODES), ("micro_int4", mi.MODES)):
        if launches[name] != per_mode * len(mods):
            fail(f"{name}: {launches[name]} launches on the micro-benchmark path, "
                 f"expected {per_mode * len(mods)} (one a pass)")
    others = {k: v for k, v in launches.items() if v and k not in timed}
    if others:
        fail(f"the micro-benchmark path launched other kernels: {others}")
    print(f"micro-benchmark path launches: micro_tile {launches['micro_tile']}, "
          f"micro_int4 {launches['micro_int4']} (one a pass, {per_mode} a mode)")

    x, w = tile_script.make_inputs(MICRO_D, MICRO_TILES, dev)
    x4, w4, gs, per_half = int4_script.make_inputs(MICRO_D, MICRO_TILES, dev)
    cases = {"micro_tile": ((x, w), mt.micro_tile_plain),
             "micro_int4": ((x4, w4, gs), lambda x, w, gs, mode:
                            mi.micro_int4_plain(x, w, gs, mode, per_half))}
    for name, (data, plain) in cases.items():
        modes = {}
        for r in timed[name]:
            mode = r["mode"]
            plain_ms = cuda_time_ms(torch, lambda: plain(*data, mode), 3, warmup=1)
            b = micro_bound(name, mode, *data)
            modes[mode] = {"ms": r["ms"], "event_ms": r["event_ms"],
                           "us_per_tile": r["us_per_tile"], "gb_per_s": r["gb_per_s"],
                           "plain_ms": plain_ms, "max_abs_err": errs[name][mode], **b}
            print(f"{name} {mode}: {r['ms']:.4f} ms a pass (events {r['event_ms']:.4f}), "
                  f"{r['gb_per_s']:.1f} GB/s, plain {plain_ms:.3f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        head = modes[MICRO_HEADLINE[name]]
        results.append({
            "name": name, "route": "cuda", "source": f"voice_tts_tpu_torch/csrc/{name}.cu",
            "replaces": {"micro_tile": "scripts/micro_tile.py:51",
                         "micro_int4": "scripts/micro_int4.py:119"}[name],
            "max_abs_err": max(errs[name].values()), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "library_note": MICRO_LIBRARY,
            "ms_of": f"a pass of mode {MICRO_HEADLINE[name]} at D {MICRO_D}, "
                     f"{MICRO_TILES} tiles ((t({MICRO_HI}) - t({MICRO_LO})) / "
                     f"{MICRO_HI - MICRO_LO}, as the script times); every mode under modes",
            "launches_per_pass": 1, "modes": modes})
    del x, w, x4, w4, gs, cases
    return launches


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def tone_prompt(seconds: float, sr: int) -> bytes:
    """A two-tone prompt WAV (as bench.py builds it)."""
    import numpy as np
    from voice_tts_tpu_torch.audio import encode_wav_int16

    t = np.arange(int(seconds * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    return encode_wav_int16(tone * 32767, sr)


def _shared_noise(torch, cpu, gpu, dev):
    """Hand both engines the same CFM noise, drawn on the CPU."""
    g = torch.Generator().manual_seed(5)
    noise = {}

    def draw(shape):
        if tuple(shape) not in noise:
            noise[tuple(shape)] = torch.randn(shape, generator=g)
        return noise[tuple(shape)]
    cpu._draw_noise = lambda shape: draw(shape)
    gpu._draw_noise = lambda shape: draw(shape).to(dev)


def _tiny_pair(torch, dev, dit=None, gpt=None, **flags):
    """The tiny engine with engine `flags` on the CPU (plain versions) and on
    the card (every kernel launched), with the same random weights.  With
    `dit` (DiTConfig fields to set) the DiT is widened to D 256, 4 heads:
    the DiT kernels' 64-wide heads, and `can_fuse_dit` holds.  `gpt` sets
    GPTConfig fields of the two engines (their runtime GPT is built from
    it)."""
    import copy

    from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config

    def config(**engine_flags):
        cfg = tiny_config(**engine_flags)
        for k, v in (gpt or {}).items():
            setattr(cfg.gpt, k, v)
        if dit is not None:
            d = cfg.s2mel.dit
            d.hidden_dim, d.num_heads = 256, 4
            cfg.s2mel.wavenet.hidden_dim = d.hidden_dim
            for k, v in dit.items():
                setattr(d, k, v)
        return cfg
    base = TTSEngine.random(config(), device="cpu", seed=0)
    cfg = config(**flags)
    cpu = TTSEngine(cfg, copy.deepcopy(base.models), base.tokenizer, device="cpu")
    gpu = TTSEngine(cfg, copy.deepcopy(base.models), base.tokenizer, device=dev)
    _shared_noise(torch, cpu, gpu, dev)
    return cpu, gpu


def _compare_wavs(tag, ref, out, tol):
    import numpy as np

    if out.wav.shape != ref.wav.shape:
        fail(f"{tag}: card wav {out.wav.shape} vs CPU {ref.wav.shape}")
    diff = int(np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max())
    steps = (ref.metrics["decode_steps"], out.metrics["decode_steps"])
    print(f"{tag} card vs CPU: {len(out.wav)} samples, decode steps {steps}, "
          f"max |diff| {diff} LSB (tol {tol})")
    if steps[0] != steps[1] or diff > tol:
        fail(f"{tag} on the card disagrees with the CPU reference")


# same codes, then f32 s2mel / vocoder on two devices: the int16 samples may
# differ by float rounding only
WAV_TOL = 64
# the bench-like engine flags of the tiny checks: the int8 K1 decode
TINY_BENCH_FLAGS = dict(use_int8_decode=True, use_fused_decode=True,
                        fold_readout=True, use_fp16=True, fuse_pipeline=True)


def check_tiny_engine(torch, dev):
    """End-to-end reference on a small input, bench-like flags: the tiny
    engine on the card (K1, K2, K4 on its int8 prefill) against the same
    weights on the CPU (plain versions), greedy, same CFM noise."""
    cpu, gpu = _tiny_pair(torch, dev, **TINY_BENCH_FLAGS)
    prompt = tone_prompt(1.0, 16000)
    ref = cpu.infer(prompt, "hello world.", do_sample=False)
    out = gpu.infer(prompt, "hello world.", do_sample=False)
    torch.cuda.synchronize()
    _compare_wavs("tiny engine (num_beams 1)", ref, out, WAV_TOL)


# bf16 conditioning: cuBLAS and the CPU round the bf16 products at other
# points; one bf16 ulp is 2^-8 of a value, compounded over a few layers
COND_TOL = 3e-2


def check_tiny_engine_production(torch, dev, counters=None, gpt=None):
    """The tiny engine under the production flags (beam-3 through K3 with the
    ancestor table, int8 KV, folded readout, bf16 GPT and conditioning,
    masters released) on the card against the CPU, greedy, same weights and
    CFM noise.  The card's own bf16 conditioning is held against the CPU's
    (COND_TOL); the decode and synthesis then start from the CPU's
    conditioning on both, so that the comparison is of the beam kernels and
    the synthesis.  With `gpt` = {"pallas_decode_attention": True} the beam
    takes the eager arm with K5 instead of K3 (its launches are checked),
    with the f32 GPT (TINY_F32_GPT)."""
    flags = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                 use_fused_beam_decode=True, use_int8_kv=True, fold_readout=True,
                 use_bf16_conditioning=True, release_master_trees=True,
                 fuse_pipeline=True)
    if gpt:
        flags.update(TINY_F32_GPT)
    cpu, gpu = _tiny_pair(torch, dev, gpt=gpt, **flags)
    prompt = tone_prompt(1.0, 16000)
    key = cpu._content_key(prompt)
    spk_c, spk_g = cpu._speaker_conditioning(prompt), gpu._speaker_conditioning(prompt)
    for name in ("cond_latents", "spk_emovec", "style", "prompt_condition"):
        ref = spk_c[name].float()
        err = max_err(torch, spk_g[name].cpu(), ref)
        tol = COND_TOL * max(1.0, float(ref.abs().max()))
        print(f"tiny production conditioning {name}: max_abs_err {err:.4g} (tol {tol:.4g})")
        if not err <= tol:
            fail(f"tiny production conditioning {name}: card disagrees with the CPU")
    gpu._spk_cache[key] = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                           for k, v in spk_c.items()}
    gpu._emo_cache[key] = cpu._emotion_conditioning(prompt).to(dev)
    ref = cpu.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    if counters is not None:
        counters.reset()
    out = gpu.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    torch.cuda.synchronize()
    tag = "tiny engine (production, beam-3" + (", K5)" if gpt else ")")
    _compare_wavs(tag, ref, out, WAV_TOL)
    if gpt:
        _check_k5_launches(tag, counters.snapshot(), gpu, out.metrics["decode_steps"],
                           k4_per_step=0)


def _check_k5_launches(tag, got, engine, steps, k4_per_step):
    """K5 once per layer and decode step, K4 `k4_per_step` times per layer
    and step, K1 and K3 never."""
    layers = engine.cfg.gpt.layers
    print(f"{tag} launches: K5 {got['decode_attention']}, K4 {got['int8_gemv']} for "
          f"{steps} steps x {layers} layers; K1 {got['fused_decode_step']}, K3 "
          f"{got['fused_decode_step_batch']}")
    if (steps == 0 or got["decode_attention"] != layers * steps
            or got["int8_gemv"] != k4_per_step * layers * steps
            or got["fused_decode_step"] or got["fused_decode_step_batch"]):
        fail(f"{tag}: K5 not once per layer and step, K4 not {k4_per_step} times, "
             f"or K1 / K3 ran")


# the tiny K5 pairs decode with the f32 GPT: the int8 + bf16 runtime copy's
# unfused step rounds each op to bf16 at other points on the two devices
# (LayerNorm and tanh, K4's sums), and at random tiny weights one flipped
# rounding changes a greedy code within a few steps; the int8 path's
# kernels are held against their plain versions above, the flagship K5
# slice counts them, and `check_tiny_engine_k5_int8` holds the int8 + bf16
# pair with K5 against the same pair without it
TINY_F32_GPT = dict(use_fp16=False, use_int8_decode=False)


def check_tiny_engine_k5(torch, dev, counters):
    """`GPTConfig.pallas_decode_attention` in the tiny engine on the card
    against the CPU, f32 GPT (TINY_F32_GPT): one beam (the bench flags, the
    unfused step with K5 instead of K1) and the production flags (beam-3,
    the eager arm with K5, int8 KV dropped), greedy, same weights and CFM
    noise: the same decode and WAVs within WAV_TOL, K5 once per layer and
    step, K1, K3 and K4 never."""
    flag = {"pallas_decode_attention": True}
    cpu, gpu = _tiny_pair(torch, dev, gpt=flag, **{**TINY_BENCH_FLAGS, **TINY_F32_GPT})
    prompt = tone_prompt(1.0, 16000)
    ref = cpu.infer(prompt, "hello world.", do_sample=False)
    counters.reset()
    out = gpu.infer(prompt, "hello world.", do_sample=False)
    torch.cuda.synchronize()
    _compare_wavs("tiny engine (num_beams 1, K5)", ref, out, WAV_TOL)
    _check_k5_launches("tiny engine (num_beams 1, K5)", counters.snapshot(), gpu,
                       out.metrics["decode_steps"], k4_per_step=0)
    check_tiny_engine_production(torch, dev, counters, gpt=flag)


def _greedy_record(torch, engine, prompt, forced=None):
    """One greedy request on `engine` with the decode loop's choices
    recorded: the repetition-penalised logits each code is chosen from
    (the last decode of the request) and the codes.  With `forced` (the
    codes of another run) each step takes that run's code instead of its
    own argmax, so both runs decode from the same history."""
    from voice_tts_tpu_torch.models.gpt import decode as dec

    inner, logits, codes = dec.sample_token, [], []

    def choose(step_logits, presence, gen, generator):
        own = inner(step_logits, presence, gen, generator)
        logits.append(dec.apply_repetition_penalty(
            step_logits.float(), presence, gen.repetition_penalty)[0].cpu())
        code = own if forced is None else torch.full_like(own, forced[len(codes)])
        codes.append(int(code[0]))
        return code

    decode_sampled = engine._decode_sampled

    def decode(*args, **kwargs):
        logits.clear()
        codes.clear()
        return decode_sampled(*args, **kwargs)
    dec.sample_token, engine._decode_sampled = choose, decode
    try:
        out = engine.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
    finally:
        dec.sample_token = inner
        del engine._decode_sampled
    return out, torch.stack(logits), codes


# the int8 + bf16 pairs: the card's logits, decoded from the CPU's codes,
# may stray from the CPU's by bf16 roundings at other points; with K5 no
# more than K5_INT8_RATIO times as far as with the einsum attention
K5_INT8_RATIO = 4.0


def check_tiny_engine_k5_int8(torch, dev, counters):
    """The int8 + bf16 runtime copy's unfused step (the K5 slice's GPT
    flags) in the tiny engine on the card against the CPU, one beam,
    greedy, same weights and CFM noise, twice: with K5
    (`pallas_decode_attention`) and without it (the einsum attention,
    `use_fused_decode` off, so no pack).  Each pair decodes freely (where
    the codes first differ, the WAVs where they agree), then the card
    decodes again from the CPU's codes, and each step's logits are held
    against the CPU's.  Fails if K5 or K1 launch where they should not, if
    agreeing codes give WAVs beyond WAV_TOL, or if the logits stray further
    with K5 than K5_INT8_RATIO times as far as with the einsum attention."""
    import numpy as np

    prompt = tone_prompt(1.0, 16000)
    stray = {}
    for tag, gpt, flags in (
            ("K5", {"pallas_decode_attention": True}, TINY_BENCH_FLAGS),
            ("einsum", None, {**TINY_BENCH_FLAGS, "use_fused_decode": False})):
        cpu, gpu = _tiny_pair(torch, dev, gpt=gpt, **flags)
        ref, logits_c, codes_c = _greedy_record(torch, cpu, prompt)
        counters.reset()
        out, _, codes_g = _greedy_record(torch, gpu, prompt)
        got = counters.snapshot()
        _, logits_g, _ = _greedy_record(torch, gpu, prompt, forced=codes_c)
        first = next((i for i, (a, b) in enumerate(zip(codes_c, codes_g)) if a != b),
                     None if len(codes_c) == len(codes_g) else
                     min(len(codes_c), len(codes_g)))
        diff = None
        if out.wav.shape == ref.wav.shape:
            diff = int(np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max())
        err = (logits_g - logits_c).abs().amax(dim=-1)       # a step's largest
        top2 = logits_c.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        stray[tag] = float(err.max())
        at = "" if first is None or first >= len(err) else (
            f"; at code {first} the logits strayed {float(err[first]):.4g}, "
            f"the CPU's top-2 margin {float(margin[first]):.4g}")
        print(f"tiny engine int8 + bf16 unfused step ({tag}) card vs CPU: codes "
              f"{len(codes_g)} / {len(codes_c)}, first differing code {first}, wav "
              f"max |diff| {diff} LSB (tol {WAV_TOL} where the codes agree); from "
              f"the CPU's codes the card's logits stray at most {stray[tag]:.4g} "
              f"(max|logits| {float(logits_c.abs().max()):.4g}, smallest top-2 "
              f"margin {float(margin.min()):.4g}){at}; K5 launches "
              f"{got['decode_attention']}, K4 {got['int8_gemv']}, K1 "
              f"{got['fused_decode_step']}")
        if (got["decode_attention"] == 0) != (gpt is None) or got["fused_decode_step"]:
            fail(f"tiny int8 + bf16 pair ({tag}): K5 launched {got['decode_attention']} "
                 f"times, K1 {got['fused_decode_step']}")
        if first is None and (diff is None or diff > WAV_TOL):
            fail(f"tiny int8 + bf16 pair ({tag}): the codes agree but the WAVs do not")
    print(f"tiny int8 + bf16 pairs: the logits stray {stray['K5']:.4g} with K5, "
          f"{stray['einsum']:.4g} with the einsum attention (tol {K5_INT8_RATIO}x)")
    if not stray["K5"] <= K5_INT8_RATIO * stray["einsum"]:
        fail("tiny int8 + bf16 pair: the logits stray further with K5 than with "
             "the einsum attention")


def check_tiny_engine_vocoders(torch, dev, counters):
    """Each vocoder flag in the tiny engine (bench flags) on the card against
    the CPU, greedy, same weights and CFM noise: the same decode and WAVs
    within WAV_TOL (the packed and shared variants compute the module
    path's function, the fused one K10's on both devices); K10 once per
    fused stage on the card."""
    prompt = tone_prompt(1.0, 16000)
    for flag in ("use_packed_vocoder", "use_shared_act_vocoder", "use_fused_vocoder"):
        cpu, gpu = _tiny_pair(torch, dev, **{flag: True}, **TINY_BENCH_FLAGS)
        ref = cpu.infer(prompt, "hello world.", do_sample=False)
        counters.reset()
        out = gpu.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
        _compare_wavs(f"tiny engine ({flag}, {gpu.voc_variant})", ref, out, WAV_TOL)
        want = len(gpu.voc_pack) if gpu.voc_variant == "fused" else 0
        got = counters.snapshot()["fused_resblock_stage"]
        print(f"tiny engine ({flag}) K10 launches {got} (want {want})")
        if gpu.voc_variant == "module" or got != want:
            fail(f"tiny engine ({flag}): the variant was not taken, or K10 launches {got}")


def check_tiny_engine_spec(torch, dev):
    """The tiny engine with spec decode (K = 4: int4 drafts through K1 and
    K7, one verify a round through K6), and with the int4 decode pack (K1
    with K7), each on the card against the CPU, greedy, same weights and CFM
    noise: the same decode steps (and spec rounds) and WAVs within
    WAV_TOL."""
    base = dict(use_int8_decode=True, use_fused_decode=True, use_fp16=True,
                fuse_pipeline=True)
    prompt = tone_prompt(1.0, 16000)
    for tag, flags in (("spec_decode_k 4", dict(spec_decode_k=4)),
                       ("use_int4_decode", dict(use_int4_decode=True,
                                                fold_readout=True))):
        cpu, gpu = _tiny_pair(torch, dev, **base, **flags)
        ref = cpu.infer(prompt, "hello world.", do_sample=False)
        out = gpu.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
        _compare_wavs(f"tiny engine ({tag})", ref, out, WAV_TOL)
        rounds = [m.get("spec_rounds") for m in (ref.metrics, out.metrics)]
        accepted = [m.get("spec_accepted") for m in (ref.metrics, out.metrics)]
        print(f"tiny engine ({tag}) spec rounds {rounds}, accepted drafts {accepted}")
        if rounds[0] != rounds[1] or accepted[0] != accepted[1]:
            fail(f"tiny engine ({tag}): the card's speculative rounds differ from the CPU's")


# bf16 s2mel: cuBLAS and the CPU round the DiT's bf16 products at other
# points (as COND_TOL), and K8's bf16 storage flips a rounding here and there
S2MEL_BF16_TOL = 3e-2


def check_tiny_engine_dit(torch, dev, counters):
    """The DiT kernels in the tiny engine (D 256) on the card against the
    same weights on the CPU, same CFM noise: K9 (`fused_attention`) and K11
    (`flash_attention`) with f32 s2mel, whole requests, WAVs within WAV_TOL
    and one launch per block and Euler step; K8 (`fused_blocks` with
    `use_bf16_s2mel`, the DiT slice's flags) on the s2mel stage alone with
    the same random inputs, mels within S2MEL_BF16_TOL and one launch per
    Euler step."""
    import numpy as np

    prompt = tone_prompt(1.0, 16000)
    for tag, flag, name in (("K9", "fused_attention", "cfm_attention"),
                            ("K11", "flash_attention", "flash_attention")):
        cpu, gpu = _tiny_pair(torch, dev, dit={flag: True}, **TINY_BENCH_FLAGS)
        ref = cpu.infer(prompt, "hello world.", do_sample=False)
        counters.reset()
        out = gpu.infer(prompt, "hello world.", do_sample=False)
        torch.cuda.synchronize()
        got = counters.snapshot()[name]
        want = gpu.cfg.engine.diffusion_steps * gpu.cfg.s2mel.dit.depth
        print(f"tiny engine ({tag}, {flag}) launches {got} (want {want})")
        if got != want:
            fail(f"tiny engine ({tag}): {name} was not launched once per block and step")
        _compare_wavs(f"tiny engine ({tag}, {flag})", ref, out, WAV_TOL)

    cpu, gpu = _tiny_pair(torch, dev, dit=dict(fused_blocks=True, fused_attention=True),
                          use_bf16_s2mel=True, **TINY_BENCH_FLAGS)
    rng = np.random.default_rng(3)
    c = gpu.cfg
    cb, pb = 32, 64
    mb = gpu._mel_bucket_for(cb)
    inputs = [rng.standard_normal((1, cb, c.gpt.model_dim)).astype(np.float32),
              rng.integers(0, c.semantic_codec.codebook_size, (1, cb)),
              np.asarray([cb - 2]),
              rng.standard_normal((1, pb, c.s2mel.length_regulator.channels)).astype(np.float32),
              np.asarray([pb - 7]),
              rng.standard_normal((1, c.mel.num_mels, pb)).astype(np.float32),
              rng.standard_normal((1, c.campplus.embedding_size)).astype(np.float32)]
    with torch.no_grad():
        ref, _ = cpu._s2mel(*[torch.from_numpy(a) for a in inputs], mb)
        counters.reset()
        out, _ = gpu._s2mel(*[torch.from_numpy(a).to(dev) for a in inputs], mb)
        torch.cuda.synchronize()
    got = counters.snapshot()
    err, scale = max_err(torch, out.cpu(), ref), float(ref.abs().max())
    print(f"tiny engine (K8, use_bf16_s2mel + fused_blocks) s2mel: max_abs_err "
          f"{err:.4g} (max|ref| {scale:.4g}, tol {S2MEL_BF16_TOL} * max|ref|); "
          f"launches K8 {got['dit_block_chain']}, K9 {got['cfm_attention']}")
    if not err <= S2MEL_BF16_TOL * scale:
        fail("tiny engine (K8): the card's s2mel disagrees with the CPU's")
    if got["dit_block_chain"] != c.engine.diffusion_steps or got["cfm_attention"] != 0:
        fail("tiny engine (K8): K8 was not launched once per Euler step")


def http(port: int, method: str, path: str, body: bytes = None, timeout=900):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def profile_request(torch, engine, prompt: bytes, text: str):
    """One more warm request under the CUDA profiler: device busy time
    (sum of kernel times) against the host wall clock, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer(prompt, text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    print("profile: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall if wall else None,
        "metrics": engine.last_metrics,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_s": e.self_device_time_total / 1e6}
                        for e in top]}))


def serve_requests(torch, engine, profile: str, counters, prompts_s=(5.0, 5.0, 5.0)):
    """Serve `engine` over HTTP from a background thread: GET /health, GET
    /debug/worker-info, then one POST /tts per prompt length in `prompts_s`
    (seconds of the two-tone prompt), with the counters set to 0 just before
    the first and read after each.  Returns (launches over all requests,
    decode steps, AA activations per vocode, the first prompt, text, each
    request's metrics, each request's launches)."""
    import numpy as np
    from voice_tts_tpu_torch.audio import decode_audio_bytes
    from voice_tts_tpu_torch.serving.app import BackgroundServer, TTSService

    cfg = engine.cfg
    n_act = (len(cfg.vocoder.upsample_rates) * len(cfg.vocoder.resblock_kernel_sizes)
             * 2 * len(cfg.vocoder.resblock_dilation_sizes[0]) + 1)
    service = TTSService(engine, profile=profile)
    server = BackgroundServer(service)
    port = server.start()
    try:
        status, body = http(port, "GET", "/health")
        print(f"[{profile}] GET /health -> {status} {body.decode()}")
        if status != 200:
            fail("/health did not answer 200")
        status, body = http(port, "GET", "/debug/worker-info")
        info = json.loads(body)["replicas"][0]
        print(f"[{profile}] GET /debug/worker-info -> {status} "
              + json.dumps({k: info[k] for k in ("profile", "num_beams", "engine_flags")}))
        if status != 200 or info["profile"] != profile:
            fail("/debug/worker-info does not report the served profile")
        prompts = [tone_prompt(sec, 22050) for sec in prompts_s]
        text = "欢迎大家来体验这个语音合成系统谢谢大家."
        counters.reset()
        steps, metrics, per_request = 0, [], []
        before = counters.snapshot()
        for i, prompt in enumerate(prompts):
            t1 = time.perf_counter()
            status, body = http(port, "POST", "/tts", json.dumps(
                {"text": text, "spk_audio": prompt.hex()}).encode())
            wall = time.perf_counter() - t1
            if status != 200:
                fail(f"[{profile}] POST /tts #{i} -> {status}: {body[:500]!r}")
            after = counters.snapshot()
            per_request.append({k: after[k] - before[k] for k in after})
            before = after
            resp = json.loads(body)
            wav, sr = decode_audio_bytes(bytes.fromhex(resp["audio_hex"]))
            if sr != 22050 or wav.size == 0 or not np.all(np.isfinite(wav)):
                fail(f"[{profile}] POST /tts #{i}: bad WAV (sr {sr}, {wav.size} samples)")
            m = engine.last_metrics
            metrics.append(dict(m))
            steps += m["decode_steps"]
            print(f"[{profile}] POST /tts #{i} ({prompts_s[i]} s prompt): 200, "
                  f"{wav.size} samples ({resp['audio_length']:.3f} s), rtf "
                  f"{resp['rtf']:.4f} (server), wall {wall:.3f} s, timers "
                  + json.dumps({k: round(v, 4) for k, v in m.items()}))
        launches = counters.snapshot()
    finally:
        server.stop()
        service.close()
    print(f"[{profile}] launches over {len(prompts)} requests: {launches} (decode "
          f"steps {steps}, {n_act} AA activations per vocode)")
    return launches, steps, n_act, prompts[0], text, metrics, per_request


def run_production_slice(torch, dev, counters):
    """The flagship engine in the production profile (the server default):
    beam-3 through K3 with the ancestor table, int8 KV."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, serving_config

    t0 = time.perf_counter()
    engine = TTSEngine.random(serving_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[serving] engine build (flagship widths, random weights): "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    launches, steps, n_act, prompt, text, _, _ = serve_requests(torch, engine, "serving",
                                                                counters)
    if launches["fused_decode_step_batch"] != steps or steps == 0:
        fail("K3 was not launched once per beam decode step")
    if launches["fused_decode_step"] != 0:
        fail("K1 was launched on the beam path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    profile_request(torch, engine, prompt, text)
    print(f"[serving] peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, engine.vocoder


def run_bench_slice(torch, dev, counters):
    """The flagship engine in the bench configuration (`--profile bench`):
    sampling, one beam through K1."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config

    t0 = time.perf_counter()
    engine = TTSEngine.random(bench_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[bench] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, steps, n_act, _, _, metrics, _ = serve_requests(torch, engine, "bench",
                                                              counters)
    if launches["fused_decode_step"] != steps or steps == 0:
        fail("K1 was not launched once per decode step")
    if launches["fused_decode_step_batch"] != 0:
        fail("K3 was launched on the one-beam path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    return launches, metrics


def run_spec_slice(torch, dev, counters, bench_metrics):
    """The bench configuration with self-speculative decode, K = 4: each
    round three int4 draft steps (K1 chains with the int4 loader, K7), one
    int8 verify of the four tokens (K6), then the acceptance step."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config

    cfg = bench_config()
    cfg.engine.spec_decode_k = 4
    t0 = time.perf_counter()
    engine = TTSEngine.random(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[spec] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, steps, n_act, prompt, text, metrics, _ = serve_requests(torch, engine,
                                                                      "spec", counters)
    rounds = sum(m["spec_rounds"] for m in metrics)
    accepted = sum(m["spec_accepted"] for m in metrics)
    if rounds == 0 or launches["fused_decode_verify"] != rounds:
        fail("K6 was not launched once per speculative round")
    if (launches["fused_decode_int4"] != 3 * rounds
            or launches["fused_decode_step"] != 3 * rounds):
        fail("the int4 K1 chain (K1 with K7) was not launched three times a round")
    if launches["fused_decode_step_batch"] != 0:
        fail("K3 was launched on the speculative path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    print("[spec] " + json.dumps({
        "rounds": rounds, "accepted_drafts": accepted,
        "acceptance_rate": accepted / (3 * rounds),
        "codes_per_round": steps / rounds,
        "gpt_gen_time": [m["gpt_gen_time"] for m in metrics],
        "rtf": [m["rtf"] for m in metrics],
        "decode_steps": [m["decode_steps"] for m in metrics],
        "bench_gpt_gen_time": [m["gpt_gen_time"] for m in bench_metrics],
        "bench_rtf": [m["rtf"] for m in bench_metrics],
        "bench_decode_steps": [m["decode_steps"] for m in bench_metrics]}))
    profile_request(torch, engine, prompt, text)
    return launches


def dit_config():
    """The DiT slice: `bench_config()` with bf16 s2mel, the K8 trunk and K9
    attention (the JAX engine's flags; no server profile has them)."""
    from voice_tts_tpu_torch.engine.engine import bench_config

    cfg = bench_config()
    cfg.engine.use_bf16_s2mel = True
    cfg.s2mel.dit.fused_blocks = True
    cfg.s2mel.dit.fused_attention = True
    return cfg


def run_dit_slice(torch, dev, counters, bench_metrics):
    """The DiT slice at the flagship widths: three POST /tts, a 2.5 s prompt
    twice (prompt bucket 256 + mel bucket 448 = T 704: the K8 trunk, once per
    velocity evaluation) and a 5 s prompt (bucket 448, T 896 > 768: K9 in
    every block), then one profiled request at each prompt length.  Returns
    (launches, the engine)."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine

    t0 = time.perf_counter()
    engine = TTSEngine.random(dit_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[dit] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, _, n_act, prompt, text, metrics, per_request = serve_requests(
        torch, engine, "dit", counters, prompts_s=(2.5, 2.5, 5.0))
    prompt_t896 = tone_prompt(5.0, 22050)
    cfg = engine.cfg
    evals = cfg.engine.diffusion_steps
    for i, (m, got) in enumerate(zip(metrics, per_request)):
        k8, k9 = got["dit_block_chain"], got["cfm_attention"]
        want = (evals, 0) if i < 2 else (0, evals * cfg.s2mel.dit.depth)
        print(f"[dit] request #{i}: K8 {k8}, K9 {k9} (want {want}), K1 "
              f"{got['fused_decode_step']} for {m['decode_steps']} steps, K2 "
              f"{got['aa_snake_activation']}")
        if (k8, k9) != want:
            fail(f"[dit] request #{i}: K8 / K9 launches {(k8, k9)}, want {want}")
        if got["fused_decode_step"] != m["decode_steps"] or m["decode_steps"] == 0:
            fail(f"[dit] request #{i}: K1 was not launched once per decode step")
        if got["aa_snake_activation"] != n_act or got["flash_attention"] != 0:
            fail(f"[dit] request #{i}: K2 not once per activation, or K11 launched")
    keys = ("s2mel_time", "gpt_gen_time", "gpt_forward_time", "bigvgan_time", "rtf")
    print("[dit] stage timers " + json.dumps({
        "dit": {k: [m[k] for m in metrics] for k in keys},
        "bench": {k: [m[k] for m in bench_metrics] for k in keys},
        "dit_prompts_s": [2.5, 2.5, 5.0], "bench_prompts_s": [5.0, 5.0, 5.0]}))
    print("[dit] profiled request at T 704 (K8):")
    profile_request(torch, engine, prompt, text)
    print("[dit] profiled request at T 896 (K9):")
    profile_request(torch, engine, prompt_t896, text)
    return launches, engine


def run_flash_engine(torch, dev, counters, dit_engine):
    """K11: a second engine on the DiT slice engine's weights with
    `flash_attention` on and `fused_attention` / `fused_blocks` off, one
    request at the 5 s prompt (T 896): K11 in every block and Euler step."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine
    from voice_tts_tpu_torch.models.s2mel.s2mel import S2Mel

    cfg = dit_config()
    cfg.s2mel.dit.fused_blocks = cfg.s2mel.dit.fused_attention = False
    cfg.s2mel.dit.flash_attention = True
    extras = {"w2v_mean": dit_engine.w2v_mean.cpu().numpy(),
              "w2v_std": dit_engine.w2v_std.cpu().numpy(),
              "emo_matrix": dit_engine.emo_matrix, "spk_matrix": dit_engine.spk_matrix}
    # the s2mel module carries its DiT flags: a new one with this
    # configuration, holding the DiT slice's weights; the other models shared
    with torch.device(dev):
        s2mel = S2Mel(cfg.s2mel, cfg.semantic_codec.hidden_size)
    s2mel.load_state_dict(dit_engine.models["s2mel"].state_dict())
    engine = TTSEngine(cfg, {**dit_engine.models, "s2mel": s2mel},
                       dit_engine.tokenizer, extras, dev)
    launches, _, n_act, _, _, metrics, _ = serve_requests(torch, engine, "flash", counters,
                                                          prompts_s=(5.0,))
    want = cfg.engine.diffusion_steps * cfg.s2mel.dit.depth
    print(f"[flash] K11 {launches['flash_attention']} (want {want}), K8 "
          f"{launches['dit_block_chain']}, K9 {launches['cfm_attention']}; s2mel_time "
          f"{metrics[0]['s2mel_time']:.4f} s")
    if (launches["flash_attention"] != want or launches["dit_block_chain"]
            or launches["cfm_attention"]):
        fail("[flash] K11 was not launched once per block and Euler step")
    if launches["aa_snake_activation"] != n_act:
        fail("[flash] K2 was not launched on every vocoder activation")
    return launches


def k5_config():
    """The K5 slice: `bench_config()` with `GPTConfig.pallas_decode_attention`
    (the unfused decode step, K5 attention, K4 projections) and
    `use_fused_vocoder` (stages 2-5 through K10); no server profile has
    them, as in the JAX package."""
    from voice_tts_tpu_torch.engine.engine import bench_config

    cfg = bench_config()
    cfg.gpt.pallas_decode_attention = True
    cfg.engine.use_fused_vocoder = True
    return cfg


def run_k5_slice(torch, dev, counters, bench_metrics):
    """The K5 slice at the flagship widths: three POST /tts (5 s prompts),
    each launching K5 24 times and K4 96 times a decode step, K1 and K3
    never, K10 once per fused stage (4) and K2 on the other stages' and the
    post activations (37) a vocode; then one profiled request.  Returns
    (launches, the engine)."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine
    from voice_tts_tpu_torch.ops.fused_vocoder import fused_stage_plan

    t0 = time.perf_counter()
    engine = TTSEngine.random(k5_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[k5] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfg = engine.cfg
    layers, vc = cfg.gpt.layers, cfg.vocoder
    print(f"[k5] K4 a decode step: 4 int8 projections (attn_c_attn, attn_c_proj, "
          f"mlp_c_fc, mlp_c_proj) x {layers} layers = {4 * layers}: each has B*S = 1 "
          f"<= 32 rows on a step; the prefill (84 rows) and the teacher-forced forward "
          f"take the dequantized matmul instead")
    plan = fused_stage_plan(vc)
    n_k10 = sum(plan)
    n_k2 = (plan.count(False) * len(vc.resblock_kernel_sizes) * 2
            * len(vc.resblock_dilation_sizes[0]) + 1)
    launches, _, _, prompt, text, metrics, per_request = serve_requests(
        torch, engine, "k5", counters)
    for i, (m, got) in enumerate(zip(metrics, per_request)):
        steps = m["decode_steps"]
        tag = f"[k5] request #{i}"
        _check_k5_launches(tag, got, engine, steps, k4_per_step=4)
        print(f"{tag}: K10 {got['fused_resblock_stage']} (want {n_k10}), K2 "
              f"{got['aa_snake_activation']} (want {n_k2})")
        if got["fused_resblock_stage"] != n_k10 or got["aa_snake_activation"] != n_k2:
            fail(f"{tag}: K10 not once per fused stage or K2 not on the other activations")
    keys = ("gpt_gen_time", "decode_steps", "s2mel_time", "gpt_forward_time",
            "bigvgan_time", "rtf")
    print("[k5] stage timers " + json.dumps({
        "k5": {k: [m[k] for m in metrics] for k in keys},
        "bench": {k: [m[k] for m in bench_metrics] for k in keys}}))
    profile_request(torch, engine, prompt, text)
    return launches, engine


# the K5 beam request's code cap: random weights never stop, and the
# profile's 1500 would decode 511 + 1499 eager beam steps (115 s of the
# run's time limit in one measured run, 55.7 ms a step); 512 decodes 511
K5_BEAM_MAX_CODES = 512


def run_k5_beam(torch, dev, counters, k5_engine):
    """One beam-3 request with K5: a second engine in the production profile
    with `pallas_decode_attention`, on the K5 slice engine's models (the
    int8 runtime GPT is built from its f32 master), its code cap cut to
    K5_BEAM_MAX_CODES.  Random weights decode to the cap (511 steps), each a
    K5 launch per layer and K4 four; K3 and K1 never."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, serving_config

    cfg = serving_config()
    cfg.gpt.pallas_decode_attention = True
    cfg.generation.max_mel_tokens = K5_BEAM_MAX_CODES
    extras = {"w2v_mean": k5_engine.w2v_mean.cpu().numpy(),
              "w2v_std": k5_engine.w2v_std.cpu().numpy(),
              "emo_matrix": k5_engine.emo_matrix, "spk_matrix": k5_engine.spk_matrix}
    engine = TTSEngine(cfg, dict(k5_engine.models), k5_engine.tokenizer, extras, dev)
    launches, steps, _, _, _, metrics, _ = serve_requests(torch, engine, "k5_beam",
                                                          counters, prompts_s=(5.0,))
    m = metrics[0]
    _check_k5_launches("[k5_beam] request #0", launches, engine, steps, k4_per_step=4)
    print(f"[k5_beam] {steps} beam steps, gpt_gen_time {m['gpt_gen_time']:.4f} s "
          f"({1e3 * m['gpt_gen_time'] / steps:.3f} ms a step), rtf {m['rtf']:.4f}")
    return launches


# the vocoder variants against the module path on the same weights and mel:
# the same function (packed, shared), or K10's (fused) beyond the edge halos;
# f32 sums in another order through six stages, relative to the largest
# output magnitude (random weights leave the waveform far below 1, so an
# absolute bound would say nothing)
VOC_AB_TOL = 1e-4


def vocoder_ab(torch, dev, vocoder):
    """The production slice's flagship BigVGAN vocodes one random mel at 448
    and 2656 frames four ways, each timed with CUDA events over 5 runs after
    one warm-up: the module path (K2 109 a vocode), packed (grouped convs),
    shared activations, and fused (stages 2-5 through K10).  Prints each
    time and the largest difference from the module path over the module
    path's largest magnitude; the fused one's in the interior (beyond 4
    stage halos at stage 2's rate, 8 samples of output a sample there) and
    at the edges."""
    from voice_tts_tpu_torch.models.vocoder import packed
    from voice_tts_tpu_torch.ops import fused_vocoder

    torch.backends.cudnn.allow_tf32 = False
    cfg = vocoder.cfg
    state = vocoder.state_dict()
    trees = {"packed": packed.pack_bigvgan(state, cfg),
             "shared_act": packed.pack_bigvgan_shared(state, cfg),
             "fused": fused_vocoder.pack_fused_stages(state, cfg)}
    ways = {"module": lambda mel: vocoder(mel),
            "packed": lambda mel: packed.bigvgan_packed_apply(trees["packed"], mel, cfg),
            "shared_act": lambda mel: packed.bigvgan_shared_act_apply(trees["shared_act"],
                                                                      mel, cfg),
            "fused": lambda mel: fused_vocoder.bigvgan_fused_apply(vocoder, trees["fused"],
                                                                   mel)}
    edge = 4 * VOC_HALO * 8
    g = torch.Generator(device=dev).manual_seed(15)
    report = []
    with torch.no_grad():
        for frames in (448, 2656):
            mel = torch.randn(1, cfg.num_mels, frames, generator=g, device=dev) - 4.0
            row, ref = {"frames": frames, "samples": frames * 256}, None
            for name, fn in ways.items():
                out = fn(mel)
                torch.cuda.synchronize()
                ms = cuda_time_ms(torch, lambda: fn(mel), 5, warmup=1)
                entry = {"ms": ms}
                if ref is None:
                    ref, scale = out, float(out.abs().max())
                    entry["max_abs"] = scale
                elif name == "fused":
                    d = (out - ref).abs()[0, 0] / scale
                    entry["rel_diff_interior"] = float(d[edge:-edge].max())
                    entry["rel_diff_edges"] = float(torch.cat([d[:edge], d[-edge:]]).max())
                    entry["interior_from"] = edge
                else:
                    entry["rel_diff"] = max_err(torch, out, ref) / scale
                row[name] = entry
            print("[vocoder A/B] " + json.dumps(row))
            if not scale > 0:
                fail(f"[vocoder A/B] the module path's waveform is zero at {frames} frames")
            for name in ("packed", "shared_act"):
                if not row[name]["rel_diff"] <= VOC_AB_TOL:
                    fail(f"[vocoder A/B] {name} differs from the module path at {frames} frames")
            if not row["fused"]["rel_diff_interior"] <= VOC_AB_TOL:
                fail(f"[vocoder A/B] fused differs from the module path inside at {frames} frames")
            report.append(row)
    return report


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    torch, card = device_check()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    from voice_tts_tpu_torch.ops import build, counters

    t0 = time.perf_counter()
    lib = build.kernels(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.path.name})")

    results = []
    check_k2(torch, dev, results)
    check_k4(torch, dev, results)
    check_k1(torch, dev, results)
    check_k3(torch, dev, results)
    check_k7(torch, dev, results)
    check_k6(torch, dev, results)
    check_attention(torch, dev, results)
    check_k8(torch, dev, results)
    check_k5(torch, dev, results)
    check_k10(torch, dev, results)
    torch.cuda.empty_cache()
    by_path = {"micro": run_micro_path(torch, dev, counters, results)}
    torch.cuda.empty_cache()
    check_tiny_engine(torch, dev)
    check_tiny_engine_production(torch, dev)
    check_tiny_engine_spec(torch, dev)
    check_tiny_engine_dit(torch, dev, counters)
    check_tiny_engine_k5(torch, dev, counters)
    check_tiny_engine_k5_int8(torch, dev, counters)
    check_tiny_engine_vocoders(torch, dev, counters)
    by_path["serving"], vocoder = run_production_slice(torch, dev, counters)
    torch.cuda.empty_cache()
    by_path["bench"], bench_metrics = run_bench_slice(torch, dev, counters)
    torch.cuda.empty_cache()
    by_path["spec"] = run_spec_slice(torch, dev, counters, bench_metrics)
    torch.cuda.empty_cache()
    by_path["dit"], dit_engine = run_dit_slice(torch, dev, counters, bench_metrics)
    by_path["flash"] = run_flash_engine(torch, dev, counters, dit_engine)
    del dit_engine
    torch.cuda.empty_cache()
    by_path["k5"], k5_engine = run_k5_slice(torch, dev, counters, bench_metrics)
    by_path["k5_beam"] = run_k5_beam(torch, dev, counters, k5_engine)
    del k5_engine
    torch.cuda.empty_cache()
    vocoder_ab(torch, dev, vocoder)
    # each kernel's launches come from the path that runs it: K3 and K2 from
    # the production slice, K1 from the bench slice, K6 and K7 from the spec
    # slice, K8 and K9 from the DiT slice, K11 from its engine, K5, K4 and
    # K10 from the K5 slice
    owner = {"fused_decode_step": "bench", "fused_decode_verify": "spec",
             "fused_decode_int4": "spec", "dit_block_chain": "dit",
             "cfm_attention": "dit", "flash_attention": "flash",
             "decode_attention": "k5", "int8_gemv": "k5", "fused_resblock_stage": "k5",
             "micro_tile": "micro", "micro_int4": "micro"}
    for r in results:
        r["launches"] = by_path[owner.get(r["name"], "serving")][r["name"]]
        r["launches_by_path"] = {p: by_path[p][r["name"]] for p in by_path}
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
