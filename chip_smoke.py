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
   TB/s, or its operations over the peak rate, whichever is larger): K2, K4,
   K1 (bf16 cache; int8 KV at pos 300 and 1500), K3 (beam-3 through an
   ancestor table with int8 KV and with a bf16 cache, pos 1500; eight rows
   at their own positions, one of them 0), K7 (the int4 loader alone at the
   four GEMVs of a layer, beside `torch._weight_int4pack_mm`; the int4 K1
   chain at g128 and g640, pos 300; the int4 K3 chain at beam-3 through a
   table), K6 (the verify of K = 4 tokens at pos 300 and 1500);
4. tiny engines: the tiny engine on the card against the same weights on
   the CPU, greedy, same CFM noise: one beam (K1), the production flags
   (beam-3 through K3, int8 KV, bf16 conditioning), spec decode with
   K = 4 (int4 drafts through K1 and K7, the verify through K6), and the
   int4 decode pack (K1 with K7);
5. production slice: the flagship engine (random weights) in the serving
   profile, the server default, behind the HTTP server in a background
   thread: GET /health, GET /debug/worker-info, three POST /tts, then one
   request under the CUDA profiler; the launch counters must show K3 once
   per beam decode step, K1 never, K2 109 times per vocode;
6. bench slice: the same with `--profile bench` (sampling, one beam): K1
   once per decode step, K3 never, K2 109 times per vocode;
7. spec slice: the bench configuration with `spec_decode_k = 4` (int4
   drafts, one int8 verify a round), three POST /tts and one profiled: K6
   once per round, three int4 K1 chains (K1 and K7) per round, K3 never,
   K2 109 times per vocode; prints the acceptance rate, the codes per round
   and the stage times beside the bench slice's.

The third-to-last stdout line repeats the card's name and power limit; the
second-to-last is the kernel JSON: under "kernels" the kernels of the
served paths, each with its launch count from the path that runs it (K3 and
K2 from the production slice, K1 from the bench slice, K6 and K7 from the
spec slice; `launches_by_path` has all three), its largest error against
the plain version, both times, its bound and `library_ms` (null where no
one PyTorch call computes the function: K1, K2, K3, K6; K7's is
`torch._weight_int4pack_mm` at the loader's GEMVs); under "off_path" K4,
which no flagship slice reaches, with the time of
`torch._weight_int8pack_mm` as its `library_ms` where the build has it.
The last line is `{"ok": true, "device": {...}}`.
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
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


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


def check_k4(torch, dev, results):
    from voice_tts_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(2)
    worst, shapes = 0.0, []
    D = 1280
    # bf16 output: sums in another order may round one bf16 ulp apart
    tol = 2 ** -7
    for n in (1, 8, 32):
        for f in (1280, 3840, 5120):
            x = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
            w = torch.randint(-127, 128, (D, f), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand(1, f, generator=g, device=dev) * 1e-3 + 1e-4
            y = im.int8_gemv(x, w, s)
            torch.cuda.synchronize()
            y_p = im.int8_gemv_plain(x, w, s)
            err = max_err(torch, y, y_p)
            scale = float(y_p.float().abs().max())
            print(f"K4 N={n} F={f}: max_abs_err {err:.4g} (max|ref| {scale:.4g}, "
                  f"tol {tol:.4g} * max|ref|)")
            if not err <= tol * scale:
                fail(f"K4 int8_gemv N={n} F={f} disagrees with the plain version")
            worst = max(worst, err)
            ms = cuda_time_ms(torch, lambda: im.int8_gemv(x, w, s), 50)
            plain_ms = cuda_time_ms(torch, lambda: im.int8_gemv_plain(x, w, s), 50)
            # the library's int8 weight-only product: the same function on
            # the same values, w as (F, D) and the scales in bf16
            w_t, s_b = w.t().contiguous(), s.reshape(-1).to(torch.bfloat16)
            lib_ms = library_time_ms(
                torch, lambda: torch._weight_int8pack_mm(x, w_t, s_b), 50)
            # x and s read, w read, the bf16 output written; 2 N D F operations
            b = bound(nbytes(x, w, s) + n * f * 2, 2 * n * D * f)
            print(f"K4 N={n} D={D} F={f}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
                  f"bound {b['bound_ms']:.4f} ms, library {lib_ms} ms")
            shapes.append({"n": n, "d": D, "f": f, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, **b})
    total = bound(sum(t["bound_bytes"] for t in shapes),
                  sum(t["bound_ops"] for t in shapes))
    lib_times = [t["library_ms"] for t in shapes]
    results.append({
        "name": "int8_gemv", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/int8_gemv.cu",
        "replaces": "voice_tts_tpu/ops/int8_matmul.py:44",
        "max_abs_err": worst, "ms": sum(t["ms"] for t in shapes),
        "plain_ms": sum(t["plain_ms"] for t in shapes),
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
        "library_ms": None if None in lib_times else sum(lib_times),
        "library_call": "torch._weight_int8pack_mm",
        "ms_of": "sum over the 9 (N, F) shapes", "shapes": shapes})


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


def _tiny_pair(torch, dev, **flags):
    """The tiny engine with `flags` on the CPU (plain versions) and on the
    card (every kernel launched), with the same random weights."""
    import copy

    from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config

    base = TTSEngine.tiny(device="cpu", seed=0)
    cfg = tiny_config(**flags)
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


def check_tiny_engine(torch, dev):
    """End-to-end reference on a small input, bench-like flags: the tiny
    engine on the card (K1, K2, K4 on its int8 prefill) against the same
    weights on the CPU (plain versions), greedy, same CFM noise."""
    cpu, gpu = _tiny_pair(torch, dev, use_int8_decode=True, use_fused_decode=True,
                          fold_readout=True, use_fp16=True, fuse_pipeline=True)
    prompt = tone_prompt(1.0, 16000)
    ref = cpu.infer(prompt, "hello world.", do_sample=False)
    out = gpu.infer(prompt, "hello world.", do_sample=False)
    torch.cuda.synchronize()
    _compare_wavs("tiny engine (num_beams 1)", ref, out, WAV_TOL)


# bf16 conditioning: cuBLAS and the CPU round the bf16 products at other
# points; one bf16 ulp is 2^-8 of a value, compounded over a few layers
COND_TOL = 3e-2


def check_tiny_engine_production(torch, dev):
    """The tiny engine under the production flags (beam-3 through K3 with the
    ancestor table, int8 KV, folded readout, bf16 GPT and conditioning,
    masters released) on the card against the CPU, greedy, same weights and
    CFM noise.  The card's own bf16 conditioning is held against the CPU's
    (COND_TOL); the decode and synthesis then start from the CPU's
    conditioning on both, so that the comparison is of the beam kernels and
    the synthesis."""
    flags = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                 use_fused_beam_decode=True, use_int8_kv=True, fold_readout=True,
                 use_bf16_conditioning=True, release_master_trees=True,
                 fuse_pipeline=True)
    cpu, gpu = _tiny_pair(torch, dev, **flags)
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
    out = gpu.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    torch.cuda.synchronize()
    _compare_wavs("tiny engine (production, beam-3)", ref, out, WAV_TOL)


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


def serve_three(torch, engine, profile: str, counters):
    """Serve `engine` over HTTP from a background thread: GET /health, GET
    /debug/worker-info, then three POST /tts with the counters set to 0
    just before and read just after.  Returns (launches, decode steps,
    AA activations per vocode, prompt, text, each request's metrics)."""
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
        prompt_hex = tone_prompt(5.0, 22050).hex()
        text = "欢迎大家来体验这个语音合成系统谢谢大家."
        counters.reset()
        steps, metrics = 0, []
        for i in range(3):
            t1 = time.perf_counter()
            status, body = http(port, "POST", "/tts", json.dumps(
                {"text": text, "spk_audio": prompt_hex}).encode())
            wall = time.perf_counter() - t1
            if status != 200:
                fail(f"[{profile}] POST /tts #{i} -> {status}: {body[:500]!r}")
            resp = json.loads(body)
            wav, sr = decode_audio_bytes(bytes.fromhex(resp["audio_hex"]))
            if sr != 22050 or wav.size == 0 or not np.all(np.isfinite(wav)):
                fail(f"[{profile}] POST /tts #{i}: bad WAV (sr {sr}, {wav.size} samples)")
            m = engine.last_metrics
            metrics.append(dict(m))
            steps += m["decode_steps"]
            print(f"[{profile}] POST /tts #{i}: 200, {wav.size} samples "
                  f"({resp['audio_length']:.3f} s), rtf {resp['rtf']:.4f} (server), "
                  f"wall {wall:.3f} s, timers "
                  + json.dumps({k: round(v, 4) for k, v in m.items()}))
        launches = counters.snapshot()
    finally:
        server.stop()
        service.close()
    print(f"[{profile}] launches over 3 requests: {launches} (decode steps "
          f"{steps}, {n_act} AA activations per vocode)")
    return launches, steps, n_act, bytes.fromhex(prompt_hex), text, metrics


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
    launches, steps, n_act, prompt, text, _ = serve_three(torch, engine, "serving",
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
    return launches


def run_bench_slice(torch, dev, counters):
    """The flagship engine in the bench configuration (`--profile bench`):
    sampling, one beam through K1."""
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config

    t0 = time.perf_counter()
    engine = TTSEngine.random(bench_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[bench] engine build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, steps, n_act, _, _, metrics = serve_three(torch, engine, "bench",
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
    launches, steps, n_act, prompt, text, metrics = serve_three(torch, engine, "spec",
                                                                counters)
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
    check_tiny_engine(torch, dev)
    check_tiny_engine_production(torch, dev)
    check_tiny_engine_spec(torch, dev)
    by_path = {"serving": run_production_slice(torch, dev, counters)}
    torch.cuda.empty_cache()
    by_path["bench"], bench_metrics = run_bench_slice(torch, dev, counters)
    torch.cuda.empty_cache()
    by_path["spec"] = run_spec_slice(torch, dev, counters, bench_metrics)
    # each kernel's launches come from the path that runs it: K3 and K2 from
    # the production slice, K1 from the bench slice, K6 and K7 from the spec
    # slice; K4 serves int8 products of <= 32 rows, the tiny engines' prefill,
    # not the flagship slices (their prefill has 84 rows), and is reported
    # beside the paths' kernels
    owner = {"fused_decode_step": "bench", "fused_decode_verify": "spec",
             "fused_decode_int4": "spec"}
    on_path, off_path = [], []
    for r in results:
        r["launches"] = by_path[owner.get(r["name"], "serving")][r["name"]]
        r["launches_by_path"] = {p: by_path[p][r["name"]] for p in by_path}
        (off_path if r["name"] == "int8_gemv" else on_path).append(r)
    print(card)
    print(json.dumps({"kernels": on_path, "off_path": off_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
