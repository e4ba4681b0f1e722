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
   with CUDA events: K2, K4, K1 (bf16 cache; int8 KV at pos 300 and 1500),
   K3 (beam-3 through an ancestor table with int8 KV and with a bf16 cache,
   pos 1500; eight rows at their own positions, one of them 0);
4. tiny engines: the tiny engine on the card against the same weights on
   the CPU, greedy, same CFM noise: one beam (K1), and the production flags
   (beam-3 through K3, int8 KV, bf16 conditioning);
5. production slice: the flagship engine (random weights) in the serving
   profile, the server default, behind the HTTP server in a background
   thread: GET /health, GET /debug/worker-info, three POST /tts, then one
   request under the CUDA profiler; the launch counters must show K3 once
   per beam decode step, K1 never, K2 109 times per vocode;
6. bench slice: the same with `--profile bench` (sampling, one beam): K1
   once per decode step, K3 never, K2 109 times per vocode.

The third-to-last stdout line repeats the card's name and power limit; the
second-to-last is the kernel JSON: under "kernels" the kernels of the
served paths, each with its launch count from the path that runs it (K3 and
K2 from the production slice, K1 from the bench slice; `launches_by_path`
has both), its largest error against the plain version and both times;
under "off_path" K4, which neither flagship slice reaches.  The last line
is `{"ok": true, "device": {...}}`.
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


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
        cases.append({"kv": "int8" if int8_kv else "bf16", "pos": pos,
                      "t_max": t_max, "ms": ms, "plain_ms": plain_ms})
    results.append({
        "name": "fused_decode_step", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:555",
        "max_abs_err": worst, "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
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
        print(f"{tag} L={L} D={D} H={H}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
        cases.append({"case": name, "rows": b, "kv": "int8" if int8_kv else "bf16",
                      "table": table, "ms": ms, "plain_ms": plain_ms})
    results.append({
        "name": "fused_decode_step_batch", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:1098",
        "max_abs_err": worst, "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
        "ms_of": "one beam-3 step through the table, int8 KV, pos 1500, Tmax 1792",
        "cases": cases})


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
            print(f"K4 N={n} D={D} F={f}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
            shapes.append({"n": n, "d": D, "f": f, "ms": ms, "plain_ms": plain_ms})
    results.append({
        "name": "int8_gemv", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/int8_gemv.cu",
        "replaces": "voice_tts_tpu/ops/int8_matmul.py:44",
        "max_abs_err": worst, "ms": sum(t["ms"] for t in shapes),
        "plain_ms": sum(t["plain_ms"] for t in shapes),
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
    print(f"K2 per vocode (109 activations, 448 frames): {vocode_ms:.4f} ms "
          f"kernel, {vocode_plain_ms:.4f} ms plain")
    results.append({
        "name": "aa_snake_activation", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/aa_snake.cu",
        "replaces": "voice_tts_tpu/ops/aa_activation.py:210",
        "max_abs_err": worst, "ms": vocode_ms, "plain_ms": vocode_plain_ms,
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
    AA activations per vocode, prompt, text)."""
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
        steps = 0
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
    return launches, steps, n_act, bytes.fromhex(prompt_hex), text


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
    launches, steps, n_act, prompt, text = serve_three(torch, engine, "serving", counters)
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
    launches, steps, n_act, _, _ = serve_three(torch, engine, "bench", counters)
    if launches["fused_decode_step"] != steps or steps == 0:
        fail("K1 was not launched once per decode step")
    if launches["fused_decode_step_batch"] != 0:
        fail("K3 was launched on the one-beam path")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
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
    check_tiny_engine(torch, dev)
    check_tiny_engine_production(torch, dev)
    by_path = {"serving": run_production_slice(torch, dev, counters)}
    torch.cuda.empty_cache()
    by_path["bench"] = run_bench_slice(torch, dev, counters)
    # each kernel's launches come from the path that runs it: K3 and K2 from
    # the production slice, K1 from the bench slice; K4 serves int8 products
    # of <= 32 rows, the tiny engines' prefill, not the flagship slices (their
    # prefill has 84 rows), and is reported beside the paths' kernels
    owner = {"fused_decode_step": "bench"}
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
