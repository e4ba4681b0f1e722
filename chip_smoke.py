"""Chip smoke test of the PyTorch + CUDA port (`voice_tts_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):

1. device check: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from `voice_tts_tpu_torch/csrc`;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the flagship shapes of the slice, with the tolerance printed, both timed
   with CUDA events;
4. slice: builds the flagship engine (random weights, bench decode
   settings) on cuda:0, serves it over HTTP from a background thread, sends
   GET /health and three POST /tts requests, checks the WAVs, and checks
   from the launch counters that the served requests went through the
   kernels (K1 once per decode step, K2 109 times per vocode).

The second-to-last stdout line is the kernel JSON: under "kernels" the
kernels of the served path, each with its launch count from the three
requests, its largest error against the plain version and both times;
under "off_path" K4, which the flagship slice does not reach.  The last
line is `{"ok": true, "device": {...}}`.
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

def check_k1(torch, dev, results):
    from voice_tts_tpu_torch.ops import fused_decode as fd

    L, D, H, T_MAX, POS = 24, 1280, 20, 512, 300
    V = 8194
    g = torch.Generator(device=dev).manual_seed(1)

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
    pack = fd.FusedDecodePack(w, consts)
    head = randn(V, D, std=0.02)
    state = {"mel_head.weight": head, "mel_head.bias": randn(V, std=0.02),
             "final_norm.weight": 1 + randn(D, std=0.05),
             "final_norm.bias": randn(D, std=0.02)}
    ro = fd.pack_readout(state)
    cache = randn(L, 2, 1, T_MAX, D).to(torch.bfloat16)
    bias = torch.zeros((T_MAX, 1), device=dev)
    bias[70:82] = -1e30                          # invalid prompt pads
    x = randn(1, D, std=0.5)

    hid, kv, logits = fd.fused_decode_step(x, pack, cache, bias, POS, H, ro)
    torch.cuda.synchronize()
    hid_p, kv_p, logits_p = fd.fused_decode_step_plain(x, pack, cache, bias, POS, H, ro)
    # f32 sums in another order flip single bf16 roundings of the
    # activations; across 24 layers that stays within 1e-2 of the largest
    # magnitude (the chip run records the actual error)
    tol = 1e-2
    errs = {}
    for name, a, b in (("hidden", hid, hid_p), ("kv_new", kv, kv_p),
                       ("logits", logits[:, :V], logits_p[:, :V])):
        scale = float(b.float().abs().max())
        errs[name] = max_err(torch, a, b)
        print(f"K1 {name}: max_abs_err {errs[name]:.4g} (max|ref| {scale:.4g}, "
              f"tol {tol} * max|ref|)")
        if not errs[name] <= tol * scale:
            fail(f"K1 {name} disagrees with the plain version")
    am, am_p = int(logits[0, :V].argmax()), int(logits_p[0, :V].argmax())
    print(f"K1 argmax {am} vs plain {am_p}")
    if am != am_p:
        fail("K1 logits argmax differs from the plain version")
    ms = cuda_time_ms(torch, lambda: fd.fused_decode_step(
        x, pack, cache, bias, POS, H, ro), 20)
    plain_ms = cuda_time_ms(torch, lambda: fd.fused_decode_step_plain(
        x, pack, cache, bias, POS, H, ro), 5)
    print(f"K1 fused_decode_step L={L} D={D} H={H} pos={POS} Tmax={T_MAX}: "
          f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    results.append({
        "name": "fused_decode_step", "route": "cuda",
        "source": "voice_tts_tpu_torch/csrc/fused_decode.cu",
        "replaces": "voice_tts_tpu/ops/fused_decode.py:555",
        "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
        "ms_of": f"one decode step at pos {POS}, Tmax {T_MAX}"})


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


def check_tiny_engine(torch, dev):
    """End-to-end reference on a small input: the tiny engine on the card
    (every kernel launched, K4 on its int8 prefill) against the same
    weights on the CPU (plain PyTorch versions), greedy, same CFM noise."""
    import copy

    import numpy as np
    from voice_tts_tpu_torch.engine.engine import TTSEngine

    flags = dict(use_int8_decode=True, use_fused_decode=True, fold_readout=True,
                 use_fp16=True, fuse_pipeline=True)
    cpu = TTSEngine.tiny(device="cpu", seed=0, **flags)
    gpu = TTSEngine(cpu.cfg, {k: copy.deepcopy(m) for k, m in cpu.models.items()},
                    cpu.tokenizer, device=dev)
    g = torch.Generator().manual_seed(5)
    noise = {}

    def shared_noise(shape):
        if tuple(shape) not in noise:
            noise[tuple(shape)] = torch.randn(shape, generator=g)
        return noise[tuple(shape)]
    cpu._draw_noise = lambda shape: shared_noise(shape)
    gpu._draw_noise = lambda shape: shared_noise(shape).to(dev)
    prompt = tone_prompt(1.0, 16000)
    text = "hello world."
    ref = cpu.infer(prompt, text, do_sample=False)
    out = gpu.infer(prompt, text, do_sample=False)
    torch.cuda.synchronize()
    if out.wav.shape != ref.wav.shape:
        fail(f"tiny engine: card wav {out.wav.shape} vs CPU {ref.wav.shape}")
    diff = int(np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max())
    # same codes (greedy), then f32 s2mel / vocoder on two devices: the
    # int16 samples may differ by float rounding only
    tol = 64
    steps = (ref.metrics["decode_steps"], out.metrics["decode_steps"])
    print(f"tiny engine card vs CPU: {len(out.wav)} samples, decode steps "
          f"{steps}, max |diff| {diff} LSB (tol {tol})")
    if steps[0] != steps[1] or diff > tol:
        fail("tiny engine on the card disagrees with the CPU reference")


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


def run_slice(torch, dev, counters):
    """The flagship engine served over HTTP; three /tts requests."""
    import numpy as np
    from voice_tts_tpu_torch.audio import decode_audio_bytes
    from voice_tts_tpu_torch.engine.engine import TTSEngine, bench_config
    from voice_tts_tpu_torch.serving.app import BackgroundServer, TTSService

    t0 = time.perf_counter()
    engine = TTSEngine.random(bench_config(), device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"engine build (flagship widths, random weights): "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfg = engine.cfg
    n_act = (len(cfg.vocoder.upsample_rates) * len(cfg.vocoder.resblock_kernel_sizes)
             * 2 * len(cfg.vocoder.resblock_dilation_sizes[0]) + 1)
    service = TTSService(engine)
    server = BackgroundServer(service)
    port = server.start()
    try:
        status, body = http(port, "GET", "/health")
        print(f"GET /health -> {status} {body.decode()}")
        if status != 200:
            fail("/health did not answer 200")
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
                fail(f"POST /tts #{i} -> {status}: {body[:500]!r}")
            resp = json.loads(body)
            wav, sr = decode_audio_bytes(bytes.fromhex(resp["audio_hex"]))
            if sr != 22050 or wav.size == 0 or not np.all(np.isfinite(wav)):
                fail(f"POST /tts #{i}: bad WAV (sr {sr}, {wav.size} samples)")
            m = engine.last_metrics
            steps += m["decode_steps"]
            print(f"POST /tts #{i}: 200, {wav.size} samples ({resp['audio_length']:.3f} s), "
                  f"rtf {resp['rtf']:.4f} (server), wall {wall:.3f} s, timers "
                  + json.dumps({k: round(v, 4) for k, v in m.items()}))
        launches = counters.snapshot()
    finally:
        server.stop()
        service.close()
    profile_request(torch, engine, bytes.fromhex(prompt_hex), text)
    print(f"launches over 3 requests: {launches} (decode steps {steps}, "
          f"{n_act} AA activations per vocode)")
    if launches["fused_decode_step"] != steps or steps == 0:
        fail("K1 was not launched once per decode step")
    if launches["aa_snake_activation"] != 3 * n_act:
        fail("K2 was not launched on every vocoder activation")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    check_tiny_engine(torch, dev)
    launches = run_slice(torch, dev, counters)
    on_path, off_path = [], []
    for r in results:
        r["launches"] = launches[r["name"]]
        # K4 serves int8 products of <= 32 rows: the tiny engine's prefill,
        # not the flagship slice (its prefill has 84 rows), so it is reported
        # beside the path's kernels, with the launches it got (0)
        (off_path if r["name"] == "int8_gemv" else on_path).append(r)
    print(json.dumps({"kernels": on_path, "off_path": off_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
