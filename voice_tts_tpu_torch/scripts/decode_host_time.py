"""Time the flagship decode loop request by request: each request's
`gpt_gen_time`, `s2mel_time`, decode steps and RTF, and the host time of
every call of one kernel wrapper (K3 on the production profile's beam
steps, K1 on the bench profile's one-beam steps; on the spec profile, the
bench configuration with `spec_decode_k = 4`, the int4 K1 draft chain and
the K6 verify chain of each round; on the dit profile, `dit_config()` with
a 2.5 s prompt (T 704), the K8 trunk chain of each Euler step; on the k5
profile, `k5_config()`, the K5 attention of each layer and decode step),
that is the time its wrapper takes to check its inputs and enqueue its
launches.  The rest of a step's wall time is the beam, sampling or
acceptance logic, the other launches, syncs and the device's tail.  One
JSON line a request; the first request of a profile is the cold one.

Where the package runs its loops on the device (`engine/device_loop.py`:
every decode a chunk of steps (spec decode a chunk of rounds) at a time,
the CFM solve once), a
wrapper runs its Python only when a graph is captured, and a row also has
the host time of each graph replay (`replay_*`: a decode chunk, or a
solve), the host reads of the loops' flags (`host_reads`), the decode's
chunks and runs, the capture time of the request and the graphs captured
so far.  On the CPU a chunk runs op by op, one chain call a step it
executes.  `--chunk 4 8 16` sweeps the steps a chunk (a fresh set of
graphs each, its first request capturing them); `--profile` adds one warm
request a profile under the CUDA profiler: the device's busy time (the
union of the kernels' spans) and the kernels' summed time against the
request's wall, and the idle share.

Two profiles time no request.  `rates` times the decode steps that
`TTSEngine._should_batch_segments` weighs (`engine.DECODE_STEP_MS`) on
the bench configuration: "k1" the one-row K1 device loop, "k3_batch" the
batched sampling decode of 4 rows through K3 at one shared position
(`decode(fused_batch=True)`), "eager" the unfused step of 4 rows in its
device loop; a warm-up run, then `--requests` timed runs, one line a rate
(ms a step: the median, min and max of wall / steps).  `memory` serves
the production configuration's `infer_batch` of 2 and of 4 requests
(beam-3: 6 and 12 K3 rows) in two text buckets from a fresh engine at
the full code cap, each group's reduced-cap decode retried at the cap as
random weights never stop; one line a group with the device memory
allocated, peak and reserved after it and the graphs held.

    python -m voice_tts_tpu_torch.scripts.decode_host_time [--profiles
        production bench spec dit k5 rates memory] [--requests 3]
        [--chunk N ...] [--profile] [--device cuda]

It times the `voice_tts_tpu_torch` that comes first on the path, so one copy
of the script times another checkout of the package alike: run it by file
path with PYTHONPATH set to that checkout, and alternate the two checkouts
(A B B A) in one session on one card.  `--tiny --device cpu` runs the tiny
engine on the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

import voice_tts_tpu_torch
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.engine import post
from voice_tts_tpu_torch.engine.engine import (TTSEngine, bench_config, serving_config,
                                               tiny_config)
from voice_tts_tpu_torch.models.gpt import beam, decode, gpt2
from voice_tts_tpu_torch.ops import dit_blocks

try:
    from voice_tts_tpu_torch.engine import device_loop
except ImportError:     # a checkout from before the device loops
    device_loop = None

TEXT = "欢迎大家来体验这个语音合成系统谢谢大家."
# the kernel wrapper each profile times, as its caller names it (the spec
# profile's K1 chain is the int4 draft step; the DiT calls K8 through the
# module, the unfused decode step K5 by name)
CHAINS = {"production": (beam, "fused_decode_step_batch"),
          "bench": (decode, "fused_decode_step"),
          "spec": (decode, "fused_decode_step"),
          "dit": (dit_blocks, "dit_block_chain"),
          "k5": (gpt2, "decode_attention")}
# the second chain a profile times: the spec round's verify (K6)
VERIFY = {"spec": (decode, "fused_decode_verify")}
# the tiny engine with the production flags: K3 with the ancestor table,
# int8 KV, folded readout (beam-3 is asked of `infer`); the spec profile
# drops int8 KV (spec decode refuses it)
TINY_FLAGS = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                  use_fused_beam_decode=True, use_int8_kv=True, fold_readout=True)
TINY_SPEC_FLAGS = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                       spec_decode_k=4)
# the bench flags of the tiny engine (one beam through K1)
TINY_BENCH_FLAGS = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                        fold_readout=True)
# prompt seconds of each flagship profile: 2.5 s puts the DiT slice at T 704,
# the K8 trunk (prompt bucket 256 + mel bucket 448)
PROMPT_S = {"dit": 2.5}
# the rates profile: the rows of the batched rates, and the decode steps of
# the K1 / K3 runs and of the eager run (its unfused step is the slowest)
RATE_ROWS, RATE_STEPS, EAGER_STEPS = 4, 255, 32
# the memory profile: a text of each of two text buckets (32 and 64 tokens
# on the flagship), and the group sizes (beam-3: 6 and 12 K3 rows)
MEMORY_TEXTS = (TEXT, TEXT + TEXT)
MEMORY_GROUPS = (2, 4)


def tone_prompt(seconds: float, sr: int) -> bytes:
    """A two-tone prompt WAV (as bench.py builds it)."""
    t = np.arange(int(seconds * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    return encode_wav_int16(tone * 32767, sr)


def timed(module, name: str, record: list):
    """Wrap `module.name` so that each call's host seconds go to `record`;
    returns the function that puts the original back."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        record.append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def host_ms(prefix: str, calls: list) -> dict:
    """Count, mean and median host milliseconds of one chain's calls."""
    return {f"{prefix}_calls": len(calls),
            f"{prefix}_host_ms_mean": 1e3 * statistics.fmean(calls) if calls else None,
            f"{prefix}_host_ms_median": 1e3 * statistics.median(calls) if calls else None}


def run_profile(profile: str, requests: int, dev: torch.device, tiny: bool,
                chunks=(None,), profiled: bool = False) -> list:
    """A cold request and `requests` warm ones on a fresh random engine
    (seed 0, as `chip_smoke.py` builds its slices), for each steps-a-chunk
    in `chunks` (None: the package's own) on a fresh set of graphs; then,
    with `profiled`, one more warm request under the profiler."""
    if tiny:
        engine = TTSEngine.random(tiny_profile(profile), device=str(dev), seed=0)
        prompt = tone_prompt(1.0, 16000)
        kwargs = {"num_beams": 3 if profile == "production" else 1}
    else:
        engine = TTSEngine.random(flagship_profile(profile), device=str(dev), seed=0)
        prompt, kwargs = tone_prompt(PROMPT_S.get(profile, 5.0), 22050), {}
    module, name = CHAINS[profile]
    rows = []
    for chunk in chunks:
        if chunk is not None:
            device_loop.CHUNK = chunk
            if getattr(engine, "loops", None) is not None:
                engine.loops = device_loop.DeviceLoops(dev)
        for i in range(requests + 1):
            rows.append(timed_request(engine, profile, prompt, kwargs, module, name))
            rows[-1].update(request=i, cold=i == 0)
            if device_loop is not None:
                rows[-1]["chunk"] = device_loop.CHUNK
            print(json.dumps(rows[-1]), flush=True)
    if profiled and dev.type == "cuda":
        print(json.dumps(profile_request(engine, profile, prompt, kwargs)), flush=True)
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def timed_request(engine, profile: str, prompt: bytes, kwargs: dict, module,
                  name: str) -> dict:
    """One request with its chain wrapper (and the verify's, and the
    graph replays) timed; the row of `run_profile`."""
    calls, verify_calls, replays, reads = [], [], [], []
    restore = [timed(module, name, calls)]
    if profile in VERIFY:
        restore.append(timed(*VERIFY[profile], verify_calls))
    if device_loop is not None:
        restore.append(timed(device_loop.DeviceLoops, "_replay", replays))
        restore.append(timed(device_loop, "read_flag", reads))
    loops = getattr(engine, "loops", None)
    graphs_before = loops.stats["graphs"] if loops is not None else 0
    try:
        t0 = time.perf_counter()
        engine.infer(prompt, TEXT, **kwargs)
        wall = time.perf_counter() - t0
    finally:
        for put_back in reversed(restore):
            put_back()
    m = engine.last_metrics
    steps = m["decode_steps"]
    row = {"profile": profile, "gpt_gen_time": m["gpt_gen_time"],
           "s2mel_time": m["s2mel_time"], "wall_s": wall, "decode_steps": steps,
           "rtf": m["rtf"], "step_ms": 1e3 * m["gpt_gen_time"] / max(steps, 1),
           **host_ms("chain", calls)}
    if profile in VERIFY:
        row.update(spec_rounds=m["spec_rounds"], spec_accepted=m["spec_accepted"],
                   **host_ms("verify", verify_calls))
    if device_loop is not None:
        row.update(decode_runs=m["decode_runs"], decode_chunks=m["decode_chunks"],
                   host_reads=len(reads), **host_ms("replay", replays))
        if loops is not None:
            row.update(capture_s=m["capture_time"], graphs=loops.stats["graphs"],
                       graphs_captured=loops.stats["graphs"] - graphs_before)
    return row


def busy_seconds(prof) -> float:
    """Seconds in which at least one kernel or copy ran on the device: the
    union of their spans (under programmatic dependent launch neighbouring
    kernels overlap, so the sum of their times overcounts)."""
    from torch.autograd import DeviceType

    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6


def profile_request(engine, profile: str, prompt: bytes, kwargs: dict) -> dict:
    """One warm request under the CUDA profiler: the device's busy time (the
    union of the kernels' spans) and the kernels' summed time against the
    request's wall, and the idle share."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer(prompt, TEXT, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_seconds(prof)
    m = engine.last_metrics
    return {"profile": profile, "profiled": True, "wall_s": wall, "device_busy_s": busy,
            "kernel_sum_s": sum(e.self_device_time_total for e in prof.key_averages()) / 1e6,
            "device_idle_share": 1.0 - busy / wall, "gpt_gen_time": m["gpt_gen_time"],
            "s2mel_time": m["s2mel_time"], "decode_steps": m["decode_steps"]}


def decode_inputs(engine: TTSEngine, rows: int):
    """The two-tone prompt's conditioning and TEXT, repeated over `rows`
    rows: the arguments of `decode` after the model and config."""
    spk, emovec, segments = engine._prepare(tone_prompt(5.0, 22050), None, 1.0, None,
                                            False, TEXT, 120)
    ids = engine.tokenizer.convert_tokens_to_ids(segments[0])
    bucket = post.pick_bucket(len(ids), engine.cfg.engine.text_buckets)
    ids = ids[:bucket]
    text = torch.zeros((rows, bucket), dtype=torch.long)
    text[:, :len(ids)] = torch.tensor(ids)
    lens = torch.full((rows,), len(ids), dtype=torch.long)
    return (spk["cond_latents"].expand(rows, -1, -1).contiguous(),
            emovec.expand(rows, -1).contiguous(), text.to(engine.device),
            lens.to(engine.device))


def step_rate(engine: TTSEngine, name: str, rows: int, steps: int, repeats: int,
              **decode_kwargs) -> dict:
    """ms a step of `decode` over `rows` rows for at most `steps` steps: a
    warm-up run (it captures the graphs), then `repeats` timed runs."""
    args = decode_inputs(engine, rows)
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    per_step, runs = [], []
    for i in range(repeats + 1):
        sync()
        t0 = time.perf_counter()
        res = decode.decode(engine.gpt_rt, engine.cfg.generation, *args, steps,
                            engine.generator, loops=engine.loops, **decode_kwargs)
        sync()
        wall = time.perf_counter() - t0
        if i:
            per_step.append(1e3 * wall / max(res.steps, 1))
            runs.append(res.steps)
    return {"profile": "rates", "rate": name, "rows": rows,
            "step_ms": statistics.median(per_step), "step_ms_min": min(per_step),
            "step_ms_max": max(per_step), "steps": runs}


def run_rates(dev: torch.device, tiny: bool, repeats: int) -> list:
    """The three decode step times of `engine.DECODE_STEP_MS` on a fresh
    engine of the bench configuration (the tiny engine's bench flags)."""
    cfg = tiny_config(**TINY_BENCH_FLAGS) if tiny else bench_config()
    engine = TTSEngine.random(cfg, device=str(dev), seed=0)
    packs = dict(fused_pack=engine.fused_pack, readout_pack=engine.readout_pack)
    steps = min(RATE_STEPS, cfg.generation.max_mel_tokens)     # the tiny GPT's 64
    rows = [step_rate(engine, "k1", 1, steps, repeats, **packs),
            step_rate(engine, "k3_batch", RATE_ROWS, steps, repeats, fused_batch=True,
                      **packs),
            step_rate(engine, "eager", RATE_ROWS, min(EAGER_STEPS, steps), repeats)]
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def run_memory(dev: torch.device, tiny: bool) -> list:
    """`infer_batch` of each group size of MEMORY_GROUPS in each text of
    MEMORY_TEXTS on a fresh production engine (the tiny engine's production
    flags), greedy beam-3, at the full code cap; one row a group with the
    device memory after it in GiB (None off the card)."""
    cfg = tiny_config(**TINY_FLAGS) if tiny else serving_config()
    cfg.generation.do_sample = False
    cfg.generation.num_beams = 3
    engine = TTSEngine.random(cfg, device=str(dev), seed=0)
    prompt = tone_prompt(1.0, 16000) if tiny else tone_prompt(5.0, 22050)
    card = dev.type == "cuda"
    rows = []
    for text in MEMORY_TEXTS:
        for n in MEMORY_GROUPS:
            t0 = time.perf_counter()
            engine.infer_batch([{"spk_audio_prompt": prompt, "text": text}] * n)
            m = engine.last_metrics
            tokens = len(engine.tokenizer.tokenize(text))
            row = {"profile": "memory", "requests": n, "rows": 3 * n,
                   "text_bucket": post.pick_bucket(tokens, cfg.engine.text_buckets),
                   "wall_s": time.perf_counter() - t0,
                   "gpt_gen_time": m["gpt_gen_time"], "decode_runs": m["decode_runs"],
                   "decode_steps": m["decode_steps"],
                   "graphs": engine.loops.stats["graphs"] if engine.loops else 0}
            for name, fn in (("allocated_gib", "memory_allocated"),
                             ("max_allocated_gib", "max_memory_allocated"),
                             ("reserved_gib", "memory_reserved")):
                row[name] = getattr(torch.cuda, fn)() / 2**30 if card else None
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def flagship_profile(profile: str):
    """The flagship configuration of `profile`: the server default
    (production), or `bench_config()` with spec decode (spec), with bf16
    s2mel, the K8 trunk and K9 attention (dit: `chip_smoke.py`'s DiT
    slice), or with `pallas_decode_attention` and the fused vocoder (k5:
    its K5 slice).  Built here from the engine's public configs, so the
    script times an older checkout of the package alike."""
    if profile == "production":
        return serving_config()
    cfg = bench_config()
    if profile == "spec":
        cfg.engine.spec_decode_k = 4
    elif profile == "dit":
        cfg.engine.use_bf16_s2mel = True
        cfg.s2mel.dit.fused_blocks = cfg.s2mel.dit.fused_attention = True
    elif profile == "k5":
        cfg.gpt.pallas_decode_attention = True
        cfg.engine.use_fused_vocoder = True
    return cfg


def tiny_profile(profile: str):
    """The tiny engine's configuration for `profile`: the production flags,
    spec decode, or the bench flags with the dit profile's DiT (widened to
    D 256, 4 heads: the K8 trunk's 64-wide heads) and flags, or the k5
    profile's `pallas_decode_attention`."""
    if profile in ("production", "spec"):
        return tiny_config(**(TINY_SPEC_FLAGS if profile == "spec" else TINY_FLAGS))
    if profile == "dit":
        cfg = tiny_config(use_bf16_s2mel=True, **TINY_BENCH_FLAGS)
        d = cfg.s2mel.dit
        d.hidden_dim, d.num_heads = 256, 4
        d.fused_blocks = d.fused_attention = True
        cfg.s2mel.wavenet.hidden_dim = d.hidden_dim
        return cfg
    cfg = tiny_config(**TINY_BENCH_FLAGS)
    if profile == "k5":
        cfg.gpt.pallas_decode_attention = True
    return cfg


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except OSError:
        return torch.cuda.get_device_name(0)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profiles", nargs="+", default=["production", "bench"],
                    choices=list(CHAINS) + ["rates", "memory"])
    ap.add_argument("--requests", type=int, default=3,
                    help="warm requests after the cold one, per profile")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain versions)")
    ap.add_argument("--tiny", action="store_true", help="the tiny engine")
    ap.add_argument("--chunk", nargs="+", type=int, default=[None],
                    help="decode steps a chunk to sweep (the device loops)")
    ap.add_argument("--profile", action="store_true",
                    help="one more warm request a profile under the CUDA profiler")
    args = ap.parse_args(argv)
    if args.chunk != [None] and device_loop is None:
        raise SystemExit("--chunk: this checkout has no device loops")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script times the GPU decode "
                         "loop (--tiny --device cpu runs the plain versions)")
    print(f"package: {os.path.dirname(voice_tts_tpu_torch.__file__)}; device: "
          + (card_line() if dev.type == "cuda" else "cpu, plain versions"), flush=True)
    rows = []
    for profile in args.profiles:
        if profile == "rates":
            rows += run_rates(dev, args.tiny, args.requests)
        elif profile == "memory":
            rows += run_memory(dev, args.tiny)
        else:
            rows += run_profile(profile, args.requests, dev, args.tiny, args.chunk,
                                args.profile)
    return rows


if __name__ == "__main__":
    main()
