"""Time the flagship decode loop request by request: each request's
`gpt_gen_time`, decode steps and RTF, and the host time of every call of the
decode step's CUDA chain (K3 on the production profile's beam steps, K1 on
the bench profile's one-beam steps; on the spec profile, the bench
configuration with `spec_decode_k = 4`, the int4 K1 draft chain and the K6
verify chain of each round), that is the time its wrapper takes to check
its inputs and enqueue a step's launches.  The rest of a step's wall time
is the beam, sampling or acceptance logic, its syncs and the device's tail.
One JSON line a request; the first request of a profile is the cold one.

    python -m voice_tts_tpu_torch.scripts.decode_host_time [--profiles
        production bench spec] [--requests 3] [--device cuda]

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
from voice_tts_tpu_torch.engine.engine import (TTSEngine, bench_config, serving_config,
                                               tiny_config)
from voice_tts_tpu_torch.models.gpt import beam, decode

TEXT = "欢迎大家来体验这个语音合成系统谢谢大家."
# the decode-step chain of each profile, as its decode loop names it (the
# spec profile's K1 chain is the int4 draft step)
CHAINS = {"production": (beam, "fused_decode_step_batch"),
          "bench": (decode, "fused_decode_step"),
          "spec": (decode, "fused_decode_step")}
# the second chain a profile times: the spec round's verify (K6)
VERIFY = {"spec": (decode, "fused_decode_verify")}
# the tiny engine with the production flags: K3 with the ancestor table,
# int8 KV, folded readout (beam-3 is asked of `infer`); the spec profile
# drops int8 KV (spec decode refuses it)
TINY_FLAGS = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                  use_fused_beam_decode=True, use_int8_kv=True, fold_readout=True)
TINY_SPEC_FLAGS = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
                       spec_decode_k=4)


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


def run_profile(profile: str, requests: int, dev: torch.device, tiny: bool) -> list:
    """A cold request and `requests` warm ones on a fresh random engine
    (seed 0, as `chip_smoke.py` builds its slices)."""
    if tiny:
        flags = TINY_SPEC_FLAGS if profile == "spec" else TINY_FLAGS
        engine = TTSEngine.random(tiny_config(**flags), device=str(dev), seed=0)
        prompt = tone_prompt(1.0, 16000)
        kwargs = {"num_beams": 3 if profile == "production" else 1}
    else:
        cfg = serving_config() if profile == "production" else bench_config()
        if profile == "spec":
            cfg.engine.spec_decode_k = 4
        engine = TTSEngine.random(cfg, device=str(dev), seed=0)
        prompt, kwargs = tone_prompt(5.0, 22050), {}
    module, name = CHAINS[profile]
    rows = []
    for i in range(requests + 1):
        calls, verify_calls = [], []
        restore = [timed(module, name, calls)]
        if profile in VERIFY:
            restore.append(timed(*VERIFY[profile], verify_calls))
        try:
            engine.infer(prompt, TEXT, **kwargs)
        finally:
            for put_back in reversed(restore):
                put_back()
        m = engine.last_metrics
        steps = m["decode_steps"]
        row = {"profile": profile, "request": i, "cold": i == 0,
               "gpt_gen_time": m["gpt_gen_time"], "decode_steps": steps, "rtf": m["rtf"],
               "step_ms": 1e3 * m["gpt_gen_time"] / max(steps, 1), **host_ms("chain", calls)}
        if profile in VERIFY:
            row.update(spec_rounds=m["spec_rounds"], spec_accepted=m["spec_accepted"],
                       **host_ms("verify", verify_calls))
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


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
                    choices=list(CHAINS))
    ap.add_argument("--requests", type=int, default=3,
                    help="warm requests after the cold one, per profile")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain versions)")
    ap.add_argument("--tiny", action="store_true", help="the tiny engine")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script times the GPU decode "
                         "loop (--tiny --device cpu runs the plain versions)")
    print(f"package: {os.path.dirname(voice_tts_tpu_torch.__file__)}; device: "
          + (card_line() if dev.type == "cuda" else "cpu, plain versions"), flush=True)
    rows = []
    for profile in args.profiles:
        rows += run_profile(profile, args.requests, dev, args.tiny)
    return rows


if __name__ == "__main__":
    main()
