"""The one traffic generator: a mix's data file in, a run's requests out.

A mix (`perfbench/traffic/<name>.json`) has these keys:

- `loop`: "closed" (each of `clients` clients sends its next request when
  its last reply has come), "jobs" (one client sends `job_size` requests at
  once and waits for all their replies) or "open" (requests at their due
  times, whatever the replies do);
- `rate_per_s`, `arrival_seed` (open): the offered rate; the gaps between
  arrivals are the quantiles of the exponential distribution at that rate
  (a Poisson process) in an order drawn from `arrival_seed`, so every run
  offers the same arrival times and its seed deals the texts and voices
  over them (an order drawn from the run's seed made the tail a property
  of the seed: PERF.md §6);
- `text_chars` [lo, hi]: text lengths in characters, spread evenly over the
  range and dealt in an order drawn from the seed, or from `size_seed`
  when the mix has one (jobs: a job's split over the text buckets sets
  how many decodes it runs, so every run deals the same lengths);
- `voices`: voices cached at set-up, dealt round-robin in a seed order
  (a job takes `job_size` different ones);
- `cold_every`: every n-th request brings a voice never heard before
  (0: none);
- `prompt_seconds`: the length of every voice prompt;
- `drain_s`: how long after the window's close the client waits for the
  replies still due;
- `sample`: how many finished requests a run judges against the
  reference (the longest among them);
- `trace_seconds` (closed loops): a `--trace 1` run traces the engine
  calls begun in this many seconds of the window, not all of it.

Every text is distinct within a run (the harness finds a request's rows in
the engine by its text).  Voices are seeded tones and noise, 16-bit WAV.
"""

from __future__ import annotations

import io
import math
import wave
from typing import Dict, List

import numpy as np

# the CJK unified ideographs the texts are drawn from
_CJK_LO, _CJK_HI = 0x4E00, 0x9FA5
PROMPT_SR = 22050
# closed loops and jobs draw this many requests ahead; a run sends fewer
CLOSED_AHEAD = 4096


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def voice_wav(seed: int, key: int, seconds: float) -> bytes:
    """A voice prompt: three seeded tones with vibrato and a little noise
    under an amplitude envelope, 16-bit mono WAV at 22.05 kHz."""
    rng = _rng(seed, 1000 + key)
    n = int(seconds * PROMPT_SR)
    t = np.arange(n) / PROMPT_SR
    f0 = rng.uniform(90.0, 260.0)
    x = np.zeros(n)
    for h, amp in enumerate(rng.uniform(0.2, 0.6, 3), start=1):
        vib = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(3.0, 7.0) * t)
        x += amp * np.sin(2 * np.pi * f0 * h * t * vib + rng.uniform(0, 2 * np.pi))
    x += 0.05 * rng.standard_normal(n)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * t) ** 2
    x = 0.3 * x * env / max(np.abs(x).max(), 1e-9)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(PROMPT_SR)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _lengths(lo: int, hi: int, n: int, rng) -> List[int]:
    """n lengths spread evenly over [lo, hi], in a seeded order."""
    grid = [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
    return [int(round(v)) for v in rng.permutation(grid)]


def _texts(lengths: List[int], rng) -> List[str]:
    seen, out = set(), []
    for n in lengths:
        while True:
            s = "".join(chr(c) for c in rng.integers(_CJK_LO, _CJK_HI + 1, n))
            if s not in seen:
                break
        seen.add(s)
        out.append(s)
    return out


def arrivals(rate: float, seconds: float, rng) -> List[float]:
    """Due times in [0, seconds) of a Poisson process at `rate`: the
    exponential quantiles of n = rate * seconds gaps in a seeded order."""
    n = max(1, int(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    t, out = 0.0, []
    for g in rng.permutation(gaps):
        t += g
        if t >= seconds:
            break
        out.append(t)
    return out


def schedule(mix: Dict, seed: int, seconds: float) -> List[Dict]:
    """The run's requests in sending order: {"id", "text", "voice" (a key
    of `voices`), "due" (open loops: seconds from the start), "job" (jobs)}."""
    rng = _rng(seed, 0)
    loop = mix["loop"]
    if loop == "open":
        due = arrivals(float(mix["rate_per_s"]), seconds, _rng(int(mix["arrival_seed"]), 1))
        n = len(due)
    elif loop in ("closed", "jobs"):
        due, n = None, CLOSED_AHEAD
    else:
        raise ValueError(f"unknown loop {loop!r}")
    lo, hi = mix["text_chars"]
    sizes = _rng(int(mix["size_seed"]), 2) if "size_seed" in mix else rng
    texts = _texts(_lengths(lo, hi, n, sizes), rng)
    n_voices = int(mix["voices"])
    job = int(mix.get("job_size", 1)) if loop == "jobs" else 1
    if job > n_voices:
        raise ValueError(f"a job of {job} needs {job} voices, the mix has {n_voices}")
    order = [int(v) for v in rng.permutation(n_voices)]
    cold_every = int(mix.get("cold_every", 0))
    reqs, warm = [], 0
    for i in range(n):
        if cold_every and i % cold_every == cold_every - 1:
            voice = f"cold{i}"
        else:
            voice = f"v{order[warm % n_voices]}"
            warm += 1
        r = {"id": i, "text": texts[i], "voice": voice}
        if due is not None:
            r["due"] = due[i]
        if loop == "jobs":
            r["job"] = i // job
        reqs.append(r)
    return reqs


def voices(mix: Dict, seed: int, reqs: List[Dict]) -> Dict[str, bytes]:
    """The WAV of every voice the requests name: the cached voices v0.. and
    each cold one."""
    secs = float(mix["prompt_seconds"])
    out = {f"v{k}": voice_wav(seed, k, secs) for k in range(int(mix["voices"]))}
    for r in reqs:
        if r["voice"].startswith("cold") and r["voice"] not in out:
            out[r["voice"]] = voice_wav(seed, 100000 + int(r["voice"][4:]), secs)
    return out


def warm_texts(mix: Dict, seed: int, buckets, count: int) -> List[str]:
    """`count` texts for each text bucket the mix's lengths reach (in
    characters, which the character-hash tokenizer makes tokens), none of
    them a run's text."""
    rng = _rng(seed, 7)
    lo, hi = mix["text_chars"]
    out, prev = [], 0
    for b in sorted(buckets):
        a, z = max(lo, prev + 1), min(hi, b)
        if a <= z:
            out += _texts([z] * count, rng)
        prev = b
    return out
