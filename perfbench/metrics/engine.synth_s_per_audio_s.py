"""Seconds of the engine's synthesis (s2mel and vocoder: `s2mel_time` +
`bigvgan_time` of `infer`, `synthesis_time` of `infer_batch`) a second of
audio served."""

from perfbench import reduce


def _synth(m):
    if "synthesis_time" in m:
        return m["synthesis_time"]
    return m.get("s2mel_time", 0.0) + m.get("bigvgan_time", 0.0)


def read(ctx):
    audio = reduce.audio_s(ctx)
    if audio <= 0 or not ctx["calls"]:
        return None
    return sum(_synth(c["metrics"]) for c in ctx["calls"]) / audio
