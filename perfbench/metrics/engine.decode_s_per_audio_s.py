"""Seconds of the engine's decode stage (`last_metrics["gpt_gen_time"]`,
host clock after a synchronise) a second of audio served."""

from perfbench import reduce


def read(ctx):
    audio = reduce.audio_s(ctx)
    if audio <= 0 or not ctx["calls"]:
        return None
    return sum(c["metrics"].get("gpt_gen_time", 0.0) for c in ctx["calls"]) / audio
