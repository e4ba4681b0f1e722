"""The served system with the benchmark's spans around the calls into its
layers, recorded from the benchmark's side.

`TracedService` is the program's `TTSService`; its `_infer_batch` (the
worker's call into the engine, a group of one through `infer`, a larger
group through `infer_batch`) records each call's start, end, texts and
`engine.last_metrics`, read in the same thread right after the call.

`Capture` wraps four of the engine's calls on the instance (the program's
code is unchanged) and keeps, for each engine call, what they took and gave
on the device: the GPT's teacher-forced forward (its inputs and the
latent), the s2mel (its inputs, the CFM's initial noise, the mel and the
target lengths) and the vocoder (the float waveform).  The reference judges
those after the window.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from voice_tts_tpu_torch.serving.app import TTSService


def _keep(x):
    """A detached copy of a tensor (on its device), or the value itself."""
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


class Capture:
    """Records the engine's stage inputs and outputs, and each stage's span
    (name, start, end on `time.monotonic()`), while `active`."""

    def __init__(self, engine):
        self.engine = engine
        self.active = False
        self.units: Optional[List[Dict]] = None     # the current call's
        self.spans: List[tuple] = []
        self._noise: List[torch.Tensor] = []
        gpt, eng = engine.gpt_rt, engine
        gpt_forward, s2mel, draw_noise, vocode = (gpt.forward, eng._s2mel,
                                                  eng._draw_noise, eng.vocode)

        def latent(cond_latents, emo_vec, text_tokens, text_lengths, mel_codes,
                   code_lengths):
            t0 = time.monotonic()
            out = gpt_forward(cond_latents, emo_vec, text_tokens, text_lengths,
                              mel_codes, code_lengths)
            self.span("gpt_latent", t0)
            if self.active and self.units is not None:
                self.units.append({"gpt": [_keep(t) for t in (
                    cond_latents, emo_vec, text_tokens, text_lengths, mel_codes,
                    code_lengths)], "latent": _keep(out)})
            return out

        def noise(shape):
            out = draw_noise(shape)
            if self.active:
                self._noise.append(_keep(out))
            return out

        def s2mel_call(latent_, codes, code_len, prompt_condition, prompt_len, ref_mel,
                       style, mel_bucket):
            self._noise = []
            t0 = time.monotonic()
            mel, target_len = s2mel(latent_, codes, code_len, prompt_condition,
                                    prompt_len, ref_mel, style, mel_bucket)
            self.span("s2mel", t0)
            if self.active and self.units:
                self.units[-1]["s2mel"] = {
                    "codes": _keep(codes), "code_len": _keep(code_len),
                    "prompt_condition": _keep(prompt_condition),
                    "prompt_len": _keep(prompt_len), "ref_mel": _keep(ref_mel),
                    "style": _keep(style), "mel_bucket": int(mel_bucket),
                    "noise": self._noise[-1] if self._noise else None,
                    "mel": _keep(mel), "target_len": _keep(target_len)}
            return mel, target_len

        def vocode_call(mel):
            t0 = time.monotonic()
            wav = vocode(mel)
            self.span("vocode", t0)
            if self.active and self.units:
                self.units[-1]["wave"] = _keep(wav)
            return wav

        gpt.forward = latent
        eng._draw_noise = noise
        eng._s2mel = s2mel_call
        eng.vocode = vocode_call

    def span(self, name: str, t0: float) -> None:
        """A stage's span, from the host's side (its launches, not the
        device's end, for the stages that do not synchronise)."""
        if self.active:
            self.spans.append((name, t0, time.monotonic()))


class TracedService(TTSService):
    """`TTSService` with a span a call into the engine (`calls`).

    With `trace`, the device trace (`trace.Profiler`) starts before the
    window's first engine call, on the replica's thread, and stops there
    after the window, or with `trace_seconds` after the first call that
    ends that long after the start: reading a whole window of a closed loop
    takes most of a run's time limit.  The stop reads the trace while the
    replica waits, so the per-layer metrics read the traced calls alone
    (`cell.Run.context`); an open loop, whose arrivals do not wait, traces
    its whole window."""

    def __init__(self, engine, profile: str, capture: Capture, trace: bool = False,
                 trace_seconds: Optional[float] = None, cuda: bool = True):
        super().__init__(engine, profile)
        self.capture = capture
        self.calls: List[Dict] = []
        self.recording = False
        self._lock = threading.Lock()
        self.trace, self.trace_seconds, self.cuda = trace, trace_seconds, cuda
        self.prof = None
        self.trace_span: Optional[tuple] = None     # (start, end) once stopped

    def stop_trace(self) -> None:
        """Stop the device trace if it runs (on the replica's thread; the
        stop reads the trace, tens of seconds in which the replica waits,
        after the span it ends)."""
        if self.prof is not None and self.trace_span is None:
            self.trace_span = (self._trace_t0, time.monotonic())
            self.prof.stop()

    def _infer_batch(self, engine, reqs):
        from perfbench import trace as tracing

        rec = self.recording
        if rec and self.trace and self.prof is None:
            self.prof = tracing.start(self.cuda)
            self._trace_t0 = time.monotonic()
        units: List[Dict] = []
        if rec:
            self.capture.units = units
            self.capture.active = True
        t0 = time.monotonic()
        ok = False
        try:
            out = TTSService._infer_batch(engine, reqs)
            ok = True
            return out
        finally:
            t1 = time.monotonic()
            if rec:
                self.capture.active = False
                self.capture.units = None
                self.capture.spans.append((f"engine call of {len(reqs)}, outside its latent, "
                                           "s2mel and vocode (prepare, decode)", t0, t1))
                with self._lock:
                    self.calls.append({
                        "start": t0, "end": t1, "n": len(reqs), "ok": ok,
                        "texts": [r["text"] for r in reqs],
                        "metrics": dict(engine.last_metrics), "units": units,
                        "traced": self.prof is not None and self.trace_span is None})
                if (self.trace_seconds is not None and self.prof is not None
                        and self.trace_span is None
                        and t1 - self._trace_t0 >= self.trace_seconds):
                    self.stop_trace()
