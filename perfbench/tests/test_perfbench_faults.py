"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped (a tiny cell on the CPU), everything
else of a run driven as it is, with one fault planted in the program where
it produces a token or an answer."""

import pytest
import torch

from helpers import make_root, run_tiny


def _repeat_codes(decode):
    """A decode whose codes after the first are the first one again."""
    def run(*args, **kwargs):
        res = decode(*args, **kwargs)
        codes = res.codes.clone()
        codes[:, 1:] = codes[:, :1]
        return res._replace(codes=codes)
    return run


def _scaled(method, pick):
    def run(self, *args, **kwargs):
        out = method(self, *args, **kwargs)
        return pick(out)
    return run


def _fault(monkeypatch, name):
    from voice_tts_tpu_torch.engine import engine as eng

    if name == "token":
        monkeypatch.setattr(eng, "beam_decode", _repeat_codes(eng.beam_decode))
    elif name == "mel":
        monkeypatch.setattr(eng.TTSEngine, "_s2mel", _scaled(
            eng.TTSEngine._s2mel, lambda out: (out[0] * 1.01, out[1])))
    elif name == "wave":
        monkeypatch.setattr(eng.TTSEngine, "vocode", _scaled(
            eng.TTSEngine.vocode, lambda out: out * 1.01))
    elif name == "conditioning":
        def cond(out):
            return {**out, "style": out["style"] * 1.01}
        monkeypatch.setattr(eng.TTSEngine, "_conditioning_forward", _scaled(
            eng.TTSEngine._conditioning_forward, cond))


@pytest.mark.parametrize("fault, number", [("token", "token_gap"), ("mel", "mel_err"),
                                           ("wave", "wave_err"),
                                           ("conditioning", "cond_err")])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, number):
    torch.manual_seed(0)
    _fault(monkeypatch, fault)
    out = run_tiny(make_root(tmp_path))
    checks = out["result"]["checks"]
    assert out["result"]["correct"] is False
    assert checks[number]["value"] > checks[number]["limit"]


def test_sound_run_is_correct(tmp_path):
    out = run_tiny(make_root(tmp_path, loop="open", beams=1), trace=True)
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert out["result"]["failed"] == 0
