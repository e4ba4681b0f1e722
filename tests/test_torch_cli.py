"""The port's command line and the served configuration
(`voice_tts_tpu_torch/cli.py`, `serving/app.py`'s `engine_config` and
`build_engine`) against the JAX CLI and server (`voice_tts_tpu/cli.py`,
`voice_tts_tpu/serving/app.py`): the profiles (`stock` without a model
directory is `TTSConfig()` as it stands; `--tiny` ignores the profile), the
weight sources in the JAX CLI's order (`--model-dir`, then `--tiny`, then
`--random`; none of them: JAX's error line and 1, after the output and
voice checks) and `-d`.

No flagship engine is built: `TTSEngine.random` is replaced by a spy that
records the configuration and device it was given and returns one tiny CPU
engine, built once for the file."""

import asyncio
import json

import numpy as np
import pytest

from voice_tts_tpu import cli as jax_cli
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu_torch import cli
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.config import TTSConfig
from voice_tts_tpu_torch.engine.engine import (TTSEngine, bench_config, serving_config,
                                               tiny_config)
from voice_tts_tpu_torch.serving import app
from voice_tts_tpu_torch.serving.http import Request

pytest_plugins = ("port_fixtures",)

TEXT = "hello world."
# the JAX CLI's line when no weight source is given (`voice_tts_tpu/cli.py:76`)
NO_SOURCE = ("ERROR: pass --model-dir DIR (converted artifacts), or --random/--tiny "
             "for smoke tests")
FLAGSHIP = {"serving": serving_config, "bench": bench_config, "stock": TTSConfig}
# the tiny engine the slot scheduler needs (`voice_tts_tpu/serving/app.py:98-103`)
TINY_CONTINUOUS = dict(use_int8_decode=True, use_fused_decode=True)


@pytest.fixture(scope="module")
def tiny_engine():
    return TTSEngine.tiny(device="cpu")


@pytest.fixture
def built(monkeypatch, tiny_engine):
    """The (config dict, device) of each `TTSEngine.random` call; every
    call returns the file's tiny engine."""
    calls = []

    def random(cfg, device="cuda", seed=0):
        calls.append((cfg.to_dict(), str(device)))
        return tiny_engine
    monkeypatch.setattr(TTSEngine, "random", staticmethod(random))
    return calls


@pytest.fixture
def files(tmp_path):
    """(a 1 s voice prompt that exists, an output path that does not)."""
    sr = 16000
    t = np.arange(sr) / sr
    voice = tmp_path / "voice.wav"
    voice.write_bytes(encode_wav_int16((0.3 * np.sin(2 * np.pi * 220 * t)).astype(
        np.float32), sr))
    return str(voice), tmp_path / "gen.wav"


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("profile", ["serving", "bench", "stock"])
def test_engine_config(profile, tiny, continuous):
    """Each profile with and without `--tiny` and continuous batching: the
    flagship widths in the profile's configuration, or the tiny one whatever
    the profile (plus the fused int8 pack for the slot scheduler)."""
    cfg = app.engine_config(tiny, profile, continuous)
    want = (tiny_config(**(TINY_CONTINUOUS if continuous else {})) if tiny
            else FLAGSHIP[profile]())
    assert cfg.to_dict() == want.to_dict()


def test_stock_is_the_jax_servers():
    """`stock` without a directory is `TTSConfig()` unchanged, which is what
    the JAX server and CLI serve for it."""
    cfg = app.engine_config(False, "stock")
    assert cfg.to_dict() == TTSConfig().to_dict() == JaxTTSConfig().to_dict()


@pytest.mark.parametrize("model_dir", [None, "/models"])
@pytest.mark.parametrize("tiny", [False, True])
def test_unknown_profile_raises(tiny, model_dir):
    with pytest.raises(ValueError, match="unknown profile 'fast'"):
        app.engine_config(tiny, "fast", model_dir=model_dir)


@pytest.mark.parametrize("profile", app.PROFILES)
def test_model_dir_is_loaded_as_saved(profile):
    """A model directory comes before `--tiny`: no config here, the
    directory's as saved with the profile applied by `from_artifacts`."""
    assert app.engine_config(True, profile, True, model_dir="/models") is None


@pytest.mark.parametrize("profile", app.PROFILES)
def test_build_engine_without_model_dir(profile, built):
    """`build_engine` builds what `engine_config` says, `stock` included
    (it raised "'stock' needs --model-dir" before)."""
    app.build_engine(False, "cpu", profile=profile)
    assert built == [(FLAGSHIP[profile]().to_dict(), "cpu")]


def test_tiny_stock_server():
    """`--tiny --profile stock` serves the tiny engine (no warm-up), and
    `/debug/worker-info` reports it."""
    args = app.parse_args(["--tiny", "--profile", "stock", "--device", "cpu"])
    service = app.TTSService()
    try:
        service.load_engines(args.workers, tiny=args.tiny, profile=args.profile,
                             device=args.device)
        handler = service.server.routes[("GET", "/debug/worker-info")]
        resp = asyncio.run(handler(Request("GET", "/debug/worker-info", {}, b"")))
        info = json.loads(json.dumps(resp.payload, default=str))["replicas"]
        cfg = service.engines[0].cfg.to_dict()
    finally:
        service.close()
    assert cfg == tiny_config().to_dict() and service.warmup_stats == {}
    assert [(r["profile"], r["device"]) for r in info] == [("tiny", "cpu")]


@pytest.mark.parametrize("flags", [["--tiny"], ["--tiny", "--random"],
                                   ["--random", "--tiny", "--profile", "bench"],
                                   ["--tiny", "--profile", "stock"]])
def test_cli_tiny(flags, built, files, capsys):
    """`--tiny` wins over `--random` and over the profile; `-d` is
    `--device`; the WAV is written."""
    voice, out = files
    rc = cli.main([TEXT, "-v", voice, "-o", str(out), *flags, "-d", "cpu"])
    assert rc == 0 and out.stat().st_size > 44
    assert built == [(tiny_config().to_dict(), "cpu")]
    assert capsys.readouterr().out.startswith(f"wrote {out}")


@pytest.mark.parametrize("profile", app.PROFILES)
def test_cli_random(profile, built, files):
    """`--random` alone: the flagship widths in the profile's configuration
    (`stock`: `TTSConfig()`), on the device `--device` names."""
    voice, out = files
    assert cli.main([TEXT, "-v", voice, "-o", str(out), "--random", "--profile",
                     profile, "--device", "cpu"]) == 0
    assert built == [(FLAGSHIP[profile]().to_dict(), "cpu")]


def test_device_defaults_to_the_card(built, files):
    """Without `-d` the engine is asked for on `cuda`."""
    voice, out = files
    cli.main([TEXT, "-v", voice, "-o", str(out), "--tiny"])
    assert built == [(tiny_config().to_dict(), "cuda")]


@pytest.mark.parametrize("case", ["no source", "output exists", "voice missing"])
def test_cli_errors_match_jax(case, built, files, capsys):
    """With no weight source: JAX's line on stderr and 1; the output-exists
    and voice-exists checks come first, as in JAX; the same return code and
    stderr from the JAX CLI, and no engine built."""
    voice, out = files
    if case == "output exists":
        out.write_bytes(b"")
    if case == "voice missing":
        voice += ".missing"
    argv = [TEXT, "-v", voice, "-o", str(out)]
    want = {"no source": NO_SOURCE,
            "output exists": f"ERROR: output file {out} exists (use --force/-f to overwrite)",
            "voice missing": f"ERROR: voice file {voice} does not exist"}[case]
    assert cli.main(argv + ["-d", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == want
    assert jax_cli.main(argv) == 1
    assert capsys.readouterr().err.strip() == want
    assert built == []
