"""The decode-loop timing script (`voice_tts_tpu_torch/scripts/decode_host_time.py`)
on the CPU: the tiny engine through each profile's decode loop, one timed
chain call a decode step (the spec profile: three draft chains and one
verify a round; the dit profile one K8 call an Euler step; the k5 profile
one K5 call a layer and step) and the timed functions put back afterwards;
the rates profile (the three decode step times, K1 and K3 each at their
row count) and the memory profile (`infer_batch` groups of 6 and 12 rows);
and without a card the default `--device cuda` exits at once."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine.engine import tiny_config
from voice_tts_tpu_torch.models.gpt import beam, decode, gpt2
from voice_tts_tpu_torch.ops import decode_attention, dit_blocks
from voice_tts_tpu_torch.scripts import decode_host_time as script

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("profile", ["production", "bench"])
def test_tiny_profile_times_each_chain_call(profile, capsys):
    """A cold and a warm request: each row counts one chain call a decode
    step its device loop executes (K3 a beam step, K1 a step; on the CPU
    every chunk runs its CHUNK steps op by op) with a positive host time,
    one host read before each decode's first chunk and one after each
    chunk, prints as one JSON line, and the decode loop gets its own
    functions back."""
    module, name = script.CHAINS[profile]
    before = getattr(module, name), device_loop.read_flag
    rows = script.main(["--tiny", "--device", "cpu", "--requests", "1",
                        "--profiles", profile])
    assert (getattr(module, name), device_loop.read_flag) == before
    assert [(r["request"], r["cold"]) for r in rows] == [(0, True), (1, False)]
    for r in rows:
        assert r["profile"] == profile and r["chunk"] == device_loop.CHUNK
        executed = r["decode_chunks"] * device_loop.CHUNK
        assert r["decode_steps"] > 0 and r["chain_calls"] == executed
        assert executed >= r["decode_steps"] > executed - r["decode_runs"] * device_loop.CHUNK
        assert r["host_reads"] == r["decode_chunks"] + r["decode_runs"]
        assert r["replay_calls"] == 0
        assert 0 < r["chain_host_ms_median"] and 0 < r["chain_host_ms_mean"]
        assert r["step_ms"] == pytest.approx(1e3 * r["gpt_gen_time"] / r["decode_steps"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out == rows


def test_tiny_spec_profile_times_drafts_and_verifies(capsys):
    """The spec profile (spec decode, K = 4): each request counts three
    timed int4 K1 draft chains and one K6 verify chain a round, both with a
    positive host time, and both functions are put back."""
    before = decode.fused_decode_step, decode.fused_decode_verify
    rows = script.main(["--tiny", "--device", "cpu", "--requests", "1",
                        "--profiles", "spec"])
    assert (decode.fused_decode_step, decode.fused_decode_verify) == before
    assert [r["request"] for r in rows] == [0, 1]
    for r in rows:
        assert r["profile"] == "spec" and r["spec_rounds"] > 0
        assert r["chain_calls"] == 3 * r["spec_rounds"]
        assert r["verify_calls"] == r["spec_rounds"]
        assert 0 < r["chain_host_ms_median"] and 0 < r["verify_host_ms_median"]
        assert 0 <= r["spec_accepted"] <= 3 * r["spec_rounds"]
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out == rows


def test_chains_name_the_decode_loops_calls():
    """Each profile's chain is the function its caller calls by name; the
    spec profile's drafts take K1, its rounds' verify K6; the dit profile
    times K8 as the DiT calls it, the k5 profile K5 as the unfused step
    does."""
    assert script.CHAINS == {"production": (beam, "fused_decode_step_batch"),
                             "bench": (decode, "fused_decode_step"),
                             "spec": (decode, "fused_decode_step"),
                             "dit": (dit_blocks, "dit_block_chain"),
                             "k5": (gpt2, "decode_attention")}
    assert script.VERIFY == {"spec": (decode, "fused_decode_verify")}
    assert callable(beam.fused_decode_step_batch) and callable(decode.fused_decode_step)
    assert callable(decode.fused_decode_verify)
    assert gpt2.decode_attention is decode_attention.decode_attention


def test_tiny_dit_profile_times_each_k8_call(capsys):
    """The dit profile (bf16 s2mel, the K8 trunk, D 256 DiT): each request
    times one K8 call an Euler step (a positive multiple of the steps),
    reports `s2mel_time`, and the DiT gets K8 back."""
    before = dit_blocks.dit_block_chain
    rows = script.main(["--tiny", "--device", "cpu", "--requests", "1",
                        "--profiles", "dit"])
    assert dit_blocks.dit_block_chain is before
    steps = tiny_config().engine.diffusion_steps
    assert [r["request"] for r in rows] == [0, 1]
    for r in rows:
        assert r["profile"] == "dit" and r["s2mel_time"] > 0
        assert r["chain_calls"] > 0 and r["chain_calls"] % steps == 0
        assert 0 < r["chain_host_ms_median"]
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out == rows


def test_tiny_k5_profile_times_each_k5_call(capsys):
    """The k5 profile (`pallas_decode_attention`): each request times one K5
    call a layer and decode step, and the decode step gets K5 back."""
    before = gpt2.decode_attention
    rows = script.main(["--tiny", "--device", "cpu", "--requests", "1",
                        "--profiles", "k5"])
    assert gpt2.decode_attention is before
    layers = tiny_config().gpt.layers
    for r in rows:
        assert r["profile"] == "k5" and r["decode_steps"] > 0
        assert r["chain_calls"] == layers * r["decode_steps"]
        assert 0 < r["chain_host_ms_median"] and r["gpt_gen_time"] > 0


def test_tiny_rates_profile_times_each_decode_arm(monkeypatch, capsys):
    """The rates profile: one line a step time of `DECODE_STEP_MS`, each a
    positive ms a step over `--requests` timed runs; "k1" steps K1 at one
    row, "k3_batch" K3 at 4 rows, "eager" neither."""
    calls = {"fused_decode_step": [], "fused_decode_step_batch": []}
    for name, seen in calls.items():
        fn = getattr(decode, name)
        monkeypatch.setattr(decode, name, lambda x, *a, _fn=fn, _seen=seen, **kw:
                            _seen.append(x.shape[0]) or _fn(x, *a, **kw))
    rows = script.main(["--tiny", "--device", "cpu", "--requests", "2",
                        "--profiles", "rates"])
    assert [(r["rate"], r["rows"]) for r in rows] == [("k1", 1), ("k3_batch", 4),
                                                      ("eager", 4)]
    for r in rows:
        assert r["profile"] == "rates" and len(r["steps"]) == 2 and min(r["steps"]) > 0
        assert 0 < r["step_ms_min"] <= r["step_ms"] <= r["step_ms_max"]
    # three decodes (warm-up and two timed) a fused arm, each a step a call
    assert set(calls["fused_decode_step"]) == {1}
    assert set(calls["fused_decode_step_batch"]) == {4}
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out == rows


def test_tiny_memory_profile_serves_each_group(capsys):
    """The memory profile: `infer_batch` of 2 and 4 requests (beam-3: 6 and
    12 K3 rows) in each of its two texts, one decode or more a group, one
    line a group; off the card the memory reads are None."""
    rows = script.main(["--tiny", "--device", "cpu", "--profiles", "memory"])
    assert [(r["requests"], r["rows"]) for r in rows] == [(2, 6), (4, 12)] * 2
    for r in rows:
        assert r["profile"] == "memory" and r["decode_runs"] >= 1
        assert r["decode_steps"] > 0 and r["gpt_gen_time"] > 0
        assert r["max_allocated_gib"] is None and r["allocated_gib"] is None
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out == rows


def test_refuses_without_cuda():
    """Without a card the default `--device cuda` exits non-zero and prints
    no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m",
                          "voice_tts_tpu_torch.scripts.decode_host_time"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "gpt_gen_time" not in out.stdout
