"""A temporary benchmark root with a tiny configuration and cell, run on
the CPU through the program's plain kernel versions (for the harness's CPU
tests)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the tiny run's limits: the CPU runs the program's plain versions of the
# kernels, so every stage but the int8 GPT trunk is exact to rounding
TINY_LIMITS = {"missing": 0, "wav_len": 0, "wav_lsb": 1, "cond_err": 1e-4, "vq_err": 1e-4,
               "latent_err": 0.1, "token_gap": 0.05, "mel_err": 1e-4, "wave_err": 1e-4}


def tiny_config(beams: int = 3) -> dict:
    from voice_tts_tpu_torch.engine.engine import tiny_config as port_tiny

    cfg = port_tiny(use_int8_decode=True, use_fused_decode=True, fold_readout=True,
                    use_fused_beam_decode=True)
    cfg.generation.num_beams = beams
    return cfg.to_dict()


def make_root(tmp: Path, loop: str = "closed", beams: int = 3) -> Path:
    """A copy of the benchmark's files with a tiny configuration, mix and
    cell added as files and entries."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "perfbench/configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "profile": "serving", "reference": "indextts2",
         "assumed": [], "config": tiny_config(beams)}))
    (root / "perfbench/limits/tiny.json").write_text(json.dumps(TINY_LIMITS))
    mix = {"loop": loop, "clients": 1, "job_size": 2, "rate_per_s": 2.0, "arrival_seed": 1,
           "text_chars": [4, 20], "voices": 2, "cold_every": 3 if loop == "open" else 0,
           "prompt_seconds": 1.0, "drain_s": 30, "sample": 2}
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                             "file": "perfbench/configs/tiny.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    e2e = "latency_p90_s" if loop == "open" else "rtf"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("moves", m["name"]) == e2e and "workloads" in m:
            m["workloads"].append("tiny.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: Path, seed: int = 987654321012, seconds: float = 2.5, trace: bool = False):
    import time

    from perfbench.cell import run_cell
    return run_cell("tiny.cell", seed, seconds, trace, time.monotonic(), root, device="cpu")
