"""The PyTorch port imports without jax, flax or pydantic (the GPU
machine has none of them) and without the JAX package itself: it keeps its
own copies of `config`, `logging` and `text`."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
for blocked in ("jax", "flax", "pydantic", "voice_tts_tpu"):
    sys.modules[blocked] = None
import voice_tts_tpu_torch
import voice_tts_tpu_torch.cli
import voice_tts_tpu_torch.config
import voice_tts_tpu_torch.logging
import voice_tts_tpu_torch.text
import voice_tts_tpu_torch.text.native_tn
import voice_tts_tpu_torch.models.gpt.decode
import voice_tts_tpu_torch.engine.engine
import voice_tts_tpu_torch.serving.app
import voice_tts_tpu_torch.engine.continuous
import voice_tts_tpu_torch.engine.device_loop
import voice_tts_tpu_torch.ops.fused_decode
import voice_tts_tpu_torch.models.gpt.beam
import voice_tts_tpu_torch.ops.aa_activation
import voice_tts_tpu_torch.ops.int8_matmul
import voice_tts_tpu_torch.ops.decode_attention
import voice_tts_tpu_torch.ops.fused_vocoder
import voice_tts_tpu_torch.models.vocoder.packed
import voice_tts_tpu_torch.utils.convert
import voice_tts_tpu_torch.ops.micro_tile
import voice_tts_tpu_torch.ops.micro_int4
import voice_tts_tpu_torch.scripts.micro_tile
import voice_tts_tpu_torch.scripts.micro_int4
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pydantic",
                                    "voice_tts_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax_flax_pydantic():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line when CUDA is
    unavailable."""
    import torch

    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_no_port_source_imports_the_jax_package():
    """No module of the port, and not `chip_smoke.py`, names the JAX
    package (or jax / flax) in an import statement, even one reached only
    inside a function."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(voice_tts_tpu|jax|jaxlib|flax)\b",
                         re.MULTILINE)
    files = sorted((REPO / "voice_tts_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
           for m in pattern.finditer(f.read_text())]
    assert len(files) > 40 and not bad, bad
