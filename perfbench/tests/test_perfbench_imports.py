"""Nothing a run imports is JAX, flax or the JAX package, compared by whole
top-level names (the port `voice_tts_tpu_torch` begins with the JAX
package's name and passes); the reference imports nothing of the program."""

import json
import subprocess
import sys
import textwrap

from helpers import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "voice_tts_tpu"}


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                              "OMP_NUM_THREADS": "2", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_check_compares_whole_names():
    sys.path.insert(0, str(REPO / "perfbench"))
    import run
    before = dict(sys.modules)
    try:
        sys.modules["voice_tts_tpu_torch_fake"] = object()
        assert "voice_tts_tpu" not in run.jax_modules()
        sys.modules["voice_tts_tpu.engine"] = object()
        assert run.jax_modules() == ["voice_tts_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_whole_run_imports_no_jax(tmp_path):
    """A tiny cell run end to end on the CPU, then the top-level names of
    every loaded module."""
    got = _run(f"""
        import json, sys, time
        sys.path.insert(0, {str(REPO / 'perfbench' / 'tests')!r})
        from helpers import make_root, run_tiny
        out = run_tiny(make_root({str(tmp_path)!r}), trace=True)
        names = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"names": names, "correct": out["result"]["correct"]}}))
    """)
    assert not FORBIDDEN & set(got["names"])
    assert "voice_tts_tpu_torch" in got["names"]


def test_reference_imports_nothing_of_the_program():
    got = _run("""
        import json, sys
        import perfbench.reference.indextts2.pipeline
        import perfbench.reference.indextts2.weights
        import perfbench.costs, perfbench.judge, perfbench.traffic, perfbench.trace
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not (FORBIDDEN | {"voice_tts_tpu_torch"}) & set(got)
