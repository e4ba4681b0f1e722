"""A new configuration, cell and per-layer metric are added as files (and
entries in BENCHMARK.json), and the harness finds them: no file that was
there is edited."""

import hashlib
import json

from helpers import REPO, make_root, run_tiny
from perfbench.registry import Registry


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_found(tmp_path):
    root = make_root(tmp_path)
    (root / "perfbench/metrics/test.requests_seen.py").write_text(
        '"""Requests the load generator sent."""\n\n\n'
        "def read(ctx):\n    return len(ctx['requests'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "test.requests_seen", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving", "moves": "rtf",
                               "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = _digests(REPO)
    reg = Registry(root)
    assert reg.cell("tiny.cell")["config"] == "tiny"
    assert reg.config("tiny")["reference"] == "indextts2"
    assert reg.traffic("tiny")["loop"] == "closed"
    names = [m["name"] for m in reg.per_layer("tiny.cell")]
    assert "test.requests_seen" in names and "engine.decode_s_per_audio_s" in names
    out = run_tiny(root, trace=True)["result"]
    assert out["metrics"]["test.requests_seen"]["value"] >= 1
    assert out["correct"] is True, out["checks"]
    # the repo's own files are as they were; the copy's originals too
    assert _digests(REPO) == before
    copied = _digests(root)
    assert all(copied[k] == v for k, v in before.items()
               if k in copied and not k.startswith("perfbench/tests"))


def test_cells_of_the_benchmark_have_their_files():
    reg = Registry()
    for w in reg.bench["workloads"]:
        conf = reg.config(w["config"])
        assert set(reg.limits(w["config"])) >= {"missing", "latent_err", "mel_err"}
        assert reg.traffic(w["traffic"])["loop"] in ("closed", "open", "jobs")
        assert conf["reference"] == "indextts2"
        for m in reg.per_layer(w["name"]):
            assert callable(reg.reader(m["name"]))
        assert {m["name"] for m in reg.end_to_end(w["name"])} >= {"setup_s"}
