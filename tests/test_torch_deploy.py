"""The port's serving image (`Dockerfile.torch`, `deploy/run_gpu.sh`) held
against the package on the CPU, through the parser `chip_smoke.py` uses to
run the image's command and health check on the card: the CMD is the
port's server console script with flags its `parse_args` takes; EXPOSE,
`--port` and the HEALTHCHECK name one port; VOLUME holds `--model-dir`;
the health check is the JAX image's; nothing of the JAX package or jax goes
in; the kernels and the text core are prebuilt, from sources that resolve
inside the image's layout; the HEALTHCHECK command exits 0 against a
served tiny engine and 1 without an engine; and `run_gpu.sh` runs the
image with `--gpus all` and the model directory read-only."""

import os
import re
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

import chip_smoke
from voice_tts_tpu_torch.serving import app

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def image():
    return chip_smoke.image_contract(str(REPO / "Dockerfile.torch"))


@pytest.fixture(scope="module")
def pyproject():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _parsed(image):
    return app.parse_args(image["cmd"][1:])


def test_cmd_is_the_port_server(image, pyproject):
    """The CMD's console script runs the port's server, in the production
    profile on the default card, bound to every interface."""
    assert pyproject["project"]["scripts"][image["cmd"][0]] == \
        "voice_tts_tpu_torch.serving.app:main"
    args = _parsed(image)
    assert (args.host, args.profile, args.device, args.workers, args.tiny) == \
        ("0.0.0.0", "serving", "cuda", 1, False)
    argv = chip_smoke.image_server_argv(image, str(REPO), "/data/converted", 8123)
    assert argv[1:] == ["-m", "voice_tts_tpu_torch.serving.app", "--host", "0.0.0.0",
                        "--port", "8123", "--model-dir", "/data/converted"]


def test_server_module_runs_as_main():
    """`python -m` of the console script's module reaches its `main` (the
    form `chip_smoke.py` starts the image's CMD in)."""
    out = subprocess.run([sys.executable, "-m", "voice_tts_tpu_torch.serving.app", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--model-dir" in out.stdout


def test_one_port_and_the_model_volume(image):
    args = _parsed(image)
    url_ports = re.findall(r"http://localhost:(\d+)/health", image["health"])
    assert image["expose"] == [args.port] and url_ports == [str(args.port)]
    assert image["volumes"] == [args.model_dir] == ["/models"]


def test_health_check_is_the_jax_images(image):
    jax_image = chip_smoke.image_contract(str(REPO / "Dockerfile"))
    assert image["health"] == jax_image["health"]
    assert image["health_options"] == jax_image["health_options"] == {
        "interval": "30s", "timeout": "5s", "start-period": "300s"}


def test_no_jax_in_the_image(image, pyproject):
    """No COPY of the JAX package, no jax anywhere in the RUN lines, and
    the packages pip installs are the `torch` extra's, the package itself
    without its dependencies."""
    sources = [src for args in image["copy"] for src in args[:-1]]
    assert sources and not any(Path(src).parts[0] == "voice_tts_tpu" for src in sources)
    assert not any(re.search(r"\bjax\b", run, re.I) for run in image["run"])
    installs = [re.sub(r"--index-url\s+\S+", "", cmd.split("pip install", 1)[1]).split()
                for run in image["run"] for cmd in run.split("&&") if "pip install" in cmd]
    names = {w for words in installs for w in words if not w.startswith("-")}
    extra = {re.split(r"[<>=!~ \[]", dep)[0] for dep in
             pyproject["project"]["optional-dependencies"]["torch"]}
    assert names == extra | {"."}
    assert ["--no-cache-dir", "--no-deps", "-e", "."] in installs


def test_base_image_and_prebuilds(image):
    """A CUDA devel base (nvcc, g++); the kernels and the text core built in
    the image, a text core that does not build failing it."""
    base = [rest for key, rest in chip_smoke.dockerfile(str(REPO / "Dockerfile.torch"))
            if key == "FROM"]
    assert len(base) == 1 and re.fullmatch(r"nvidia/cuda:12\.\d+\.\d+-devel-ubuntu24\.04",
                                           base[0])
    run = " && ".join(image["run"])
    assert "from voice_tts_tpu_torch.ops.build import build; build()" in run
    assert "from voice_tts_tpu_torch.text.native_tn import _build" in run
    assert "sys.exit(0 if _build() else 1)" in run
    assert run.index("rm -rf voice_tts_tpu_torch/_build") < run.index("build()")


def test_layout_resolves_the_sources(image, tmp_path):
    """The COPY lines laid out under a WORKDIR stand-in, with PYTHONPATH as
    the image sets it: the text core's source and the kernels' sources
    resolve to copied files."""
    work = tmp_path / image["workdir"].lstrip("/")
    work.mkdir(parents=True)
    assert image["env"]["PYTHONPATH"] == image["workdir"]
    skip = shutil.ignore_patterns("__pycache__", "_build")
    for *srcs, dst in image["copy"]:
        for src in srcs:
            target = work / dst / (Path(src).name if dst.endswith("/") else "")
            if (REPO / src).is_dir():
                shutil.copytree(REPO / src, target, ignore=skip)
            else:
                target.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(REPO / src, target)
    probe = ("from voice_tts_tpu_torch.text import native_tn; "
             "from voice_tts_tpu_torch.ops import build; "
             "print(native_tn._SRC); print(build.CSRC_DIR); print(len(build._sources()))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(work)))
    assert out.returncode == 0, out.stderr
    src, csrc, n = out.stdout.split()
    assert Path(src) == work / "native" / "tn_core.cpp" and Path(src).is_file()
    assert Path(csrc) == work / "voice_tts_tpu_torch" / "csrc" and int(n) > 0
    assert (work / "pyproject.toml").is_file() and (work / "README.md").is_file()


@pytest.mark.parametrize("loaded", [True, False])
def test_health_command(image, loaded):
    """The HEALTHCHECK's command, its port replaced, against the port's
    server on the CPU: 0 with a tiny engine served, 1 with none (503)."""
    service = app.TTSService()
    if loaded:
        service.load_engines(tiny=True, device="cpu")
    server = app.BackgroundServer(service)
    port = server.start()
    try:
        rc = subprocess.run(chip_smoke.image_health_argv(image, port),
                            capture_output=True, timeout=60).returncode
    finally:
        server.stop()
        service.close()
    assert rc == (0 if loaded else 1)


def _run_gpu(tmp_path, *args):
    """deploy/run_gpu.sh with a `docker` first on PATH that records its
    arguments, one call a line."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "docker.log"
    stub = bin_dir / "docker"
    stub.write_text(f'#!/bin/sh\necho "$*" >> {log}\n')
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")
    env.pop("IMAGE", None)
    env.pop("NAME", None)
    out = subprocess.run(["bash", str(REPO / "deploy" / "run_gpu.sh"), *args], env=env,
                         capture_output=True, text=True, timeout=60)
    return out, (log.read_text().splitlines() if log.exists() else [])


def test_run_gpu_syntax():
    assert subprocess.run(["bash", "-n", str(REPO / "deploy" / "run_gpu.sh")],
                          timeout=60).returncode == 0


def test_run_gpu_missing_model_dir(tmp_path):
    out, calls = _run_gpu(tmp_path, str(tmp_path / "absent"), "8123")
    assert out.returncode == 1 and "voice-tts-tpu-torch-convert --out DIR" in out.stderr
    assert calls == []


def test_run_gpu_docker_run(tmp_path):
    """`docker rm -f`, then `docker run -d` with the cards, the port and
    the model directory read-only, and no flag the TPU script lacks but
    `--gpus all` (in place of its device passthrough)."""
    models = tmp_path / "models"
    models.mkdir()
    out, calls = _run_gpu(tmp_path, str(models), "8123")
    assert out.returncode == 0, out.stderr
    assert calls == [
        "rm -f voice-tts-tpu-torch",
        f"run -d --name voice-tts-tpu-torch --restart unless-stopped --gpus all "
        f"-p 8123:8000 -v {models}:/models:ro voice-tts-tpu-torch"]
