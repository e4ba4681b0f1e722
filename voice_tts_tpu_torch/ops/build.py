"""Build and bind the hand-written CUDA kernels under `csrc/`.

The sources are compiled at first use with `nvcc` for `sm_90a`, one
process per source in parallel, into one shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers: a build takes
seconds, not minutes).  The library lands in a build
directory keyed by the hash of the sources, so an edited source rebuilds and
an unchanged one is reused within a checkout.  Nothing here runs at import
time; a build or load failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# inside the package, listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    "vtt_aa_snake": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "vtt_sin2": [_P, _P, _I, _P],
    "vtt_int8_gemv": [_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "vtt_dq_gemv": [_P] * 4 + [_I] * 2 + [_P] * 4 + [_I] * 3 + [_P],
    "vtt_dq_gemv4": [_P] * 4 + [_I] * 2 + [_P, _I] + [_P] * 3 + [_I] * 5 + [_P],
    "vtt_decode_attend": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _P, _P, _I, _P, _I, _P, _P],
    "vtt_verify_attend": [_P] * 4 + [_I] * 5 + [_F] + [_P] * 3 + [_I] * 2 + [_P] * 2,
    "vtt_cfm_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vtt_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vtt_dit_block_chain": [_P] * 14 + [_I] * 6 + [_P],
    "vtt_dit_gemm_plan": [_I] * 3 + [_P] * 2,
    "vtt_decode_attention": [_P] * 5 + [_I] * 6 + [_F, _I, _P, _P, _P],
    "vtt_fused_resblock_stage": [_P] * 8 + [_I] * 5 + [_P] * 3 + [_F, _I, _P],
    "vtt_fused_stage_plan": [_I] * 4 + [_P],
    "vtt_micro_tile": [_P] * 4 + [_I] * 4 + [_P],
    "vtt_micro_int4": [_P] * 5 + [_I] * 4 + [_P],
}


class KernelLibrary:
    """The loaded kernel library plus how long its build took."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds

    def call(self, name: str, *args) -> None:
        """Launch through C entry `name`; raise if CUDA reports an error."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            msg = self.lib.vtt_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into a shared library; returns its path.

    One `nvcc` per source, all started together, then one link.  Every
    build keeps `ptxas -v`'s report beside its library (`ptxas_log`); an
    existing library built from identical sources is reused where its report
    is there too.  `verbose` prints a one-line summary of the report
    (registers, spills)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libvtt_kernels_{digest.hexdigest()[:16]}.so"
    if not (out.exists() and ptxas_log(out).exists()):
        _compile(out)
    if verbose:
        text = ptxas_log(out).read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
        print(f"ptxas: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, {spills} bytes of "
              f"spill stores in all")
    return out


def _compile(out: Path) -> None:
    """Build the library `out` and its ptxas report from csrc/*.cu."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    work = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}"
    work.mkdir(exist_ok=True)
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
        with open(log, "w") as f:
            jobs.append((src, obj, log, subprocess.Popen(
                [nvcc, *flags, "-c", "-o", str(obj), str(src)],
                stdout=f, stderr=subprocess.STDOUT)))
    report = []
    for src, _, log, proc in jobs:
        proc.wait()
        text = log.read_text()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{text}")
        report.append(text)
    tmp = work / out.name
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                          + [str(obj) for _, obj, _, _ in jobs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    # the report first: a library on disk always has its report beside it
    ptxas_log(out).write_text("".join(report))
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)


def ptxas_log(library: Path) -> Path:
    """Where a build keeps `ptxas -v`'s report beside its library."""
    return library.with_suffix(".ptxas.log")


def ptxas_entries(library: Path, names) -> list:
    """(kernel, registers a thread, bytes of spill stores) of every entry
    function whose symbol contains one of `names`, from the ptxas report
    of the build of `library`."""
    rows, entry, spill = [], None, 0
    for line in ptxas_log(library).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            if any(n in entry for n in names):
                rows.append((entry, int(m.group(1)), spill))
            entry = None
    return rows


def kernels(verbose: bool = False) -> KernelLibrary:
    """The process-wide kernel library, built and loaded on first call."""
    global _library
    with _lock:
        if _library is None:
            t0 = time.perf_counter()
            path = build(verbose=verbose)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vtt_error_string.argtypes = [ctypes.c_int]
            lib.vtt_error_string.restype = ctypes.c_char_p
            _library = KernelLibrary(lib, path, time.perf_counter() - t0)
        return _library


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
