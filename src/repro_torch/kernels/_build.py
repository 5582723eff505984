"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``kernels/csrc/`` compiles, at first use, into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) for ``sm_90a``.  Libraries land in ``build/repro_torch_kernels``
at the repository root, named by a hash of the sources, so an edited source
is rebuilt and an unchanged one is reused.  :func:`build` starts one nvcc per
source, all at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("emt_bitserial", "emt_matmul", "paged_attention",
           "paged_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}


@dataclasses.dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float          # 0.0 when an up-to-date library was reused
    log: str                # nvcc/ptxas output (registers, smem, spills)


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source not yet built, one nvcc each, all started
    together.  Returns {name: BuildInfo}; raises with nvcc's output if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            BUILD_LOG.setdefault(name, BuildInfo(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = BuildInfo(name, out, secs, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def stream(index: int) -> int:
    """PyTorch's current CUDA stream on device `index`, as the raw handle a
    launcher takes (the call PyTorch's own generated launchers make;
    ``torch.cuda.current_stream().cuda_stream`` builds a Stream object
    first, which costs the wrappers more host time than the rest of their
    argument handling)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")
